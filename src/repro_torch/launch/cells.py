"""Cell builder: (arch × shape × mesh) → one rank's step and its
arguments as tensors of shapes only.

The counterpart of the JAX package's ``launch/cells.py``.  A *cell* is
one benchmark point of the 10 archs × 4 :data:`~repro_torch.configs.
SHAPES` grid.  :func:`build_cell` returns the step a rank runs and its
arguments at the rank's shapes as tensors of shapes only — on the meta
device: no memory, the counterpart of the JAX package's
``ShapeDtypeStruct``s:

  * train   — ``train_loop.make_train_step`` on the mesh (forward,
    backward, AdamW; 4 microbatches);
  * prefill — ``serve_loop.make_prefill_step`` (fills the caches, the
    last position's logits);
  * decode  — ``serve_loop.make_decode_step``: one step against a cache
    of the shape's whole length.

:func:`trace_cell` runs the step once on those tensors with the mesh
active (the counterpart of ``lower_cell``): the collectives run on the
``fake`` backend (``launch/mesh.make_production_mesh``), the kernels'
wrappers take the card's path and give outputs of their shapes from
their fake implementations (``kernels.common.shapes_only``), and it
records the rank's bytes, FLOPs and collectives (:class:`Trace`).

Meta tensors rather than ``FakeTensorMode``'s fake ones: a fake tensor's
dispatch costs about a millisecond in Python, so a Mamba step loop
(about 18 operations a token) traced 32 768 tokens a layer would take
hours; a meta tensor's operations are the C++ meta kernels.  The
kernels' fake implementations serve both (``test_torch_cells.py``
drives the dense kernel's under ``FakeTensorMode`` on fake CUDA
tensors).

``probe`` is the JAX package's roofline configuration: ``probe_periods``
periods, the plain attention, no microbatching.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as flatten_outputs
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeConfig
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.models import build_model
from repro_torch.models.model_zoo import Model
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import partitioning as PT
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill_step
from repro_torch.runtime.train_loop import TrainState, make_train_step

Tensor = torch.Tensor

PAPER_SERVE_POLICY = SoftmaxPolicy(impl="rexp", precision="uint8")

#: the JAX package's attention backends → the port's.  Its serving
#: backend ``"blocked"`` (a flash-style XLA scan, its main serving path)
#: is the port's ``"auto"``: the dense CUDA kernel on the card.  The
#: port's own ``"blocked"`` is a plain-PyTorch port of that scan, kept
#: to test the kernel against, never the main path.  ``"naive"`` (the
#: materialised logits of probes and training) is ``"naive"`` in both.
BACKENDS = {"blocked": "auto", "naive": "naive"}

#: bytes the card holds beside the traced tensors during a step: the
#: cuBLAS and cuBLASLt workspaces, 32 MiB each (PyTorch's defaults on
#: Hopper), allocated through the caching allocator at the first matmul
WORKSPACE_BYTES = 64 * 2**20


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    mesh: PT.Mesh
    run: RunConfig
    model: Model
    fn: Callable            # the rank's step
    args: tuple             # its arguments: meta tensors, the rank's shapes
    out_shardings: Any      # specs of the state it returns
    n_periods: int          # depth actually built (probes reduce this)


def make_run(arch: ArchConfig, shape: ShapeConfig, *, probe: bool = False,
             serve_policy: SoftmaxPolicy = PAPER_SERVE_POLICY,
             microbatch: int | None = None,
             overrides: dict | None = None) -> RunConfig:
    """The JAX package's run of a cell: bf16; the paper's REXP uint8
    softmax for serving and the exact one for training; the naive
    attention for probes and training and the serving backend
    (:data:`BACKENDS`: ``"auto"``) otherwise; remat for training; 4
    microbatches for training, 1 for serving and probes;
    ``shard_kv_seq`` for ``long_500k``.  ``overrides`` replace fields."""
    kind = shape.kind
    kw: dict = dict(
        dtype="bfloat16",
        softmax_policy=EXACT if kind == "train" else serve_policy,
        attention_backend=BACKENDS["naive" if (probe or kind == "train")
                                   else "blocked"],
        remat=kind == "train",
        microbatch=1 if probe else (
            microbatch if microbatch is not None
            else (4 if kind == "train" else 1)),
        shard_kv_seq=shape.name == "long_500k",
    )
    kw.update(overrides or {})
    return RunConfig(**kw)


def _rank_params(model: Model, mesh, dtype: torch.dtype, device,
                 requires_grad: bool = False):
    """The parameter tree at this rank's shapes under the serving and
    training layout (``shard_pspec`` with ``fsdp=True``), as empty
    tensors of ``dtype`` on ``device``."""
    layout = PT.Layout(model.cfg, mesh)
    meta = PT.meta_params(model.cfg)

    def leaf(path, x):
        shape = PT.local_shape(tuple(x.shape), layout.specs[path], mesh)
        return torch.empty(shape, dtype=dtype, device=device,
                           requires_grad=requires_grad)

    return PT._walk(meta, leaf), layout


def build_cell(arch_name: str, shape_name: str, mesh: PT.Mesh, *,
               probe: bool = False, probe_periods: int = 1,
               serve_policy: SoftmaxPolicy = PAPER_SERVE_POLICY,
               run_overrides: dict | None = None) -> Cell:
    """One rank's step of a cell on ``mesh`` (its own view: rank
    ``mesh.world_rank``) and its arguments as tensors on the mesh's
    device — the meta device for a dry run — in bf16 (f32 masters and
    moments for training), at the rank's shapes:

    * train: the state as ``shard_train_state`` cuts it, and the global
      batch — ``tokens (B, S + 1)``, Whisper's ``encoder_input`` — as
      the port's sharded train step takes it (it cuts the rows itself);
    * prefill: the weights and the rank's rows ``tokens (B_r, S)`` (and
      frames);
    * decode: the weights, the rank's rows ``token (B_r, 1)`` and its
      cut of ``Model.decode_state_struct`` at ``S − 1`` cached tokens.
    """
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if probe:
        arch = arch.with_layers(probe_periods)
    run = make_run(arch, shape, probe=probe, serve_policy=serve_policy,
                   overrides=run_overrides)
    model = build_model(arch)
    b, s = shape.global_batch, shape.seq_len
    bf16 = torch.bfloat16
    dev = mesh.device
    cell = dict(arch=arch, shape=shape, mesh=mesh, run=run, model=model,
                n_periods=arch.n_periods)
    lo, hi = PT.row_range(mesh, b)

    def frames(rows):
        return (torch.empty((rows, arch.encoder_seq, arch.d_model),
                            dtype=bf16, device=dev)
                if arch.encoder_layers else None)

    with torch.no_grad():
        if shape.kind == "train":
            params, layout = _rank_params(model, mesh, torch.float32, dev,
                                          requires_grad=True)

            def zeros():
                return PT._walk(params, lambda p, x: torch.empty(
                    x.shape, dtype=x.dtype, device=dev))
            state = TrainState(params=params, opt=AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=dev),
                m=zeros(), v=zeros()), ef=None)
            batch = {"tokens": torch.empty((b, s + 1), dtype=torch.int32,
                                           device=dev)}
            if arch.encoder_layers:
                batch["encoder_input"] = frames(b)
            fn = make_train_step(model, run, mesh=mesh)
            specs = {p: layout.specs[p] for p in layout.specs}
            return Cell(fn=fn, args=(state, batch), out_shardings=specs,
                        **cell)
        params, _ = _rank_params(model, mesh, bf16, dev)
        whole = model.decode_state_struct(b, s, run)
        specs = PT.cache_specs(whole, mesh, b, arch.n_kv_heads,
                               run.shard_kv_seq)
        if shape.kind == "prefill":
            tokens = torch.empty((hi - lo, s), dtype=torch.int32, device=dev)
            fn0 = make_prefill_step(model, run, s, mesh=mesh, batch=b)
            if arch.encoder_layers:
                def fn(params, tokens, encoder_input):
                    return fn0(params, tokens, encoder_input=encoder_input)
                args = (params, tokens, frames(hi - lo))
            else:
                fn, args = fn0, (params, tokens)
            return Cell(fn=fn, args=args, out_shardings=specs, **cell)
        state = PT.map_cache(model.decode_state_struct(b, s, run, mesh),
                             lambda x, n, r: torch.empty(
                                 x.shape, dtype=x.dtype, device=dev))
        state = _at_length(state, s - 1)
        token = torch.empty((hi - lo, 1), dtype=torch.int32, device=dev)
        fn = make_decode_step(model, run, mesh=mesh, batch=b)
        return Cell(fn=fn, args=(params, token, state), out_shardings=specs,
                    **cell)


def _at_length(state, n: int):
    """``state`` with every attention cache holding ``n`` tokens."""
    if hasattr(state, "length"):
        state.length = n
    elif isinstance(state, (list, tuple)):
        for x in state:
            _at_length(x, n)
    return state


@dataclasses.dataclass
class Trace:
    """What :func:`trace_cell` recorded of one rank's step: the bytes of
    its arguments (parameters and state), of the new tensors it returns,
    the peak of live bytes during the step (arguments included; each
    tensor rounded up to the caching allocator's 512-byte blocks) and
    ``live_bytes`` = peak + :data:`WORKSPACE_BYTES`; the FLOPs
    (``FlopCounterMode``: matmuls, convolutions, the dense kernel's
    :func:`~repro_torch.kernels.lut_attention.lut_attention.dense_flops`);
    the collectives by site and kind (count, bytes); the seconds the
    trace took."""

    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    live_bytes: int
    flops: int
    collectives: dict
    seconds: float


def _tensors(tree) -> list[Tensor]:
    """The tensor leaves of a tree of dicts, lists, tuples and
    dataclasses."""
    out = []

    def walk(x):
        if isinstance(x, Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def _nbytes(ts) -> int:
    """Bytes of the distinct storages of ``ts``."""
    seen, total = set(), 0
    for t in ts:
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


class LiveBytes(TorchDispatchMode):
    """The bytes of live tensor storage while it is active: each storage
    an operation returns counts, rounded up to the caching allocator's
    512-byte blocks, from its first appearance until it is freed;
    :meth:`track` counts one that exists already (an argument).
    ``peak`` is the most that was live at once.  The count of
    ``torch.distributed._tools.mem_tracker.MemTracker`` without its
    module and category bookkeeping, which costs it ~12 % more time a
    traced operation (the recurrent cells' traces run for hours)."""

    BLOCK = 512

    def __init__(self):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self.current = self.peak = 0

    def _free(self, n: int) -> None:
        self.current -= n

    def track(self, t: Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // self.BLOCK) * self.BLOCK
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in flatten_outputs(out)[0]:
            if isinstance(t, Tensor):
                self.track(t)
        return out


def trace_cell(cell: Cell) -> Trace:
    """Run ``cell.fn`` once on its arguments (meta tensors) with the mesh
    active and record :class:`Trace`.  Nothing is allocated on a device
    and no kernel is built or launched."""
    args = _tensors(cell.args)
    cell.mesh.log.clear()
    live = LiveBytes()
    for t in args:
        live.track(t)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, live:
        out = cell.fn(*cell.args)
    arg_ids = {id(t.untyped_storage()) for t in args}
    new = [t for t in _tensors(out) if id(t.untyped_storage()) not in arg_ids]
    coll: dict = {}
    for r in cell.mesh.log.records:
        site = coll.setdefault(f"{r.site}:{r.kind}", {"count": 0, "bytes": 0})
        site["count"] += 1
        site["bytes"] += r.nbytes
    return Trace(argument_bytes=_nbytes(args), output_bytes=_nbytes(new),
                 peak_bytes=live.peak, live_bytes=live.peak + WORKSPACE_BYTES,
                 flops=int(fc.get_total_flops()), collectives=coll,
                 seconds=time.perf_counter() - t0)
