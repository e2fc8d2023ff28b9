"""The port's cells and dry run against the JAX package's.

The counterpart of ``tests/test_cells_and_shapes.py`` (the shape
registry, the 40-point grid and its ``long_500k`` gating, ``make_run``,
``decode_state_struct``, the production meshes) and of
``test_dryrun_machinery_small_mesh`` (``tests/test_multidevice.py``):

* the specs: ``batch_pspec`` and ``cache_pspec`` equal the JAX package's
  cases; on the 16×16 and 2×16×16 production meshes every parameter
  leaf of every arch (``make_param_shardings(fsdp=True)``) and every
  leaf of ``decode_state_struct`` at ``decode_32k`` and, where it runs,
  ``long_500k`` (``make_cache_shardings``) has on rank 0 the shape
  ``NamedSharding(mesh, spec).shard_shape(whole)`` gives — except the
  leaves :data:`PARAM_WHOLE_OVER_MODEL` and :data:`CACHE_WHOLE_OVER_MODEL`
  name, which the port holds whole over ``'model'`` where the JAX
  package cuts them (and which hold exactly that shape);
* the dry run: ``build_cell`` + ``trace_cell`` at full size on a fake
  ``(pod 2, data 2, model 2)`` mesh for Granite-MoE × ``train_4k`` and
  xLSTM × ``decode_32k`` (FLOPs, collectives, no kernel built), and the
  FLOPs of Qwen3-32B × ``decode_32k`` on the 16×16 mesh held to the
  count of its matmuls;
* the dense kernel's operator on fake CUDA tensors (``FakeTensorMode``:
  shape, dtype, FLOPs, no build) and on meta tensors; on real CPU
  tensors it still runs the plain version.
"""

import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.compat import make_abstract_mesh
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import shape_applicable as j_applicable
from repro.configs.base import RunConfig as JRun
from repro.models import build_model as jax_build
from repro.runtime import partitioning as JPT
from repro_torch.configs import (ARCHS, SHAPES, RunConfig, get_arch,
                                 shape_applicable)
from repro_torch.core.policies import EXACT, SoftmaxPolicy
from repro_torch.kernels import build
from repro_torch.kernels.lut_attention import lut_attention as LA
from repro_torch.kernels.lut_attention import ops as OPS
from repro_torch.kernels.lut_attention import ref as REF
from repro_torch.launch import cells as C
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.runtime import partitioning as PT

torch.set_num_threads(1)

_ATTN = {"mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo"}
_NORMS = {"norm1/scale", "norm2/scale"}
#: parameter leaves (the last two parts of their paths) the port holds
#: whole over 'model' where the JAX package's rules cut them: stacked
#: per-period vectors (norm scales, biases), which its fallback rule cuts
#: as matrices; attention projections whose KV heads do not divide
#: 'model' 16 (the port cuts attention by whole heads only); the
#: recurrent mixers' weights (the port computes Mamba, mLSTM and sLSTM
#: whole on every rank)
PARAM_WHOLE_OVER_MODEL = {
    "chameleon-34b": _ATTN | _NORMS | {"q_norm/scale", "k_norm/scale"},
    "codeqwen1.5-7b": _NORMS | {"mixer/bo"},
    "deepseek-moe-16b": _NORMS,
    "granite-moe-3b-a800m": _ATTN | _NORMS,
    "internlm2-20b": _ATTN | _NORMS,
    "jamba-v0.1-52b": _ATTN | _NORMS | {
        "mixer/a_log", "mixer/conv_b", "mixer/conv_w", "mixer/d_skip",
        "mixer/dt_bias", "mixer/dt_proj", "mixer/in_proj",
        "mixer/out_proj", "mixer/x_proj"},
    "mistral-large-123b": _ATTN | _NORMS,
    "qwen3-32b": _ATTN | _NORMS | {"q_norm/scale", "k_norm/scale"},
    "whisper-small": {f"{a}/{w}" for a in ("self_attn", "cross_attn")
                      for w in ("wq", "wk", "wv", "wo")},
    "xlstm-125m": {"mixer/down_proj", "mixer/fgate_bias", "mixer/out_proj",
                   "mixer/up_proj", "mixer/w_in", "mixer/wq", "mixer/wk",
                   "mixer/wv", "norm1/scale"},
}
#: serving-state leaves the port holds whole over 'model': Jamba's Mamba
#: state ``h`` (B, 8192, 16), whose channels the JAX package cuts
CACHE_WHOLE_OVER_MODEL = {("jamba-v0.1-52b", "h")}

MESH_SHAPES = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _leave_the_fake_group():
    """The fake meshes' process group goes with this module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The registry, the grid, make_run, the state struct, the meshes
# ---------------------------------------------------------------------------


def test_shape_registry_is_the_jax_packages():
    assert SHAPES["train_4k"].kind == "train"
    assert SHAPES["prefill_32k"].seq_len == 32_768
    assert SHAPES["decode_32k"].global_batch == 128
    assert SHAPES["long_500k"].seq_len == 524_288
    assert SHAPES["long_500k"].global_batch == 1
    for name, shape in SHAPES.items():
        j = JSHAPES[name]
        assert (shape.kind, shape.seq_len, shape.global_batch) == (
            j.kind, j.seq_len, j.global_batch)


def test_cell_grid_is_40_with_32_runnable():
    cells = [(a, s) for a in ARCHS for s in SHAPES]
    assert len(cells) == 40
    runnable = [c for c in cells
                if shape_applicable(ARCHS[c[0]], SHAPES[c[1]])[0]]
    assert len(runnable) == 32
    skipped = {c[0] for c in cells if c not in runnable}
    assert skipped == {a for a in ARCHS if not ARCHS[a].sub_quadratic}
    for a, s in cells:
        assert shape_applicable(ARCHS[a], SHAPES[s]) == j_applicable(
            JARCHS[a], JSHAPES[s])


def test_long_context_gating():
    ok, _ = shape_applicable(ARCHS["jamba-v0.1-52b"], SHAPES["long_500k"])
    assert ok
    ok, reason = shape_applicable(ARCHS["mistral-large-123b"],
                                  SHAPES["long_500k"])
    assert not ok and "sub-quadratic" in reason


def test_make_run_probe_vs_real_and_the_backend_mapping():
    """Training is exact on the naive attention with 4 microbatches and
    remat; probes take one microbatch; serving takes the paper's REXP
    uint8 on the JAX package's ``blocked`` backend, which is the port's
    ``auto`` (the dense CUDA kernel on the card)."""
    arch = get_arch("qwen3-32b")
    real = C.make_run(arch, SHAPES["train_4k"])
    probe = C.make_run(arch, SHAPES["train_4k"], probe=True)
    assert real.microbatch == 4 and probe.microbatch == 1
    assert real.remat and real.softmax_policy is EXACT
    assert real.attention_backend == probe.attention_backend == "naive"
    serve = C.make_run(arch, SHAPES["prefill_32k"])
    assert serve.softmax_policy == SoftmaxPolicy(impl="rexp",
                                                 precision="uint8")
    assert serve.attention_backend == C.BACKENDS["blocked"] == "auto"
    assert not serve.remat and serve.microbatch == 1
    assert C.make_run(arch, SHAPES["prefill_32k"],
                      probe=True).attention_backend == "naive"
    long = C.make_run(get_arch("jamba-v0.1-52b"), SHAPES["long_500k"])
    assert long.shard_kv_seq and not serve.shard_kv_seq
    over = C.make_run(arch, SHAPES["decode_32k"], probe=True,
                      overrides={"attention_backend": "auto"})
    assert over.attention_backend == "auto"


def test_decode_state_struct_on_the_meta_device():
    run = RunConfig(dtype="bfloat16")
    st = build_model(get_arch("qwen3-32b")).decode_state_struct(
        128, 32768, run)
    leaves = []
    PT.map_cache(st, lambda x, n, r: leaves.append(x) or x)
    assert leaves and all(x.is_meta for x in leaves)
    kv = sum(x.numel() * x.element_size() for x in leaves if x.dim() == 4)
    # 64 layers × K and V × 8 KV heads × 32768 × 128 × 2 B × 128 rows:
    # the JAX package's test's formula, 2^40 bytes (its comment's "2 TiB"
    # miscounts it: the product is 1 TiB)
    assert abs(kv - 2 * 64 * 8 * 32768 * 128 * 2 * 128) / kv < .01
    assert kv == 2**40
    caches, cross = build_model(get_arch("whisper-small")).decode_state_struct(
        4, 64, run)
    assert len(caches) == 12 and len(cross) == 12
    assert tuple(cross[0][0].shape) == (4, 12, 1500, 64)


def test_mesh_factories():
    m1 = make_production_mesh()
    assert m1.world == 256 and m1.axis_names == ("data", "model")
    assert m1.shape == {"data": 16, "model": 16}
    m2 = make_production_mesh(multi_pod=True)
    assert m2.world == 512 and m2.axis_names == ("pod", "data", "model")
    assert m2.shape == {"pod": 2, "data": 16, "model": 16}
    m3 = make_production_mesh(multi_pod=True, rank=511)
    assert (m3.pod_rank, m3.data_rank, m3.rank, m3.world_rank) == (
        1, 15, 15, 511)
    # the meshes of PRs 20–24 keep their axes
    assert make_fake_mesh(2, 2).axis_names == ("data", "model")
    with pytest.raises(ValueError, match="fake"):
        from repro_torch.launch.mesh import make_host_mesh
        make_host_mesh(2, 2, backend="fake", device="cpu")


# ---------------------------------------------------------------------------
# Specs against the JAX package's
# ---------------------------------------------------------------------------


def _jp(spec):
    return P(*spec)


def test_batch_and_cache_pspec_are_the_jax_packages():
    mesh = make_production_mesh(multi_pod=True)
    jmesh = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert PT.batch_pspec(mesh, 256) == (("pod", "data"),)
    assert PT.batch_pspec(mesh, 16) == ("data",)
    assert PT.batch_pspec(mesh, 1) == ()
    assert PT.cache_pspec(mesh, 128, 16) == (("pod", "data"), "model", None,
                                            None)
    assert PT.cache_pspec(mesh, 128, 8) == (("pod", "data"), None,
                                           ("model",), None)
    assert PT.cache_pspec(mesh, 1, 8, shard_kv_seq=True) == (
        None, None, ("model", "data"), None)
    for b in (1, 2, 16, 32, 128, 256):
        assert _jp(PT.batch_pspec(mesh, b)) == JPT.batch_pspec(jmesh, b)
        for kvh in (8, 16, 32):
            for seq in (False, True):
                assert _jp(PT.cache_pspec(mesh, b, kvh, seq)) == \
                    JPT.cache_pspec(jmesh, b, kvh, seq), (b, kvh, seq)
    one = make_production_mesh()
    assert PT.batch_pspec(one, 128) == ("data",)
    assert PT.row_range(mesh, 256) == (0, 8)
    assert PT.row_range(make_production_mesh(multi_pod=True, rank=511),
                        256) == (248, 256)


def _jleaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JPT.path_str(p): x for p, x in flat}


def _suffix(path):
    return "/".join(path.split("/")[-2:])


def _model_dropped(spec):
    return tuple(None if e == "model" else
                 (tuple(a for a in e if a != "model") or None
                  if isinstance(e, tuple) else e) for e in spec)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
def test_every_leaf_is_cut_as_the_jax_package_cuts_it(multi_pod):
    shape, axes = MESH_SHAPES[multi_pod]
    jmesh = make_abstract_mesh(shape, axes)
    mesh = make_production_mesh(multi_pod=multi_pod)
    param_diffs, cache_diffs = set(), set()
    for name in sorted(ARCHS):
        jmodel, model = jax_build(JARCHS[name]), build_model(ARCHS[name])
        jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        jsh = _jleaves(JPT.make_param_shardings(jparams, jmesh, fsdp=True))
        layout = PT.Layout(ARCHS[name], mesh)
        for path, leaf in _jleaves(jparams).items():
            whole = tuple(leaf.shape)
            want = tuple(jsh[path].shard_shape(whole))
            got = PT.local_shape(whole, layout.specs[path], mesh)
            if got != want:
                param_diffs.add((name, _suffix(path)))
                kept = NamedSharding(jmesh, P(*_model_dropped(
                    jsh[path].spec))).shard_shape(whole)
                assert got == tuple(kept), (name, path, got, kept)
        for shape_name in ("decode_32k", "long_500k"):
            if not shape_applicable(ARCHS[name], SHAPES[shape_name])[0]:
                continue
            b, s = (SHAPES[shape_name].global_batch,
                    SHAPES[shape_name].seq_len)
            seq = shape_name == "long_500k"
            jstate = jmodel.decode_state_struct(
                b, s, JRun(dtype="bfloat16", shard_kv_seq=seq))
            jcs = _jleaves(JPT.make_cache_shardings(
                jstate, jmesh, b, JARCHS[name].n_kv_heads, seq,
                stacked=not jmodel.is_encdec))
            state = model.decode_state_struct(
                b, s, RunConfig(dtype="bfloat16", shard_kv_seq=seq), mesh)
            got = {}
            PT.map_cache(state, lambda x, n, r: got.setdefault(
                n, set()).add(tuple(x.shape)) or x)
            for path, leaf in _jleaves(jstate).items():
                if leaf.ndim == 0 or path.endswith("length"):
                    continue
                want = tuple(jcs[path].shard_shape(leaf.shape))
                whole = NamedSharding(jmesh, P(*_model_dropped(
                    jcs[path].spec))).shard_shape(leaf.shape)
                if not jmodel.is_encdec:       # the JAX package stacks
                    want, whole = want[1:], tuple(whole[1:])
                leaf_name = path.rsplit("/", 1)[-1]
                if want not in got[leaf_name]:
                    cache_diffs.add((name, leaf_name))
                    assert tuple(whole) in got[leaf_name], (name, path)
    listed = {(a, p) for a, ps in PARAM_WHOLE_OVER_MODEL.items() for p in ps}
    assert param_diffs == listed, (param_diffs - listed, listed - param_diffs)
    assert cache_diffs == CACHE_WHOLE_OVER_MODEL


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


@pytest.fixture
def no_build(monkeypatch):
    """Kernels may not build or load."""
    def refuse(*a, **k):
        raise AssertionError("a trace built or loaded a kernel")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("arch,shape", [
    ("granite-moe-3b-a800m", "train_4k"),
    ("xlstm-125m", "decode_32k"),
])
def test_dryrun_machinery_small_mesh(no_build, arch, shape):
    """build_cell → trace_cell at full size on a fake (2, 2, 2) mesh."""
    mesh = make_fake_mesh(2, 2, pod=2)
    cell = C.build_cell(arch, shape, mesh)
    assert all(t.is_meta for t in C._tensors(cell.args))
    tr = C.trace_cell(cell)
    assert tr.flops > 0
    assert tr.peak_bytes >= tr.argument_bytes > 0
    if shape == "train_4k":
        sites = {k.split(":")[0] for k in tr.collectives}
        assert {"fsdp", "moe", "grads"} <= sites, sites
        # the step's rows: 64 a microbatch over pod × data = 4 ranks
        assert PT.row_axes(mesh, 64) == ("pod", "data")


def test_dryrun_record_and_line(no_build):
    rec = run_cell("xlstm-125m", "long_500k", True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 512 and rec["mesh"] == "2x16x16"
    assert rec["memory"]["fits_hbm_80g"]
    assert rec["params"] == ARCHS["xlstm-125m"].param_count()
    skip = run_cell("qwen3-32b", "long_500k", False)
    assert skip["status"] == "skipped" and "sub-quadratic" in skip["reason"]


def test_decode_flops_are_the_matmuls_a_rank_runs(no_build):
    """Qwen3-32B × decode_32k on the 16×16 mesh, rank 0: 8 rows; the
    attention whole (8 KV heads do not divide 16) over the rank's
    2048-position shard of the cache, ``4 · B · H · Lk · Dh`` a layer;
    the MLP's and the head's 'model' sixteenth; ``2 · weights · tokens``
    for the matmuls — within 1 %."""
    cell = C.build_cell("qwen3-32b", "decode_32k", make_production_mesh())
    tr = C.trace_cell(cell)
    a = ARCHS["qwen3-32b"]
    tokens, dh = 128 // 16, a.resolved_head_dim
    attn_w = a.d_model * dh * (2 * a.n_heads + 2 * a.n_kv_heads)
    mlp_w = 3 * a.d_model * a.d_ff // 16
    head_w = a.d_model * a.vocab_size // 16
    weights = a.n_layers * (attn_w + mlp_w) + head_w
    attention = a.n_layers * 4 * tokens * a.n_heads * (32768 // 16) * dh
    want = 2 * weights * tokens + attention
    assert abs(tr.flops - want) / want < 0.01, (tr.flops, want)


# ---------------------------------------------------------------------------
# The dense kernel's operator on fake tensors
# ---------------------------------------------------------------------------

POLICY = SoftmaxPolicy(impl="rexp", precision="uint8")


@pytest.mark.parametrize("lq", [1, 70])
def test_dense_op_on_fake_cuda_tensors(no_build, lq):
    before = dict(LA.lut_attention_cuda.launches)
    with FakeTensorMode():
        q = torch.empty(2, 8, lq, 128, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(2, 2, 300, 128, device="cuda", dtype=torch.bfloat16)
        with FlopCounterMode(display=False) as fc:
            out = OPS.lut_attention(q, k, k, POLICY, causal=True,
                                    kv_len=250)
        assert out.device.type == "cuda" and out.dtype == torch.float32
        assert tuple(out.shape) == (2, 8, lq, 128)
        assert fc.get_total_flops() == LA.dense_flops(q.shape, k.shape) \
            == 4 * 2 * 8 * lq * 300 * 128
    assert LA.lut_attention_cuda.launches == before


def test_dense_op_on_meta_tensors(no_build):
    q = torch.empty(1, 8, 1, 64, device="meta")
    k = torch.empty(1, 8, 40, 64, device="meta")
    with FlopCounterMode(display=False) as fc:
        out = OPS.lut_attention(q, k, k, POLICY, kv_len=30)
    assert out.is_meta and tuple(out.shape) == (1, 8, 1, 64)
    assert fc.get_total_flops() == 4 * 8 * 40 * 64


def test_dense_op_on_cpu_tensors_runs_the_plain_version(no_build):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 3, 16, generator=g)
    k = torch.randn(2, 2, 20, 16, generator=g)
    v = torch.randn(2, 2, 20, 16, generator=g)
    got = OPS.lut_attention(q, k, v, POLICY, causal=True, kv_len=15)
    want = REF.lut_attention_ref(q, k, v, method="rexp",
                                 tables=OPS._tables_for(POLICY), causal=True,
                                 kv_len=15)
    assert torch.equal(got, want)
