"""xLSTM 125M — sLSTM + mLSTM blocks (3:1 per period of 4; the paper's
[7:1] ratio adapted to 12 layers), no separate FFN (d_ff = 0; the blocks
carry their own up/down projections).  Attention-free: the paper's LUT
softmax does not apply here — this arch is the attention-free control.

[arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

_PERIOD = (
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="mlstm", ffn="none"),
    LayerSpec(mixer="slstm", ffn="none"),
)

ARCH = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    period=_PERIOD, rope=False, sub_quadratic=True,
    source="[arXiv:2405.04517; unverified]",
)
