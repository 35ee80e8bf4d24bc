"""falcon-mamba-7b [ssm]: attention-free mamba1, 64L d_model=4096
vocab=65024, ssm_state=16 [arXiv:2410.05355]."""
from ..models.config import ArchConfig, MambaConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    vocab=65024,
    d_model=4096,
    n_layers=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    param_dtype="bfloat16",
)
