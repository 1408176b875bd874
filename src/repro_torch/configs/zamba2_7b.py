"""zamba2-7b [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks.
81L d_model=3584 32H (kv=32, MHA) d_ff=14336 vocab=32000, ssm_state=64."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "zamba2-7b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="hybrid",
    n_layer=81, d_model=3584, n_head=32, n_kv_head=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, fsdp=True,
)
