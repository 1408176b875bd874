"""mamba2-2.7b [arXiv:2405.21060]: pure SSD, attention-free.
64L d_model=2560, ssm_state=128, head_dim=64, expand=2, vocab=50280."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "mamba2-2.7b"
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="ssm",
    n_layer=64, d_model=2560, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, fsdp=True,
)
