"""internvl2-26b [arXiv:2404.16821]: InternViT stub + InternLM2-20B backbone.
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553; 256 ViT patch tokens
(frontend_dim=3200) prepended — backbone sequence = 256 + text = seq_len."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "internvl2-26b"
N_PATCHES = 256
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="vlm",
    n_layer=48, d_model=6144, n_head=48, n_kv_head=8, d_ff=16384,
    vocab=92553, frontend_dim=3200, n_frontend_tokens=N_PATCHES, fsdp=True,
)
