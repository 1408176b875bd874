"""whisper-medium [arXiv:2212.04356]: enc-dec; conv frontend is a STUB
(input_specs provides precomputed frame embeddings, 1500 frames).
24L(+24 enc) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865."""
from repro_torch.models.lmconfig import LMConfig

ARCH_ID = "whisper-medium"
N_FRAMES = 1500   # whisper fixed 30 s encoder context
CONFIG = LMConfig(
    arch_id=ARCH_ID, family="audio",
    n_layer=24, n_enc_layer=24, d_model=1024, n_head=16, n_kv_head=16,
    d_ff=4096, vocab=51865, enc_dec=True,
    frontend_dim=1024, n_frontend_tokens=N_FRAMES, fsdp=True,
)
