"""Unified architecture config for the 10 LM-family architectures (a copy of
``repro/models/lmconfig.py``; the port imports nothing of the JAX package)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layer: int
    d_model: int
    n_head: int = 0             # 0 for attention-free
    n_kv_head: int = 0
    d_ff: int = 0
    vocab: int = 32000
    d_head: int = 0             # default: d_model // n_head

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attention_impl: str = "chunked"
    attention_chunk: int = 1024
    # PaLM-style parallel residual block: x + attn(ln x) + mlp(ln x).
    # Beyond-paper: makes the dense block two dependency-free branches, so
    # the paper's Branch Parallelism applies to LMs too (DESIGN.md §5).
    parallel_block: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    expert_pad_to: int = 0      # pad expert banks for even EP sharding (60->64)
    # 'einsum' = GShard one-hot dispatch (paper-era baseline, O(T^2 k D / E));
    # 'sorted' = argsort+scatter dispatch, O(T k D) — §Perf hillclimb 1
    moe_dispatch: str = "einsum"
    # uniform-length batch decode: cache writes become one dynamic-update-
    # slice at a scalar index instead of a per-sequence scatter, which GSPMD
    # partitions without resharding the cache — §Perf hillclimb 2
    uniform_decode: bool = False
    # 2-D factored decode mesh (model -> kvh x brep) for narrow GQA —
    # §Perf hillclimb 2, iteration 3; read by the tensor-parallel decode
    # plan, which the port does not have yet
    factored_decode: bool = False

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # hybrid (Zamba2): shared attention block applied every N backbone blocks
    shared_attn_every: int = 0

    # enc-dec (Whisper)
    enc_dec: bool = False
    n_enc_layer: int = 0
    frontend_dim: int = 0       # stub modality feature dim (audio frames / ViT)
    n_frontend_tokens: int = 0  # patches / frames prepended (vlm)

    # compute / distribution
    scan_layers: bool = True
    remat: str = "layer"        # 'none' | 'layer'
    fsdp: bool = False          # shard params+opt over the data axis too
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.n_head and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_head)

    @property
    def d_inner(self) -> int:   # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "LMConfig":
        """Smoke-test-sized variant of the same family."""
        small = dict(
            n_layer=min(self.n_layer, 2),
            d_model=128,
            n_head=4 if self.n_head else 0,
            n_kv_head=min(self.n_kv_head, 2) if self.n_kv_head else 0,
            d_head=32 if self.n_head else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=128,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            shared_d_ff=64 if self.shared_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=8,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_enc_layer=min(self.n_enc_layer, 2),
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            n_frontend_tokens=(min(self.n_frontend_tokens, 8)
                               if self.n_frontend_tokens else 0),
            attention_chunk=64,
            scan_layers=False,
            remat="none",
            fsdp=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def with_kernels(cfg: LMConfig) -> LMConfig:
    """``cfg`` with attention on the kernels (``attention_impl="pallas"``:
    prefill through K6), the serving path of the port."""
    return dataclasses.replace(cfg, attention_impl="pallas")
