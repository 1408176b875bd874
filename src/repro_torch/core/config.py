"""AlphaFold2 model configuration (paper Table 1 shapes + AF2 suppl. dims).

A copy of ``repro/core/config.py`` — the same dataclasses, fields, defaults
and presets — so the port imports nothing of the JAX package.  In the port,
``attention_impl="evo_pallas"`` and ``tri_mult_impl="pallas"`` name its
hand-written CUDA kernels (plain torch on CPU tensors), ``"reference"`` the
plain torch path; :func:`with_kernels` selects the kernels for serving.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EvoformerConfig:
    c_m: int = 256              # MSA channels
    c_z: int = 128              # pair channels
    n_head_msa: int = 8
    n_head_pair: int = 4
    c_hidden_att: int = 32      # per-head channel, MSA attention
    c_hidden_pair_att: int = 32
    c_hidden_opm: int = 32      # outer-product-mean inner channel
    c_hidden_mul: int = 128     # triangle multiplication hidden
    transition_factor: int = 4
    dropout_msa: float = 0.15
    dropout_pair: float = 0.25
    # 'af2' (serial, Fig 1a) | 'multimer' (OPM first, 1b) | 'parallel' (OPM last, 1c)
    variant: str = "parallel"
    global_column_attn: bool = False  # extra-MSA stack uses global column attn
    # 'reference' | 'chunked' | 'pallas' | 'evo_pallas' (fused Pallas gated
    # bias attention: QKV+bias+sigmoid-gate in one kernel, flash backward)
    attention_impl: str = "chunked"
    attention_chunk: int = 256
    # 'fused' (row-chunked contraction against the output projection; the
    # (r, r, c_opm^2) outer-product tensor is never materialized) | 'naive'
    opm_impl: str = "fused"
    opm_chunk: int = 32               # residue rows per fused-OPM chunk
    # triangle multiplicative update (Algorithms 11/12):
    # 'reference' (naive XLA, fp32-accumulating oracle) | 'chunked' (i/k-
    # chunked online accumulation + per-slab epilogue: no (r, r, 2·c_mul)
    # gated-projection pair, any backend) | 'pallas' (fully fused kernel,
    # interpret on CPU / Mosaic on TPU)
    tri_mult_impl: str = "chunked"
    tri_mult_chunk: int = 64          # i/k slab extent of the chunked impl


@dataclasses.dataclass(frozen=True)
class StructureConfig:
    c_s: int = 384
    c_z: int = 128
    n_layer: int = 8            # shared-weight IPA iterations
    n_head: int = 12
    c_hidden: int = 16          # per-head scalar channel
    n_qk_points: int = 4
    n_v_points: int = 8


@dataclasses.dataclass(frozen=True)
class AlphaFold2Config:
    """Full model. Defaults = AF2 model-1 'initial training' (paper Table 1)."""
    n_evoformer: int = 48
    n_extra_msa_blocks: int = 4
    evoformer: EvoformerConfig = EvoformerConfig()
    extra: EvoformerConfig = EvoformerConfig(
        c_m=64, c_hidden_att=8, global_column_attn=True)
    structure: StructureConfig = StructureConfig()
    # feature dims
    msa_feat_dim: int = 49
    target_feat_dim: int = 22
    max_relative_idx: int = 32
    n_aatype: int = 23          # masked-MSA classes (20 aa + X + gap + mask)
    n_distogram_bins: int = 64
    n_plddt_bins: int = 50
    # shapes (paper Table 1): initial training
    n_res: int = 256
    n_seq: int = 128            # clustered MSA rows
    n_extra_seq: int = 1024
    n_templ: int = 4            # template stack not modeled (see DESIGN.md)
    max_recycle: int = 4
    scan_blocks: bool = True    # lax.scan over Evoformer blocks
    remat: str = "block"        # 'none' | 'block' | 'dots'

    @property
    def c_m(self) -> int:
        return self.evoformer.c_m

    @property
    def c_z(self) -> int:
        return self.evoformer.c_z


def af2_initial(variant: str = "parallel", attention_impl: str = "chunked",
                **kw) -> AlphaFold2Config:
    ev = EvoformerConfig(variant=variant, attention_impl=attention_impl)
    ex = EvoformerConfig(c_m=64, c_hidden_att=8, global_column_attn=True,
                         variant=variant, attention_impl=attention_impl)
    return AlphaFold2Config(evoformer=ev, extra=ex, n_res=256, n_seq=128,
                            n_extra_seq=1024, **kw)


def af2_finetune(variant: str = "parallel", attention_impl: str = "chunked",
                 **kw) -> AlphaFold2Config:
    ev = EvoformerConfig(variant=variant, attention_impl=attention_impl)
    ex = EvoformerConfig(c_m=64, c_hidden_att=8, global_column_attn=True,
                         variant=variant, attention_impl=attention_impl)
    return AlphaFold2Config(evoformer=ev, extra=ex, n_res=384, n_seq=512,
                            n_extra_seq=5120, **kw)


def af2_small(variant: str = "parallel", attention_impl: str = "chunked",
              **kw) -> AlphaFold2Config:
    """~20M-param model (measured: see tests/test_plan.py): half the channel
    widths and 2/3 the depth of model-1, full initial-training data shapes —
    big enough that BP/DAP layouts behave like the paper's, small enough to
    fine-tune on one host."""
    ev = EvoformerConfig(c_m=128, c_z=64, c_hidden_att=16,
                         c_hidden_pair_att=16, c_hidden_opm=16,
                         c_hidden_mul=64, variant=variant,
                         attention_impl=attention_impl)
    ex = EvoformerConfig(c_m=32, c_z=64, c_hidden_att=8, c_hidden_opm=16,
                         c_hidden_mul=64, global_column_attn=True,
                         variant=variant, attention_impl=attention_impl)
    st = StructureConfig(c_s=256, c_z=64, n_layer=6, n_head=8, c_hidden=16)
    defaults = dict(n_evoformer=40, n_extra_msa_blocks=4, evoformer=ev,
                    extra=ex, structure=st, n_res=256, n_seq=128,
                    n_extra_seq=1024)
    defaults.update(kw)
    return AlphaFold2Config(**defaults)


def af2_tiny(variant: str = "parallel", attention_impl: str = "chunked",
             **kw) -> AlphaFold2Config:
    """CPU-sized config for tests/examples."""
    ev = EvoformerConfig(c_m=32, c_z=16, n_head_msa=2, n_head_pair=2,
                         c_hidden_att=8, c_hidden_pair_att=8, c_hidden_opm=8,
                         c_hidden_mul=16, variant=variant,
                         attention_impl=attention_impl, attention_chunk=8)
    ex = EvoformerConfig(c_m=16, c_z=16, n_head_msa=2, n_head_pair=2,
                         c_hidden_att=4, c_hidden_pair_att=8, c_hidden_opm=8,
                         c_hidden_mul=16, global_column_attn=True, variant=variant,
                         attention_impl=attention_impl, attention_chunk=8)
    st = StructureConfig(c_s=32, c_z=16, n_layer=2, n_head=2, c_hidden=8,
                         n_qk_points=2, n_v_points=3)
    defaults = dict(n_evoformer=2, n_extra_msa_blocks=1, evoformer=ev, extra=ex,
                    structure=st, n_res=16, n_seq=8, n_extra_seq=12)
    defaults.update(kw)
    return AlphaFold2Config(**defaults)


def with_kernels(cfg: AlphaFold2Config) -> AlphaFold2Config:
    """``cfg`` with every attention and triangle update on the kernels:
    ``attention_impl="evo_pallas"``, ``tri_mult_impl="pallas"`` in both
    stacks (the serving path of the port)."""
    kw = dict(attention_impl="evo_pallas", tri_mult_impl="pallas")
    return dataclasses.replace(
        cfg, evoformer=dataclasses.replace(cfg.evoformer, **kw),
        extra=dataclasses.replace(cfg.extra, **kw))


PRESETS = {"tiny": af2_tiny, "small": af2_small, "initial": af2_initial,
           "finetune": af2_finetune}
