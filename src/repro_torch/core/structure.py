"""Structure module: rigid frames, Invariant Point Attention, backbone update
(counterpart of ``repro/core/structure.py``; AF2 suppl. Algorithms 20-23,
CA frames only)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.config import StructureConfig
from repro_torch.core.evoformer import mask_bias
from repro_torch.nn.layers import Dense, LayerNorm, dense, layernorm


# ---------------------------------------------------------------------------
# Rigid-body frames: rotation matrices (..., 3, 3) + translations (..., 3)
# ---------------------------------------------------------------------------

def identity_rigid(shape, device, dtype=torch.float32):
    rots = torch.eye(3, dtype=dtype, device=device).expand(*shape, 3, 3)
    return rots, torch.zeros((*shape, 3), dtype=dtype, device=device)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w, x, y, z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = torch.unbind(q, -1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rigid_apply(rots, trans, points):
    """Map local points (..., 3) to global: R @ p + t (fp32, as JAX promotes)."""
    return torch.einsum("...ij,...j->...i", rots, points.to(rots.dtype)) + trans


def rigid_invert_apply(rots, trans, points):
    """Map global points to local: R^T (p - t)."""
    return torch.einsum("...ji,...j->...i", rots, points - trans)


def rigid_compose(rots_a, trans_a, rots_b, trans_b):
    """(R_a, t_a) ∘ (R_b, t_b): first apply b in a's frame."""
    rots = torch.einsum("...ij,...jk->...ik", rots_a, rots_b)
    return rots, rigid_apply(rots_a, trans_a, trans_b)


# ---------------------------------------------------------------------------
# Invariant Point Attention (Algorithm 22)
# ---------------------------------------------------------------------------

class InvariantPointAttention(nn.Module):
    def __init__(self, cfg: StructureConfig, *, generator: torch.Generator):
        super().__init__()
        g, h, c = generator, cfg.n_head, cfg.c_hidden
        self.q = Dense(cfg.c_s, h * c, use_bias=False, generator=g)
        self.k = Dense(cfg.c_s, h * c, use_bias=False, generator=g)
        self.v = Dense(cfg.c_s, h * c, use_bias=False, generator=g)
        self.q_pts = Dense(cfg.c_s, h * cfg.n_qk_points * 3, generator=g)
        self.k_pts = Dense(cfg.c_s, h * cfg.n_qk_points * 3, generator=g)
        self.v_pts = Dense(cfg.c_s, h * cfg.n_v_points * 3, generator=g)
        self.pair_bias = Dense(cfg.c_z, h, use_bias=False, generator=g)
        self.head_weights = nn.Parameter(torch.zeros((h,)))  # softplus -> gamma
        self.out = Dense(h * (c + cfg.c_z + cfg.n_v_points * 4), cfg.c_s,
                         scale="zeros", generator=g)


def invariant_point_attention(p: InvariantPointAttention, cfg: StructureConfig,
                              s, z, rots, trans, res_mask=None):
    """IPA over one protein: s (r, c_s), z (r, r, c_z), frames (r, 3, 3)/(r, 3).
    The attention-weighted sums accumulate in fp32, as the reference forces."""
    r = s.shape[0]
    h, c, n_qp, n_vp = cfg.n_head, cfg.c_hidden, cfg.n_qk_points, cfg.n_v_points

    q = dense(p.q, s).reshape(r, h, c)
    k = dense(p.k, s).reshape(r, h, c)
    v = dense(p.v, s).reshape(r, h, c)
    q_pts = dense(p.q_pts, s).reshape(r, h * n_qp, 3)
    k_pts = dense(p.k_pts, s).reshape(r, h * n_qp, 3)
    v_pts = dense(p.v_pts, s).reshape(r, h * n_vp, 3)
    # globalize points with each residue's frame
    rr, tt = rots[:, None], trans[:, None]
    q_pts = rigid_apply(rr, tt, q_pts).reshape(r, h, n_qp, 3)
    k_pts = rigid_apply(rr, tt, k_pts).reshape(r, h, n_qp, 3)
    v_pts_g = rigid_apply(rr, tt, v_pts).reshape(r, h, n_vp, 3)

    scalar = torch.einsum("ihc,jhc->hij", q, k).float() * (c ** -0.5)
    pair = torch.movedim(dense(p.pair_bias, z), -1, 0).float()
    d2 = (q_pts[:, None].float() - k_pts[None, :].float()).square().sum(-1)
    gamma = F.softplus(p.head_weights)                              # (h,)
    w_c = (2.0 / (9.0 * n_qp)) ** 0.5
    point = -0.5 * w_c * gamma[None, None] * d2.sum(-1)             # (i, j, h)
    point = torch.movedim(point, -1, 0)
    w_l = (1.0 / 3.0) ** 0.5
    logits = w_l * (scalar + pair + point)
    if res_mask is not None:
        logits = logits + mask_bias(res_mask)[None, None]
    att = torch.softmax(logits, dim=-1)                             # (h, i, j)

    o_scalar = torch.einsum("hij,jhc->ihc", att.to(v.dtype).float(), v.float())
    o_pair = torch.einsum("hij,ijc->ihc", att.to(z.dtype).float(), z.float())
    o_scalar = o_scalar.to(v.dtype).reshape(r, -1)
    o_pair = o_pair.to(z.dtype).reshape(r, -1)
    o_pts_g = torch.einsum("hij,jhpc->ihpc", att.float(), v_pts_g.float())
    o_pts = rigid_invert_apply(rots[:, None, None], trans[:, None, None], o_pts_g)
    o_pts_norm = torch.sqrt(o_pts.square().sum(-1) + 1e-8)          # (i, h, P)
    feats = torch.cat([o_scalar, o_pair, o_pts.reshape(r, -1).to(s.dtype),
                       o_pts_norm.reshape(r, -1).to(s.dtype)], -1)
    return dense(p.out, feats.to(s.dtype))


# ---------------------------------------------------------------------------
# Structure module (Algorithm 20, shared weights across iterations)
# ---------------------------------------------------------------------------

class TransitionMLP(nn.Module):
    def __init__(self, c_s: int, *, generator: torch.Generator):
        super().__init__()
        self.w1 = Dense(c_s, c_s, generator=generator)
        self.w2 = Dense(c_s, c_s, generator=generator)
        self.w3 = Dense(c_s, c_s, scale="zeros", generator=generator)
        self.ln = LayerNorm(c_s)


class StructureModule(nn.Module):
    def __init__(self, cfg: StructureConfig, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.ln_s = LayerNorm(cfg.c_s)
        self.ln_z = LayerNorm(cfg.c_z)
        self.proj_s = Dense(cfg.c_s, cfg.c_s, generator=g)
        self.ipa = InvariantPointAttention(cfg, generator=g)
        self.ln_ipa = LayerNorm(cfg.c_s)
        self.trans_mlp = TransitionMLP(cfg.c_s, generator=g)
        self.backbone_update = Dense(cfg.c_s, 6, scale="zeros", generator=g)


def structure_module(p: StructureModule, cfg: StructureConfig, s_init, z,
                     res_mask=None):
    """Returns final (rots, trans), the per-iteration (rots, trans)
    trajectory, and the final single rep s.  ``res_mask`` (r,) masks IPA
    keys against padded-bucket residues."""
    r = s_init.shape[0]
    s = dense(p.proj_s, layernorm(p.ln_s, s_init))
    z = layernorm(p.ln_z, z)
    rots, trans = identity_rigid((r,), s.device)
    rots_traj, trans_traj = [], []
    mlp = p.trans_mlp
    for _ in range(cfg.n_layer):
        s = s + invariant_point_attention(p.ipa, cfg, s, z, rots, trans,
                                          res_mask)
        s = layernorm(p.ln_ipa, s)
        h = torch.relu(dense(mlp.w1, s))
        h = torch.relu(dense(mlp.w2, h))
        s = layernorm(mlp.ln, s + dense(mlp.w3, h))
        upd = dense(p.backbone_update, s).float()                   # (r, 6)
        bcd, t_upd = upd[:, :3], upd[:, 3:]
        quat = torch.cat([torch.ones((r, 1), device=s.device), bcd], -1)
        quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
        rots, trans = rigid_compose(rots, trans, quat_to_rot(quat), t_upd)
        rots_traj.append(rots)
        trans_traj.append(trans)
        # AF2 stops rotation gradients between iterations
        rots = rots.detach()
    traj = (torch.stack(rots_traj), torch.stack(trans_traj))
    return (rots_traj[-1], trans_traj[-1]), traj, s
