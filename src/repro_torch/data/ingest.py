"""Record ingest for training: parsers, records, sources and featurization
(counterpart of ``repro/data/ingest.py``, numpy only, as the reference's).

* ``parse_fasta`` / ``parse_mmcif_lite``: record parsers (the mmCIF-lite
  dialect is the ``_atom_site`` loop subset that carries a CA trace).
* ``ProteinRecord``: one protein (sequence, aligned MSA rows, optional CA
  coordinates); without coordinates a deterministic synthetic chain seeded by
  the sequence digest stands in.
* ``SyntheticSource`` and ``FastaSource``: ``__len__`` + ``record(idx)`` +
  ``record_length(idx)``, so the pipeline's schedule does not depend on the
  source; ``demo_fasta`` makes mixed-length FASTA text.
* ``featurize_record``: a record -> the training feature dict (the keys and
  dtypes of ``data.protein.protein_sample``) at the record's own residue
  extent, padded later by ``data.bucketing``.  Deterministic in (record,
  seed, step, idx): the masked-MSA positions come from
  ``default_rng([seed, step, idx])``, so a resumed or reordered run and any
  worker count give the same stream.

Every array equals the reference's byte for byte (same keys, dtypes and
values); ``tests/test_torch_data_pipeline.py`` holds it to that.  The
pipeline's worker threads run this module: it touches no torch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

import numpy as np

# 20 amino acids in the AF2 ordering, then X (unknown) at 20, gap at 21,
# mask token at n_aatype - 1 = 22 (config.py: "20 aa + X + gap + mask")
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
AA_TO_ID = {a: i for i, a in enumerate(AA_ORDER)}
UNK_ID = 20
GAP_ID = 21

THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}


def aa_ids(seq: str) -> np.ndarray:
    """Sequence string -> int ids ('-'/'.' = gap, unknown letters = X)."""
    return np.array([GAP_ID if c in "-." else AA_TO_ID.get(c.upper(), UNK_ID)
                     for c in seq], np.int32)


def parse_fasta(text: str) -> List[tuple]:
    """FASTA text -> [(header, sequence)] (whitespace-tolerant)."""
    records, header, chunks = [], None, []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if header is not None:
                records.append((header, "".join(chunks)))
            header, chunks = line[1:].strip(), []
        elif header is None:
            raise ValueError(
                "FASTA must start with a '>' header line; got data first")
        else:
            chunks.append(line.replace(" ", ""))
    if header is not None:
        records.append((header, "".join(chunks)))
    return records


def parse_mmcif_lite(text: str) -> tuple:
    """mmCIF ``_atom_site`` CA trace -> (sequence, coords (r, 3) float32).

    Reads the first ``loop_`` whose tags start with ``_atom_site.`` and
    keeps one CA atom per residue (first altloc wins).  This is NOT a full
    CIF parser — quoted multi-word fields inside the atom table are not
    expected for the columns used — but it reads real PDBx files' ATOM
    records, which is all the ingest path needs.
    """
    lines = text.splitlines()
    tags: List[str] = []
    rows: List[List[str]] = []
    in_loop = in_atom = False
    for line in lines:
        s = line.strip()
        if s == "loop_":
            in_loop, in_atom, tags = True, False, []
            continue
        if in_loop and s.startswith("_"):
            tags.append(s.split()[0])
            in_atom = tags[0].startswith("_atom_site.")
            continue
        if in_loop and in_atom and s and not s.startswith(("#", "_")):
            rows.append(s.split())
            continue
        if in_loop and (s.startswith("#") or s.startswith("loop_") or not s):
            if in_atom and rows:
                break
            in_loop = in_atom = False
    if not rows:
        raise ValueError("no _atom_site loop with rows found (mmCIF-lite "
                         "needs the ATOM table with CA records)")
    col = {t.split(".", 1)[1]: i for i, t in enumerate(tags)}
    for need in ("label_atom_id", "label_comp_id", "label_seq_id",
                 "Cartn_x", "Cartn_y", "Cartn_z"):
        if need not in col:
            raise ValueError(f"mmCIF _atom_site loop lacks .{need}")
    seq, coords, seen = [], [], set()
    for r in rows:
        if len(r) < len(tags):
            continue
        if r[col["label_atom_id"]].strip('"') != "CA":
            continue
        if "group_PDB" in col and r[col["group_PDB"]] != "ATOM":
            continue
        sid = r[col["label_seq_id"]]
        if sid in seen:
            continue
        seen.add(sid)
        seq.append(THREE_TO_ONE.get(r[col["label_comp_id"]].upper(), "X"))
        coords.append([float(r[col["Cartn_x"]]), float(r[col["Cartn_y"]]),
                       float(r[col["Cartn_z"]])])
    if not seq:
        raise ValueError("mmCIF _atom_site loop carries no CA ATOM records")
    return "".join(seq), np.asarray(coords, np.float32)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProteinRecord:
    """One ingest record: query sequence, aligned MSA rows, optional CA
    trace.  ``msa`` rows are same-length aligned strings including the
    query as row 0; ``coords`` is (len(seq), 3) float32 or None (a
    deterministic synthetic chain is substituted at featurize time)."""
    name: str
    seq: str
    msa: List[str] = dataclasses.field(default_factory=list)
    coords: Optional[np.ndarray] = None

    @property
    def n_res(self) -> int:
        return len(self.seq)

    def digest_int(self) -> int:
        h = hashlib.sha256(self.seq.encode()).digest()
        return int.from_bytes(h[:8], "big")


def _smooth_chain(rng: np.random.Generator, n_res: int) -> np.ndarray:
    """Numpy port of ``data.protein._chain_coords``: unit steps, smoothed,
    3.8 A CA-CA spacing (same stand-in physics, host-side)."""
    steps = rng.normal(size=(n_res, 3))
    kernel = np.ones(5) / 5.0
    steps = np.stack([np.convolve(steps[:, i], kernel, mode="same")
                      for i in range(3)], -1)
    steps = steps / (np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-6)
    return np.cumsum(3.8 * steps, axis=0).astype(np.float32)


def frames_from_coords_np(x: np.ndarray) -> tuple:
    """Numpy port of ``data.protein._frames_from_coords`` (Gram-Schmidt
    frames from consecutive CA displacements, fixed-reference fallback
    where the chain is locally straight)."""
    x = np.asarray(x, np.float32)
    nxt = np.concatenate([x[1:], x[-1:] + (x[-1:] - x[-2:-1])], 0)
    prv = np.concatenate([x[:1] - (x[1:2] - x[:1]), x[:-1]], 0)
    e1 = nxt - x
    e1 = e1 / (np.linalg.norm(e1, axis=-1, keepdims=True) + 1e-6)
    v2 = x - prv
    e2 = v2 - np.sum(v2 * e1, -1, keepdims=True) * e1
    n2 = np.linalg.norm(e2, axis=-1, keepdims=True)
    ref = np.where(np.abs(e1[..., :1]) < 0.9,
                   np.array([1.0, 0.0, 0.0], np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))
    alt = ref - np.sum(ref * e1, -1, keepdims=True) * e1
    alt = alt / (np.linalg.norm(alt, axis=-1, keepdims=True) + 1e-9)
    e2 = np.where(n2 > 1e-3, e2 / (n2 + 1e-9), alt)
    e3 = np.cross(e1, e2)
    rots = np.stack([e1, e2, e3], axis=-1).astype(np.float32)
    return rots, x


def synthesize_msa(seq: str, depth: int, rng: np.random.Generator,
                   mutation_rate: float = 0.15,
                   gap_rate: float = 0.05) -> List[str]:
    """Deterministic MSA stand-in: query row + mutated/gapped homologs.

    Real pipelines run jackhmmer/hhblits here; until alignments are wired
    in, homolog rows are the query with per-position substitutions (rate
    ``mutation_rate``) and gaps (``gap_rate``), seeded by the caller —
    enough signal for the masked-MSA head to be non-degenerate.
    """
    rows = [seq]
    ids = aa_ids(seq)
    for _ in range(max(0, depth - 1)):
        mut = rng.random(len(seq)) < mutation_rate
        gap = rng.random(len(seq)) < gap_rate
        subs = rng.integers(0, 20, len(seq))
        row_ids = np.where(mut, subs, np.minimum(ids, UNK_ID))
        chars = [("-" if g else (AA_ORDER[i] if i < 20 else "X"))
                 for i, g in zip(row_ids, gap)]
        rows.append("".join(chars))
    return rows


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

class SyntheticSource:
    """The existing deterministic synthetic stream behind the Source
    interface.  ``record(idx)`` synthesizes sequence/MSA/coords from
    ``default_rng([seed, idx])``; ``vary_length=True`` draws each record's
    residue count from [min_res, cfg.n_res] so length bucketing has real
    work to do (lengths are a pure function of (seed, idx))."""

    def __init__(self, cfg, *, seed: int = 0, n_records: int = 64,
                 vary_length: bool = False, min_res: int = 8):
        self.cfg = cfg
        self.seed = seed
        self.n_records = n_records
        self.vary_length = vary_length
        self.min_res = min(min_res, cfg.n_res)

    def __len__(self) -> int:
        return self.n_records

    def record_length(self, idx: int) -> int:
        if not self.vary_length:
            return self.cfg.n_res
        rng = np.random.default_rng([abs(self.seed), 0x5EED, idx])
        return int(rng.integers(self.min_res, self.cfg.n_res + 1))

    def record(self, idx: int) -> ProteinRecord:
        rng = np.random.default_rng([abs(self.seed), 0x5EED, idx])
        r = (int(rng.integers(self.min_res, self.cfg.n_res + 1))
             if self.vary_length else self.cfg.n_res)
        seq = "".join(AA_ORDER[i] for i in rng.integers(0, 20, r))
        msa = synthesize_msa(seq, self.cfg.n_seq, rng)
        coords = _smooth_chain(rng, r)
        return ProteinRecord(name=f"synthetic_{idx}", seq=seq, msa=msa,
                             coords=coords)


class FastaSource:
    """FASTA records (path or text) as a Source.

    Each record's MSA is synthesized deterministically from its sequence
    digest (``synthesize_msa``); coords likewise unless a parallel
    ``structures`` dict ({header: (r, 3) coords}, e.g. from
    ``parse_mmcif_lite``) supplies a real CA trace.
    """

    def __init__(self, fasta: str, cfg, *, structures: Optional[dict] = None,
                 is_path: Optional[bool] = None):
        if is_path is None:
            is_path = "\n" not in fasta and not fasta.lstrip().startswith(">")
        text = open(fasta).read() if is_path else fasta
        self.records_raw = parse_fasta(text)
        if not self.records_raw:
            raise ValueError("FASTA source contains no records")
        self.cfg = cfg
        self.structures = structures or {}

    def __len__(self) -> int:
        return len(self.records_raw)

    def record_length(self, idx: int) -> int:
        return len(self.records_raw[idx][1])

    def record(self, idx: int) -> ProteinRecord:
        name, seq = self.records_raw[idx]
        rng = np.random.default_rng(
            [int.from_bytes(hashlib.sha256(seq.encode()).digest()[:8],
                            "big") % (2 ** 31), len(seq)])
        msa = synthesize_msa(seq, self.cfg.n_seq, rng)
        coords = self.structures.get(name)
        if coords is None:
            coords = _smooth_chain(rng, len(seq))
        return ProteinRecord(name=name, seq=seq, msa=msa,
                             coords=np.asarray(coords, np.float32))


def demo_fasta(cfg, *, n_records: int = 8, seed: int = 0,
               min_res: int = 8) -> str:
    """Deterministic mixed-length FASTA text for demos/benchmarks (lengths
    span [min_res, cfg.n_res])."""
    rng = np.random.default_rng([abs(seed), 0xFA57A])
    out = []
    for i in range(n_records):
        r = int(rng.integers(min(min_res, cfg.n_res), cfg.n_res + 1))
        seq = "".join(AA_ORDER[j] for j in rng.integers(0, 20, r))
        out.append(f">demo_{i} len={r}\n{seq}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Featurization (record -> AF2 feature dict, numpy)
# ---------------------------------------------------------------------------

def _one_hot(ids: np.ndarray, depth: int) -> np.ndarray:
    out = np.zeros(ids.shape + (depth,), np.float32)
    np.put_along_axis(out, ids[..., None].astype(np.int64), 1.0, axis=-1)
    return out


def featurize_record(record: ProteinRecord, cfg, *, seed: int = 0,
                     step: int = 0, idx: int = 0,
                     mask_rate: float = 0.15) -> dict:
    """One record -> the AF2 training feature dict (``protein_sample``'s
    keys/dtypes) at the RECORD's residue extent.

    MSA rows are stacked to ``cfg.n_seq`` (tiling the available alignment),
    extra rows to ``cfg.n_extra_seq``; the BERT-style masked-MSA positions
    are drawn from ``default_rng([seed, step, idx])`` — the pipeline's
    determinism contract: the output depends only on (record, seed, step,
    idx), never on which worker ran it or when.
    """
    r = record.n_res
    s, se = cfg.n_seq, cfg.n_extra_seq
    msa_rows = record.msa or [record.seq]
    ids = np.stack([aa_ids(row)[:r] for row in msa_rows])
    reps = -(-(s + se) // ids.shape[0])              # ceil: cover both stacks
    tiled = np.tile(ids, (reps, 1))
    true_msa = tiled[:s].astype(np.int32)
    extra_ids = tiled[s:s + se]

    rng = np.random.default_rng([abs(seed), step, idx])
    mask_positions = rng.random((s, r)) < mask_rate
    msa_feat = _one_hot(true_msa, cfg.msa_feat_dim)
    mask_tok = np.zeros((cfg.msa_feat_dim,), np.float32)
    mask_tok[cfg.n_aatype - 1] = 1.0
    msa_feat = np.where(mask_positions[..., None], mask_tok, msa_feat)
    extra_msa_feat = _one_hot(extra_ids, cfg.msa_feat_dim)

    target_ids = np.minimum(aa_ids(record.seq)[:r], cfg.target_feat_dim - 1)
    target_feat = _one_hot(target_ids, cfg.target_feat_dim)

    coords = record.coords
    if coords is None:
        coords = _smooth_chain(
            np.random.default_rng([record.digest_int() % (2 ** 31)]), r)
    rots, trans = frames_from_coords_np(coords)
    return {
        "msa_feat": msa_feat.astype(np.float32),
        "extra_msa_feat": extra_msa_feat.astype(np.float32),
        "target_feat": target_feat.astype(np.float32),
        "residue_index": np.arange(r, dtype=np.int32),
        "res_mask": np.ones((r,), np.float32),
        "true_msa": true_msa,
        "msa_mask_positions": mask_positions,
        "true_rots": rots.astype(np.float32),
        "true_trans": trans.astype(np.float32),
    }
