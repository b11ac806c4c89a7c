"""The plain reference of `align`: what each read or pair of a job must
write to the align TSV, worked out from the library file and the reads
alone, in plain PyTorch (on the card or the CPU) and NumPy.

It builds its own index: every k-mer of every library sequence's forward
strand with the set of features that hold it, the distinct sets numbered
as classes, and, for the group probe, the set of (k+g-1)-mers. A read is
then scored as the contract of the program states it:

  * window j of a read (bases j .. j+k-1) is *found* in an orientation
    when that orientation's k-mer (the read's own, or the reverse
    complement of it for the reverse orientation) is a library k-mer;
  * under the per-k-mer probe (`--probe mono`) a found window is matched;
    under the group probe a found window is matched only where one of the
    read's probes covers it: the (k+g-1)-mers at 0, g, 2g, ... and the last
    one at len - (k+g-1), each present when it or its reverse complement
    occurs in the library, covering its g windows;
  * an orientation's score is the number of read bases covered by a
    matched window; the read is scored in the forward orientation unless
    the reverse one scores higher; its feature set is the AND of the
    matched windows' sets in that orientation;
  * a mate counts when its score reaches `score_threshold` and
    `score_percent` of its length (float32) and its set is not empty; a
    pair keeps the AND of its counted mates' sets (intersect_level 0: one
    counted mate keeps its own), scores their sum, and is written when the
    sum reaches `score_filter`, the set is not empty and holds at most
    `max_hits_to_report` features, named in sorted order.

Nothing here reads what the program made: no index, table or sidecar of
it, and no module of it.
"""
from __future__ import annotations

import json

import numpy as np
import torch

LUT = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate(b"ACGT"):
    LUT[_c] = _i
N = 4  # a base that is not A, C, G or T, and padding


def load_library(path: str):
    """(library Config dict, feature names, (n, max_len) int8 codes, (n,)
    lengths) of a [Config, Data] library JSON."""
    with open(path) as f:
        config, data = json.load(f)
    cols = dict(zip(data["headers"], data["columns"]))
    names, seqs = cols["sequence_name"], cols["sequence"]
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    codes = np.full((len(seqs), int(lens.max())), N, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = LUT[np.frombuffer(s.encode(), dtype=np.uint8)]
    return config, names, codes, lens


def kmer_codes(codes: torch.Tensor, lens: torch.Tensor, k: int, reverse: bool = False):
    """(B, L) int8 codes -> (B, L-k+1) int64 k-mer codes (first base in the
    high bits), of the reverse complement of each window when `reverse`,
    and whether the window lies in the sequence and holds no N."""
    B, L = codes.shape
    P = L - k + 1
    c = codes.long()
    bad = (c >= N).long()
    c = torch.where(c >= N, 0, c)
    out = torch.zeros((B, P), dtype=torch.long, device=codes.device)
    n_bad = torch.zeros((B, P), dtype=torch.long, device=codes.device)
    for i in range(k):
        base = c[:, i:i + P]
        if reverse:
            out |= (3 - base) << (2 * i)
        else:
            out = (out << 2) | base
        n_bad += bad[:, i:i + P]
    pos = torch.arange(P, device=codes.device)[None, :]
    return out, (n_bad == 0) & (pos + k <= lens[:, None])


def _lookup(keys: torch.Tensor, q: torch.Tensor):
    """(index into the sorted keys, found) of every query."""
    idx = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    return idx, keys[idx] == q


class Index:
    """The reference's k-mer index of one library.

    key_mask: the bits of each k-mer and (k+g-1)-mer code that are
    compared; all of them in the reference. The control narrows it."""

    def __init__(self, library: str, k: int, g: int, device, key_mask: int = -1, block: int = 2048):
        self.config, self.names, codes, lens = load_library(library)
        self.k, self.g, self.key_mask, self.device = k, g, key_mask, device
        n_feat = len(self.names)
        self.W = (n_feat + 31) // 32
        fbits = max(1, (n_feat - 1).bit_length())
        if 2 * k + fbits > 62:
            raise ValueError(f"k = {k} and {n_feat} features do not fit one int64 key")
        pairs, groups = [], []
        for s in range(0, codes.shape[0], block):
            c = torch.from_numpy(codes[s:s + block]).to(device)
            ln = torch.from_numpy(lens[s:s + block]).to(device)
            km, ok = kmer_codes(c, ln, k)
            feat = torch.arange(s, s + c.shape[0], device=device)[:, None].expand_as(km)
            pairs.append(torch.unique(((km & key_mask) << fbits | feat)[ok]))
            if g >= 2:
                gm, gok = kmer_codes(c, ln, k + g - 1)
                groups.append(torch.unique(gm[gok] & key_mask))
        pairs = torch.unique(torch.cat(pairs))  # sorted: by k-mer, then feature
        self.group_keys = torch.unique(torch.cat(groups)) if groups else None
        key, feat = pairs >> fbits, pairs & ((1 << fbits) - 1)
        start = torch.ones_like(key, dtype=torch.bool)
        start[1:] = key[1:] != key[:-1]
        seg = torch.cumsum(start.long(), 0) - 1
        self.keys = key[start]
        # a class is a distinct feature set: hash each k-mer's set, number
        # the distinct hashes, and fill each class's bits from one k-mer
        gen = torch.Generator().manual_seed(0x5EED)
        rnd = torch.randint(0, 1 << 40, (2, n_feat), generator=gen).to(device)
        n_key = self.keys.numel()
        h = [torch.zeros(n_key, dtype=torch.long, device=device).index_add_(0, seg, rnd[i][feat])
             for i in range(2)]
        cnt = torch.bincount(seg, minlength=n_key)
        sig = (h[0] * 1_000_003 + h[1] * 7_919 + cnt) & ((1 << 62) - 1)
        _, self.key_class = torch.unique(sig, return_inverse=True)
        n_cls = int(self.key_class.max()) + 1
        first = torch.full((n_cls,), n_key, dtype=torch.long, device=device)
        first.scatter_reduce_(0, self.key_class, torch.arange(n_key, device=device), "amin")
        own = first[self.key_class[seg]] == seg
        cls = self.key_class[seg[own]]
        words = torch.zeros(n_cls * self.W, dtype=torch.long, device=device)
        words.index_add_(0, cls * self.W + (feat[own] >> 5), 1 << (feat[own] & 31))
        self.class_bits = words.view(n_cls, self.W).to(torch.int32)
        self.n_classes = n_cls

    def found(self, q: torch.Tensor, ok: torch.Tensor):
        """(class id, found) of (B, P) k-mer codes."""
        idx, hit = _lookup(self.keys, q & self.key_mask)
        return self.key_class[idx], hit & ok

    def group_present(self, q: torch.Tensor, q_rc: torch.Tensor, ok: torch.Tensor):
        _, a = _lookup(self.group_keys, q & self.key_mask)
        _, b = _lookup(self.group_keys, q_rc & self.key_mask)
        return (a | b) & ok


def score_mate(ix: Index, codes: torch.Tensor, lens: torch.Tensor, probe: str):
    """One mate of a block of reads -> (bits (B, W) int32, score, forward
    score), the mate's feature set and scores before the filters."""
    k = ix.k
    B, L = codes.shape
    P = L - k + 1
    fwd, ok = kmer_codes(codes, lens, k)
    rev, _ = kmer_codes(codes, lens, k, reverse=True)
    cls_f, m_f = ix.found(fwd, ok)
    cls_r, m_r = ix.found(rev, ok)
    if probe == "group":
        kg = k + ix.g - 1
        if bool((lens < kg).any()):
            raise ValueError(f"the group probe's reference takes reads of at least {kg} bases")
        y, yok = kmer_codes(codes, lens, kg)
        y_rc, _ = kmer_codes(codes, lens, kg, reverse=True)
        p = torch.arange(y.shape[1], device=codes.device)[None, :]
        probe_at = (p % ix.g == 0) | (p == (lens - kg)[:, None])
        present = ix.group_present(y, y_rc, yok & probe_at).long()
        cs = torch.cat([torch.zeros_like(present[:, :1]), present.cumsum(1)], 1)
        j = torch.arange(P, device=codes.device)
        hi = torch.clamp(j + 1, max=present.shape[1])
        covered = (cs[:, hi] - cs[:, (j - ix.g + 1).clamp(min=0)]) > 0
        m_f, m_r = m_f & covered, m_r & covered
    elif probe != "mono":
        raise ValueError(f"probe must be 'group' or 'mono', got {probe!r}")
    b = torch.arange(L, device=codes.device)
    in_read = b[None, :] < lens[:, None]

    def score(m):
        cs = torch.cat([torch.zeros_like(m[:, :1], dtype=torch.long), m.long().cumsum(1)], 1)
        win = cs[:, torch.clamp(b + 1, max=P)] - cs[:, (b - k + 1).clamp(min=0, max=P)]
        return ((win > 0) & in_read).sum(1)

    s_f, s_r = score(m_f), score(m_r)
    use_f = s_f >= s_r
    m = torch.where(use_f[:, None], m_f, m_r)
    cls = torch.where(use_f[:, None], cls_f, cls_r)
    acc = torch.full((B, ix.W), -1, dtype=torch.int32, device=codes.device)
    for jj in range(P):
        acc = torch.where(m[:, jj, None], acc & ix.class_bits[cls[:, jj]], acc)
    acc = torch.where(m.any(1)[:, None], acc, 0)
    return acc, torch.where(use_f, s_f, s_r), s_f


def popcount(bits: torch.Tensor) -> torch.Tensor:
    """Set bits of each (B, W) int32 row."""
    x = bits.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum(1)


def align_block(ix: Index, cfg: dict, probe: str, r1, l1, r2=None, l2=None):
    """A block of reads (or pairs) -> (bits, score, r1 forward score, r2
    forward score, written) after the mates' filters and the pair's."""
    pct = torch.tensor(float(cfg["score_percent"]), dtype=torch.float32)

    def counted(bits, score, lens):
        return ((score >= int(cfg["score_threshold"]))
                & (score.float() >= pct.to(score.device) * lens.float())
                & (bits != 0).any(1))

    b1, s1, f1 = score_mate(ix, r1, l1, probe)
    v1 = counted(b1, s1, l1)
    if r2 is None:
        bits, score, any_v, f2 = torch.where(v1[:, None], b1, 0), torch.where(v1, s1, 0), v1, torch.zeros_like(f1)
    else:
        if int(cfg["intersect_level"]) != 0 or cfg["require_valid_pair"]:
            raise ValueError("the reference takes intersect_level 0 without require_valid_pair")
        b2, s2, f2 = score_mate(ix, r2, l2, probe)
        v2 = counted(b2, s2, l2)
        b1, b2 = torch.where(v1[:, None], b1, 0), torch.where(v2[:, None], b2, 0)
        bits = torch.where((v1 & v2)[:, None], b1 & b2, torch.where(v1[:, None], b1, b2))
        score = torch.where(v1, s1, 0) + torch.where(v2, s2, 0)
        any_v = v1 | v2
    n_feat = popcount(bits)
    write = any_v & (score >= int(cfg["score_filter"])) & (n_feat > 0)
    if cfg["discard_multiple_matches"] or int(cfg["discard_multi_hits"]) > 0 or cfg["group_on"]:
        raise ValueError("the reference takes the default set-size filters and no group_on")
    write &= n_feat <= int(cfg["max_hits_to_report"])
    return bits, score, f1, f2, write


def set_bits(bits: torch.Tensor):
    """(row, feature) numpy arrays of the set bits of (n, W) int32 rows,
    found word by word on the rows' device, rows ascending."""
    r, w = torch.nonzero(bits, as_tuple=True)
    v = bits[r, w].long() & 0xFFFFFFFF
    i, b = torch.nonzero((v[:, None] >> torch.arange(32, device=bits.device)) & 1, as_tuple=True)
    return r[i].cpu().numpy(), (w[i] * 32 + b).cpu().numpy()


def feature_strings(names, row: np.ndarray, feat: np.ndarray, n: int):
    """The comma-joined sorted names of each of n rows' features (row,
    feat pairs, rows ascending), joined once for each distinct set."""
    cnt = np.bincount(row, minlength=n)
    sets = np.full((n, max(int(cnt.max()) if n else 0, 1)), -1, dtype=np.int64)
    sets[row, np.arange(row.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)] = feat
    uniq, inv = np.unique(sets, axis=0, return_inverse=True)
    strs = [",".join(sorted(names[i] for i in u if i >= 0)) for u in uniq]
    return [strs[i] for i in inv.reshape(-1)]


def tsv_rows(ix: Index, probe: str, r1: np.ndarray, r2: np.ndarray = None, tags=None,
             block: int = 16384) -> list:
    """The align TSV's data lines (each ending in a newline), in input
    order, of reads r1 (n, L) int8 (and mates r2) of full length. `tags`
    gives each pair's (CB, UB) strings for a tagged BAM; a BAM's records
    are unmapped, so both positions are -1."""
    out = []
    for s in range(0, r1.shape[0], block):
        mates = []
        for r in (r1, r2):
            if r is not None:
                c = torch.from_numpy(np.ascontiguousarray(r[s:s + block])).to(ix.device)
                mates += [c, torch.full((c.shape[0],), r.shape[1], dtype=torch.long, device=ix.device)]
        bits, score, f1, f2, write = align_block(ix, ix.config, probe, *mates)
        keep = torch.nonzero(write).squeeze(1)
        names = feature_strings(ix.names, *set_bits(bits[keep]), keep.numel())
        score, f1, f2 = (t[keep].cpu().tolist() for t in (score, f1, f2))
        for i, feats, sc, a, b in zip(keep.cpu().tolist(), names, score, f1, f2):
            if tags is None:
                out.append(f"{feats}\t{sc}\t\t\t\t\t\t\t{a}\t{b}\t\n")
            else:
                cb, ub = tags[s + i]
                out.append(f"{feats}\t{sc}\t{cb}\t{ub}\t{cb}\t{ub}\t-1\t-1\t{a}\t{b}\t\n")
    return out
