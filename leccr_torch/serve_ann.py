"""Approximate-NN serving: an IVF (inverted-file) index over retrieval
embeddings, built and searched on the device.

The port of `leccr_tpu/serve_ann.py`.  The exact index (`serve.py`) scores
every query against every row, so a query's cost grows with the corpus;
this index trades a little recall for a probe cost that does not, the IVF
recipe (Johnson et al., "Billion-scale similarity search with GPUs"):

- **Spherical k-means** (`_kmeans`): Lloyd iterations over row blocks
  (`_sim_block_rows`, so the [N, C] similarity never exists whole).  The
  assignment is one [blk, E] × [E, C] product; the update sums each
  cluster's rows by a one-hot [C, blk] × [blk, E] product, a fixed order,
  so two builds from one seed give the same centroids bit for bit (a
  scatter-add on the GPU adds in whatever order its atomics land).
  Centroids are re-normalized every iteration, and a cluster that goes
  empty takes the row farthest from its centroid.  No iteration reads
  anything back to the host.
- **Capacity-bounded packing** (`_pack`, `_greedy_place`): every cluster
  is padded to one capacity (`capacity_factor` × the mean occupancy,
  8-aligned) in a dense [C, cap, E] bank with a validity mask; rows go to
  their nearest cluster with room, strongest preference first.
- **Probe-by-probe search** (`_ivf_topk`): a query batch scores the C
  centroids, takes its `nprobe` best clusters, and a loop over the probe
  positions gathers ONE [B, cap, E] slab at a time, so peak memory is one
  slab and the [B, N] score matrix never exists.
- **int8** (`quantize_ivf`): the packed bank as symmetric per-row int8,
  scored as `serve.quantize_index`'s rows are: int8 products summed in
  int32, dequantized after.

Probing every cluster (`nprobe == n_clusters`) is exact brute-force search:
every row is packed exactly once.  `save_ivf` / `load_ivf` write and read
the JAX package's directory format, so either package loads the other's.
Equal scores come out lowest index first wherever JAX takes a top-k.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from leccr_torch.device import resolve_device
from leccr_torch.serve import (
    Embedder,
    ImageIndex,
    _host,
    _quantize_rows,
    _staged_load_dir,
    _staged_save_dir,
    _top_k,
    _write_array_save,
)


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor   # [C, E] f32, L2-normalized
    packed: torch.Tensor      # [C, cap, E] f32 (or int8 after quantize_ivf)
    valid: torch.Tensor       # [C, cap] bool; pad slots are False
    rows: torch.Tensor        # [C, cap] int32 global row id (0 where pad)
    ids: List[str]            # global row id -> item id
    scale: Optional[torch.Tensor] = None  # [C, cap] f32 int8 dequant scales
    # searches with nprobe=None use this (calibrate_nprobe finds it,
    # save_ivf keeps it): the index carries its own operating point
    default_nprobe: Optional[int] = None

    @property
    def n_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.packed.shape[1])

    @property
    def n_valid(self) -> int:
        return len(self.ids)

    @property
    def quantized(self) -> bool:
        return self.scale is not None


def _sim_block_rows(n: int, c: int) -> int:
    """Rows per assignment block: the live [blk, C] f32 similarity block
    stays near 256 MiB (the whole [N, C] is 14.9 GiB at N = 1M, C =
    4000)."""
    blk = max(8, (256 << 20) // (4 * max(c, 1)))
    blk = min(blk, -(-n // 8) * 8)
    return -(-blk // 8) * 8


def _kmeans(feats: torch.Tensor, n_clusters: int, iters: int,
            seed: int) -> torch.Tensor:
    """Spherical k-means (Lloyd) on feats' device.  Init: a random row
    sample (numpy's draw from `seed`, as in JAX).  Each iteration streams
    the rows in blocks of `_sim_block_rows`: the assignment (argmax, first
    index on ties), the fit of each row to its centroid, and the cluster
    sums and counts by a one-hot product (a fixed order).  A cluster that
    goes empty is reseeded with the k-th worst-fit row, effective next
    iteration.  Pad rows (to whole blocks) weigh 0 and fit +inf, so they
    are never summed or reseeded from."""
    n, e = feats.shape
    dev = feats.device
    rs = np.random.RandomState(seed)
    cent = feats[torch.from_numpy(rs.choice(n, n_clusters,
                                            replace=False)).to(dev)]
    blk = _sim_block_rows(n, n_clusters)
    padded = -(-n // blk) * blk
    f = F.pad(feats, (0, 0, 0, padded - n))
    w = (torch.arange(padded, device=dev) < n).float()
    cluster = torch.arange(n_clusters, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for _ in range(max(1, iters)):
        sums = torch.zeros(n_clusters, e, device=dev)
        counts = torch.zeros(n_clusters, device=dev)
        best = []
        for i in range(0, padded, blk):
            fblk, wblk = f[i: i + blk], w[i: i + blk]
            sim = fblk @ cent.T                             # [blk, C]
            best.append(torch.where(wblk > 0, sim.amax(dim=1), inf))
            onehot = ((sim.argmax(dim=1)[None, :] == cluster[:, None])
                      * wblk[None, :])                      # [C, blk]
            sums += onehot @ fblk
            counts += onehot.sum(dim=1)
        new = sums / counts.clamp_min(1.0)[:, None]
        new = new / torch.linalg.vector_norm(
            new, dim=1, keepdim=True).clamp_min(1e-12)
        empty = counts == 0
        # the k-th empty cluster takes the k-th worst-fit row (erank is
        # garbage where a cluster is not empty; the where masks it)
        worst = _top_k(-torch.cat(best)[None], n_clusters)[1][0]
        erank = (torch.cumsum(empty, 0) - 1).clamp(0, n_clusters - 1)
        cent = torch.where(empty[:, None], f[worst[erank]], new)
    return cent


def _candidate_clusters(feats: torch.Tensor, cent: torch.Tensor,
                        p: int) -> Tuple[np.ndarray, np.ndarray]:
    """The top-`p` candidate clusters of each row, streamed in row blocks
    (one [blk, C] similarity live at a time).  Returns (sims [N, p],
    cluster ids [N, p]) on the host."""
    blk = _sim_block_rows(feats.shape[0], cent.shape[0])
    sims, cids = [], []
    for i in range(0, feats.shape[0], blk):
        s, c = _top_k(feats[i: i + blk] @ cent.T, p)
        sims.append(s)
        cids.append(c)
    return torch.cat(sims).cpu().numpy(), torch.cat(cids).cpu().numpy()


def _greedy_place(cids: np.ndarray, margin: np.ndarray, cap: int,
                  fill: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Capacity-bounded placement of N rows into clusters with free
    slots (mutates `fill` — pass existing occupancy to add to a built
    bank).  Vectorized round-based greedy: round j places every
    still-unplaced row into its rank-j candidate while space lasts
    (within a round, contested slots go to the rows with the strongest
    top1-top2 margin) — every row gets a shot at its TRUE nearest
    cluster before any row falls back to its second choice.  A row whose
    candidates all filled spills to the emptiest clusters; total free
    capacity ≥ N by the callers' invariants, so placement never fails.
    Pure numpy sorts — O(P · N log N) host time, no Python-per-row loop.
    Returns (cluster [N], slot [N]) per row."""
    c = fill.shape[0]
    n, p = cids.shape
    place_c = -np.ones(n, np.int64)
    place_s = -np.ones(n, np.int64)
    todo = np.argsort(-margin)  # row ids, strongest preference first
    for j in range(p):
        if not todo.size:
            break
        cand = cids[todo, j]
        order = np.argsort(cand, kind="stable")  # grouped, margin-ordered
        sc = cand[order]
        rank = np.arange(sc.size) - np.searchsorted(sc, np.arange(c))[sc]
        acc = rank < (cap - fill)[sc]
        rid = todo[order[acc]]
        place_c[rid] = sc[acc]
        place_s[rid] = fill[sc[acc]] + rank[acc]
        fill += np.bincount(sc[acc], minlength=c)
        keep = np.ones(todo.size, bool)
        keep[order[acc]] = False
        todo = todo[keep]
    if todo.size:  # spill to the emptiest clusters' free slots
        cl_order = np.argsort(fill)
        free = cap - fill
        slot_c = np.repeat(cl_order, free[cl_order])
        slot_p = np.concatenate(
            [np.arange(fill[cc], cap) for cc in cl_order if free[cc]]
            or [np.empty(0, np.int64)])
        m = todo.size
        place_c[todo] = slot_c[:m]
        place_s[todo] = slot_p[:m]
        fill += np.bincount(slot_c[:m], minlength=c)
    return place_c, place_s


def _pack(feats: torch.Tensor, cent: torch.Tensor, capacity_factor: float,
          candidates: int) -> Tuple[np.ndarray, int]:
    """Capacity-bounded assignment at build time.  Returns (rows [C, cap]
    int64 with -1 pads, cap)."""
    n = feats.shape[0]
    c = cent.shape[0]
    cap = int(np.ceil(n / c * capacity_factor))
    cap = max(8, -(-cap // 8) * 8)  # 8-aligned [*, cap, E] layout
    p = min(candidates, c)
    sims, cids = _candidate_clusters(feats, cent, p)
    margin = sims[:, 0] - (sims[:, 1] if p > 1 else 0.0)
    place_c, place_s = _greedy_place(cids, margin, cap,
                                     np.zeros(c, np.int64))
    rows = -np.ones((c, cap), np.int64)
    rows[place_c, place_s] = np.arange(n)
    return rows, cap


@torch.inference_mode()
def build_ivf_index(index: ImageIndex, n_clusters: Optional[int] = None,
                    iters: int = 15, capacity_factor: float = 1.3,
                    candidates: int = 8, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> IVFIndex:
    """Cluster an exact f32 index into an IVF index on `device` (None = the
    GPU).  Defaults: C ≈ 4·√N (the centroid scan's cost balances the
    probes'), 15 Lloyd iterations.  `quantize_ivf` afterward for the int8
    bank."""
    if index.quantized:
        raise ValueError("build_ivf_index from the fp32 index "
                         "(quantize_ivf afterward)")
    n = index.n_valid
    if n_clusters is None:
        n_clusters = max(1, min(n, int(4 * np.sqrt(n))))
    if not 1 <= n_clusters <= n:
        raise ValueError(f"n_clusters={n_clusters} not in [1, {n}]")
    if capacity_factor < 1.0:
        raise ValueError(  # _pack's never-fails invariant needs cap·C ≥ N
            f"capacity_factor={capacity_factor} must be >= 1")
    dev = resolve_device(device)
    feats = index.feats[:n].to(dev, torch.float32)
    cent = _kmeans(feats, n_clusters, iters, seed)
    rows, cap = _pack(feats, cent, capacity_factor, candidates)
    rj = torch.from_numpy(np.maximum(rows, 0).astype(np.int32)).to(dev)
    return IVFIndex(centroids=cent, packed=feats[rj.long()],
                    valid=torch.from_numpy(rows >= 0).to(dev), rows=rj,
                    ids=list(index.ids))


@torch.inference_mode()
def quantize_ivf(ivf: IVFIndex) -> IVFIndex:
    """Symmetric per-row int8 over the packed bank (the scheme and accuracy
    of `serve.quantize_index`): a probe reads 4× fewer bytes."""
    if ivf.quantized:
        return ivf
    c, cap, e = ivf.packed.shape
    packed, scale = _quantize_rows(ivf.packed.reshape(c * cap, e))
    return IVFIndex(centroids=ivf.centroids,
                    packed=packed.reshape(c, cap, e),
                    valid=ivf.valid, rows=ivf.rows, ids=list(ivf.ids),
                    scale=scale.reshape(c, cap),
                    default_nprobe=ivf.default_nprobe)


def _widen(x: torch.Tensor, grow: int) -> torch.Tensor:
    """A copy of [C, cap, ...] x with `grow` zero slots after each
    cluster's last."""
    if not grow:
        return x.clone()
    return torch.cat([x, x.new_zeros((x.shape[0], grow) + x.shape[2:])],
                     dim=1)


@torch.inference_mode()
def add_to_ivf(ivf: IVFIndex, new: ImageIndex,
               candidates: int = 8) -> IVFIndex:
    """Append a built exact index's items (embed the NEW items only, then
    add: nothing existing is embedded or clustered again), as
    `serve.merge_indexes` does for the exact family.

    Each new row goes to its nearest candidate cluster with room (the
    build's greedy placement, from the bank's current occupancy; it spills
    to the emptiest clusters when its candidates are full); when the bank
    itself is full, every cluster's capacity grows (8-aligned).  Existing
    rows keep their bytes, int8 ones and their scales included; new rows
    of an int8 bank are quantized the same way on the way in.

    RELIES on the prefix-occupancy invariant: every cluster's valid slots
    are exactly [0, fill) with fill == valid.sum(1), since new rows are
    written at slots fill, fill + 1, ...  `build_ivf_index` packs that way
    and `remove_from_ivf` compacts to keep it.

    Centroids are NOT re-fit: recall at a fixed nprobe falls slowly as
    adds grow; after adds comparable to the corpus, rebuild, and run
    `calibrate_nprobe` again either way where the operating point
    matters."""
    if new.quantized:
        raise ValueError("add_to_ivf from the fp32 index (new rows are "
                         "quantized on the way in when the bank is int8)")
    dup = set(ivf.ids) & set(new.ids)
    if dup:
        raise ValueError(f"duplicate ids in add: {sorted(dup)[:5]} ...")
    n_new = new.n_valid
    if n_new == 0:
        return ivf
    c, cap = ivf.n_clusters, ivf.capacity
    dev = ivf.packed.device
    feats = new.feats[:n_new].to(dev, torch.float32)
    fill = ivf.valid.sum(dim=1).cpu().numpy().astype(np.int64)
    free = c * cap - int(fill.sum())
    grow = 0
    if free < n_new:  # grow every cluster's capacity, 8-aligned
        grow = -(-(n_new - free) // c)
        grow = -(-grow // 8) * 8
    packed, vmask, rows = (_widen(x, grow)
                           for x in (ivf.packed, ivf.valid, ivf.rows))
    scale = None if ivf.scale is None else _widen(ivf.scale, grow)
    p = min(candidates, c)
    sims, cids = _candidate_clusters(feats, ivf.centroids, p)
    margin = sims[:, 0] - (sims[:, 1] if p > 1 else 0.0)
    place_c, place_s = _greedy_place(cids, margin, cap + grow, fill)
    pc = torch.from_numpy(place_c).to(dev)
    ps = torch.from_numpy(place_s).to(dev)
    if ivf.quantized:
        packed[pc, ps], scale[pc, ps] = _quantize_rows(feats)
    else:
        packed[pc, ps] = feats
    vmask[pc, ps] = True
    rows[pc, ps] = len(ivf.ids) + torch.arange(n_new, dtype=torch.int32,
                                               device=dev)
    return IVFIndex(centroids=ivf.centroids, packed=packed, valid=vmask,
                    rows=rows, ids=list(ivf.ids) + list(new.ids),
                    scale=scale, default_nprobe=ivf.default_nprobe)


@torch.inference_mode()
def remove_from_ivf(ivf: IVFIndex, ids: Sequence[str]) -> IVFIndex:
    """Drop items by id without clustering again: the surviving rows
    renumber densely (the ids list compacts), and each cluster's survivors
    COMPACT to a slot prefix, keeping the invariant that `add_to_ivf`
    writes by (every cluster's valid slots are [0, fill)).  Compaction
    moves slots within a cluster only, each row with its bytes and its
    int8 scale, so removal is exact on an int8 bank too.  Unknown ids are
    an error."""
    drop = set(ids)
    unknown = drop - set(ivf.ids)
    if unknown:
        raise ValueError(f"unknown ids: {sorted(unknown)[:5]} ...")
    if not drop:
        return ivf
    dev = ivf.packed.device
    keep = np.asarray([i not in drop for i in ivf.ids], bool)
    new_gid = np.cumsum(keep) - 1  # meaningful only where keep
    rows = ivf.rows.cpu().numpy()
    valid = ivf.valid.cpu().numpy() & keep[rows]
    # per-cluster compaction: a stable sort of the slots by ~valid slides
    # the survivors to a prefix in their order, holes to the tail; one
    # gather per array on the device
    order = np.argsort(~valid, axis=1, kind="stable")       # [C, cap]
    o = torch.from_numpy(order).to(dev)
    packed = torch.gather(ivf.packed, 1, o[:, :, None].expand(
        -1, -1, ivf.packed.shape[2]))
    scale = None if ivf.scale is None else torch.gather(ivf.scale, 1, o)
    rows_c = np.take_along_axis(np.where(valid, new_gid[rows], 0), order,
                                axis=1)
    return IVFIndex(
        centroids=ivf.centroids, packed=packed,
        valid=torch.from_numpy(np.take_along_axis(valid, order,
                                                  axis=1)).to(dev),
        rows=torch.from_numpy(rows_c.astype(np.int32)).to(dev),
        ids=[i for i in ivf.ids if i not in drop], scale=scale,
        default_nprobe=ivf.default_nprobe)


def _ivf_arrays(ivf: IVFIndex):
    return ivf.centroids, ivf.packed, ivf.valid, ivf.rows, ivf.scale


@torch.inference_mode()
def _ivf_topk(q: torch.Tensor, ivf_arrays, k: int, nprobe: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, E] queries -> (scores [B, k], global row ids [B, k]).  One
    centroid product, then a loop over the nprobe probe positions: each
    step gathers ONE [B, cap, E] cluster slab and scores it against the
    query batch, so peak memory is one slab whatever nprobe is.  Pad
    slots of a probed cluster score -inf."""
    cent, packed, valid, rows, scale = ivf_arrays
    cids = _top_k(q @ cent.T, nprobe)[1]                       # [B, nprobe]
    if scale is not None:
        qq, qs = _quantize_rows(q)
        qq = qq.int()[:, None, :]
    s_all, r_all = [], []
    for j in range(nprobe):
        col = cids[:, j]                                        # [B]
        f = packed[col]                                         # [B, cap, E]
        if scale is None:
            s = torch.bmm(f, q[:, :, None])[..., 0]
        else:  # int8 products summed in int32, exactly, then dequantized
            s = (f.int() * qq).sum(dim=-1, dtype=torch.int32)
            s = s.float() * qs[:, None] * scale[col]
        s_all.append(torch.where(valid[col], s, float("-inf")))
        r_all.append(rows[col])
    s_all = torch.stack(s_all, dim=1).reshape(q.shape[0], -1)
    r_all = torch.stack(r_all, dim=1).reshape(q.shape[0], -1)
    vals, pos = _top_k(s_all, k)
    return vals, torch.gather(r_all, 1, pos)


@torch.inference_mode()
def calibrate_nprobe(ivf: IVFIndex, target_recall: float = 0.95,
                     k: int = 10, sample: int = 256,
                     seed: int = 0) -> Tuple[int, float]:
    """The smallest nprobe whose recall@k ≥ target_recall, measured on
    `sample` corpus rows used as self-queries against the index's own
    full probe (exact), the trivial self-hit left out of the truth.  Probe
    sets are NESTED in nprobe (the top-n clusters are a prefix of the
    top-2n), so recall is monotone, and a doubling ladder and a binary
    refine find the threshold on the sample.  Returns (nprobe, recall);
    stamp it with `dataclasses.replace(ivf, default_nprobe=nprobe)`.
    Measures the bank as deployed: an int8 bank with int8 scoring."""
    if not 0.0 < target_recall <= 1.0:
        raise ValueError(f"target_recall={target_recall} not in (0, 1]")
    c = ivf.n_clusters
    rs = np.random.RandomState(seed)
    ci, si = np.nonzero(ivf.valid.cpu().numpy())
    pick = rs.choice(ci.size, min(sample, ci.size), replace=False)
    ci, si = ci[pick], si[pick]
    at = (torch.from_numpy(ci).to(ivf.packed.device),
          torch.from_numpy(si).to(ivf.packed.device))
    packed = ivf.packed[at].cpu().numpy().astype(np.float32)
    if ivf.scale is not None:
        packed *= ivf.scale[at].cpu().numpy()[:, None]
    q = torch.from_numpy(packed).to(ivf.packed.device)
    self_ids = ivf.rows[at].cpu().numpy()
    kk = min(k + 1, ivf.n_valid)  # +1 absorbs the self-hit

    def ids_at(nprobe):
        return _ivf_topk(q, _ivf_arrays(ivf), kk, nprobe)[1].cpu().numpy()

    gt = [set(r[r != s][:k]) or {s} for r, s in zip(ids_at(c), self_ids)]

    def recall(nprobe):
        got = ids_at(nprobe)
        return float(np.mean([len(set(r[r != s][:k]) & g) / len(g)
                              for r, s, g in zip(got, self_ids, gt)]))

    lo, hi, r_hi = 0, 1, recall(1)  # invariant: lo fails, hi passes
    while r_hi < target_recall and hi < c:
        lo, hi = hi, min(2 * hi, c)
        r_hi = recall(hi)
    if r_hi < target_recall:  # even the exact probe missed (ties): C
        return c, r_hi
    while hi - lo > 1:  # recall is monotone (nested probe prefixes)
        mid = (lo + hi) // 2
        r_mid = recall(mid)
        if r_mid >= target_recall:
            hi, r_hi = mid, r_mid
        else:
            lo = mid
    return hi, r_hi


@torch.inference_mode()
def search_texts_ivf(emb: Embedder, queries: Sequence[str], ivf: IVFIndex,
                     k: int = 10, nprobe: Optional[int] = None,
                     ) -> List[List[Tuple[str, float]]]:
    """text → item retrieval over an IVF index: the top-k (id, score) per
    query, scoring only the nprobe most promising clusters.  nprobe dials
    recall against cost (default: the index's calibrated default_nprobe,
    else min(8, C)); nprobe == ivf.n_clusters is exact.  A row may come
    back SHORTER than k: the probed clusters can hold fewer than k live
    rows between them, and pad slots (-inf) are dropped, never returned as
    row 0."""
    if nprobe is None:
        nprobe = ivf.default_nprobe or min(8, ivf.n_clusters)
    if not 1 <= nprobe <= ivf.n_clusters:
        raise ValueError(f"nprobe={nprobe} not in [1, {ivf.n_clusters}]")
    k = min(k, ivf.n_valid, nprobe * ivf.capacity)
    if not queries:
        return []
    bs = emb.batch_size
    out: List[List[Tuple[str, float]]] = []
    for i in range(0, len(queries), bs):
        chunk = list(queries[i: i + bs])
        n = len(chunk)
        chunk += [""] * (bs - n)
        q = emb.model.embed_texts(*emb._tokens(chunk))
        scores, gids = _ivf_topk(q, _ivf_arrays(ivf), k, nprobe)
        scores, gids = scores[:n].cpu().numpy(), gids[:n].cpu().numpy()
        out.extend([(ivf.ids[j], float(s))
                    for j, s in zip(ri, rs) if np.isfinite(s)]
                   for ri, rs in zip(gids, scores))
    return out


_IVF_ARRAYS = ("centroids", "packed", "valid", "rows", "scale")


def save_ivf(ivf: IVFIndex, path: str) -> None:
    """Persist an IVF index (a directory; hdfs:// too): cluster once, serve
    many restarts.  The staging and the manifest are `serve.save_index`'s,
    with "kind": "ivf" and the calibrated nprobe in the manifest."""
    with _staged_save_dir(path, "leccr_ivf_") as local:
        _write_array_save(
            local, {}, {name: _host(getattr(ivf, name))
                        for name in _IVF_ARRAYS},
            ivf.ids,
            {"kind": "ivf", **({"nprobe": ivf.default_nprobe}
                               if ivf.default_nprobe else {})})


def is_ivf_save(path: str) -> bool:
    """True if `path` holds an IVF save (save_ivf), False for an exact one
    (serve.save_index): a consumer loads a directory without knowing how
    it was built.  hdfs:// too."""
    from leccr_torch.utils import io

    mpath = os.path.join(path, "manifest.json")
    if not io.exists(mpath):
        return False
    with io.open_file(mpath) as f:
        return json.load(f).get("kind") == "ivf"


def load_ivf(path: str,
             device: Optional[Union[str, torch.device]] = None) -> IVFIndex:
    """Load an IVF save (this package's or the JAX package's) onto
    `device` (None = the GPU)."""
    device = resolve_device(device)
    with _staged_load_dir(path, "leccr_ivf_") as local:
        with open(os.path.join(local, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("kind") != "ivf":
            raise ValueError(f"{path} is not an IVF index save")
        allowed = set(manifest["optional"])
        with open(os.path.join(local, "ids.json")) as f:
            ids = json.load(f)

        def arr(name):
            if name not in allowed:
                return None
            return torch.from_numpy(
                np.load(os.path.join(local, name + ".npy"))).to(device)

        ivf = IVFIndex(ids=list(ids), default_nprobe=manifest.get("nprobe"),
                       **{name: arr(name) for name in _IVF_ARRAYS})
    if len(ivf.ids) != manifest["n"]:
        raise ValueError(f"ivf index corrupt: {len(ivf.ids)} ids vs "
                         f"manifest n={manifest['n']}")
    return ivf
