"""Plain reference of ``sift1m-s10-cyclic4``: Algorithm 1's answers worked
out again in float64 from the points and the alive mask alone.

It imports torch and numpy only, and takes nothing the program made: the
assignment, the recovery weights, every point's nearest center and every
cost are its own.  What it reads of the program's answer is what it judges:
the recovery weights ``b``, the Lemma-3 summary (Y, w) and the returned
centers and cost.

* The cyclic assignment puts point ``j`` on workers ``j, j+1, …, j+ell−1``
  (mod ``s``), so its column of the assignment matrix depends on ``j mod
  s`` alone: every computation over the points' columns runs over the
  ``s`` column classes, each counted as often as it occurs.
* :func:`recovery_weights` is the on-device solver of the configuration
  (projected gradient on ½‖bᵀA_R − 1‖² over the alive rows, its step from 8
  power iterations, then the rescale to min a = 1), in float64.
* :func:`local_readings` assigns each alive worker's points to its local
  centers Y_i in float64: it gives each center the Lemma-3 weight
  b_i·|{points of worker i nearest to it}| that the coordinator gets, and
  it runs one more Lloyd pass (that assignment, then the configuration's
  Weiszfeld steps) from Y_i and reads how far the pass lowers the worker's
  k-median cost (:func:`pass_drop`).
* :func:`median_residual` reads how far the coordinator's centers are
  from the weighted geometric medians of their clusters of (Y, w), by the
  medians' optimality condition.  A pass would not do there: Weiszfeld's
  step barely moves a center that sits on a heavy point, as the
  coordinator's seeding leaves them.
* :func:`duplicate_share` reads how many of a set of centers sit on
  another: none, where the seeding spread them.

  These three start from the program's answer, not from its trajectory,
  so they judge it whatever way it was reached: a solve whose iterations
  ran to their count reads little, one whose Lloyd, Weiszfeld or
  coordinator iterations were cut or skipped, or whose seeding left its
  centers on one point, reads more.
* :func:`full_cost` is Σ_p min_c ‖p − c‖ over all points, in float64.

The control is this reference computed in TF32, the precision below the
configuration's float32: :func:`assign_min_tf32` (nearest center) and
:func:`device_recovery_tf32` (the recovery solve), their products' inputs
rounded to TF32's 10-bit mantissa and summed in float32, as the tensor
cores compute with TF32 on.  ``controls/sift1m-s10-cyclic4.py`` puts them in
the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 65536
EPS = 1e-12
ON_POINT = 1e-3  # a row this near a center sits on it


def column_classes(n: int, s: int, ell: int) -> tuple[np.ndarray, np.ndarray]:
    """(classes (s, s) 0/1: the column of a point j with j mod s = c, as
    row c; counts (s,): how many points fall in each class)."""
    cols = np.zeros((s, s))
    for c in range(s):
        cols[c, (c + np.arange(ell)) % s] = 1.0
    counts = np.bincount(np.arange(n) % s, minlength=s).astype(np.float64)
    return cols, counts


def node_rows(n: int, s: int, ell: int, node: int) -> np.ndarray:
    """The points that the cyclic assignment puts on ``node``."""
    j = np.arange(n)
    return np.flatnonzero((node - j) % s < ell)


def recovery_weights(n: int, s: int, ell: int, alive, *, iters: int = 500, lr: float = 1.0) -> np.ndarray:
    """(s,) float64 weights, zero at stragglers."""
    alive = np.asarray(alive, dtype=bool)
    cols, counts = column_classes(n, s, ell)
    A = cols.T[alive]                     # (r, s classes): the alive rows
    r = A.shape[0]
    v = np.full(s, 1.0 / np.sqrt(n))
    for _ in range(8):
        v = A.T @ (A @ (counts * v))
        v = v / max(np.sqrt(np.sum(counts * v * v)), 1e-12)
    sigma_sq = max(float(np.sum((A @ (counts * v)) ** 2)), 1e-6)
    step = lr / sigma_sq
    repl = np.maximum(A.sum(axis=0), 1.0)
    b = np.full(r, 1.0 / (np.sum(counts * repl) / n))
    for _ in range(iters):
        grad = A @ (counts * (A.T @ b - 1.0))
        b = np.maximum(b - step * grad, 0.0)
    a = A.T @ b
    covered = A.sum(axis=0) > 0
    amin = a[covered].min() if covered.any() else 0.0
    if amin > 1e-12:
        b = b / amin
    out = np.zeros(s)
    out[alive] = b
    return out


def _nearest(x: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, squared distance) of each row of ``x``'s nearest row of
    ``c``, both float64, in blocks of rows."""
    cn = (c * c).sum(dim=1)
    idx, d2 = [], []
    for lo in range(0, x.shape[0], BLOCK):
        xb = x[lo: lo + BLOCK]
        dist = (xb * xb).sum(dim=1, keepdim=True) - 2.0 * (xb @ c.T) + cn
        m, i = torch.min(dist, dim=1)
        idx.append(i)
        d2.append(torch.clamp_min(m, 0.0))
    return torch.cat(idx), torch.cat(d2)


def weiszfeld(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, centers: torch.Tensor, iters: int) -> torch.Tensor:
    """Each cluster's weighted geometric median after ``iters`` Weiszfeld
    steps from ``centers``, all float64; an empty cluster keeps its center."""
    k = centers.shape[0]
    for _ in range(iters):
        dist = torch.sqrt(torch.clamp_min(((x - centers[idx]) ** 2).sum(dim=1), EPS))
        coef = w / dist
        sums = torch.zeros_like(centers).index_add_(0, idx, x * coef[:, None])
        tot = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(0, idx, coef)
        centers = torch.where((tot > EPS)[:, None], sums / torch.clamp_min(tot, EPS)[:, None], centers)
    return centers


def pass_drop(x: torch.Tensor, w: torch.Tensor, centers: torch.Tensor, iters: int) -> tuple[float, torch.Tensor]:
    """(how far one Lloyd pass from ``centers`` lowers the weighted
    k-median cost Σ w·min_c ‖x − c‖, as a share of it; each row's nearest
    center before the pass)."""
    idx, d2 = _nearest(x, centers)
    before = float((w * torch.sqrt(d2)).sum())
    moved = weiszfeld(x, w, idx, centers, iters)
    _, d2 = _nearest(x, moved)
    after = float((w * torch.sqrt(d2)).sum())
    return (before - after) / before, idx


def median_residual(x: torch.Tensor, w: torch.Tensor, centers: torch.Tensor) -> float:
    """How far ``centers`` are from the weighted geometric medians of
    their clusters (each row of ``x`` in its nearest center's), by the
    medians' optimality condition: cluster j's center c_j is its median
    where the pull ‖Σ w·(c_j − x)/‖c_j − x‖‖ of its rows off c_j is at
    most the weight of its rows on c_j.  Returns the clusters' pulls in
    excess of that, summed, over the total weight: 0 at a fixed point of
    Lloyd's iterations, up to 1."""
    idx, d2 = _nearest(x, centers)
    d = torch.sqrt(d2)
    off = d > ON_POINT
    unit = torch.where(off[:, None], (centers[idx] - x) / torch.clamp_min(d, ON_POINT)[:, None], 0.0)
    pull = torch.zeros_like(centers).index_add_(0, idx, unit * w[:, None])
    on = torch.zeros(centers.shape[0], dtype=x.dtype, device=x.device).index_add_(0, idx, torch.where(off, 0.0, w))
    return float(torch.clamp_min(torch.linalg.vector_norm(pull, dim=1) - on, 0.0).sum() / w.sum())


def duplicate_share(centers: torch.Tensor) -> float:
    """The share of ``centers`` that sit on another of them."""
    d = torch.cdist(centers, centers).fill_diagonal_(torch.inf)
    return float((d.amin(dim=1) <= ON_POINT).double().mean())


def local_readings(points: torch.Tensor, centers: np.ndarray, b: np.ndarray, s: int, ell: int,
                   iters: int) -> tuple[np.ndarray, float]:
    """((s·k,) Lemma-3 weights of the local centers ``centers`` (s·k, d),
    worker i's k centers being rows i·k … (i+1)·k − 1; the largest
    :func:`pass_drop` of an alive worker's centers over its points)."""
    n = points.shape[0]
    k = centers.shape[0] // s
    out, drop = np.zeros(s * k), 0.0
    for i in range(s):
        if b[i] == 0.0:
            continue
        rows = torch.from_numpy(node_rows(n, s, ell, i)).to(points.device)
        x = points.index_select(0, rows)
        c = torch.as_tensor(centers[i * k: (i + 1) * k], dtype=torch.float64, device=points.device)
        d, idx = pass_drop(x, torch.ones(x.shape[0], dtype=torch.float64, device=x.device), c, iters)
        out[i * k: (i + 1) * k] = b[i] * torch.bincount(idx, minlength=k).double().cpu().numpy()
        drop = max(drop, d)
    return out, drop


def full_cost(points: torch.Tensor, centers: np.ndarray) -> float:
    c = torch.as_tensor(centers, dtype=torch.float64, device=points.device)
    _, d2 = _nearest(points, c)
    return float(torch.sqrt(d2).sum())


def compare(points: torch.Tensor, alive, answer: dict, cfg: dict) -> dict:
    """The numbers compared for one solve: the gaps between the program's
    answer and the reference's, relative to the reference; how far one more
    Lloyd pass lowers an alive worker's cost, how far the coordinator's
    centers are from their clusters' medians, and the largest share of
    one set of centers that sit on another of the set."""
    n, s, ell, iters = cfg["points"], cfg["workers"], cfg["ell"], cfg["weiszfeld_iters"]
    b = recovery_weights(n, s, ell, alive)
    w, local_drop = local_readings(points, answer["summary_points"], b, s, ell, iters)
    cost = full_cost(points, answer["centers"])
    keep = w > 0
    y = torch.as_tensor(answer["summary_points"][keep], dtype=torch.float64, device=points.device)
    centers = torch.as_tensor(answer["centers"], dtype=torch.float64, device=points.device)
    k = centers.shape[0]
    sets = [centers] + [torch.as_tensor(answer["summary_points"][i * k: (i + 1) * k], dtype=torch.float64,
                                        device=points.device) for i in range(s) if b[i] > 0]
    return {
        "b_gap": float(np.max(np.abs(answer["b"] - b)) / np.max(b)),
        "mass_gap": float(np.sum(np.abs(answer["summary_weights"] - w)) / np.sum(w)),
        "cost_gap": abs(answer["cost"] - cost) / cost,
        "local_drop": local_drop,
        "coord_residual": median_residual(y, torch.as_tensor(w[keep], device=points.device), centers),
        "dup_share": max(duplicate_share(c) for c in sets),
    }


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def assign_min_tf32(x: torch.Tensor, c: torch.Tensor, k_valid: int, *, block: int = 32768):
    """(idx int32, squared distance f32) of batched x (B, n, d) against
    the first ``k_valid`` of c (B, k, d), the products x·cᵀ in TF32."""
    c = c[:, :k_valid].float()
    ct = to_tf32(c)
    cn = (c * c).sum(dim=-1)
    idx, d2 = [], []
    for lo in range(0, x.shape[1], block):
        xb = x[:, lo: lo + block].float()
        dist = (xb * xb).sum(dim=-1, keepdim=True) + cn[:, None, :] - 2.0 * torch.bmm(to_tf32(xb), ct.transpose(1, 2))
        m, i = torch.min(dist, dim=-1)
        idx.append(i.to(torch.int32))
        d2.append(torch.clamp_min(m, 0.0))
    return torch.cat(idx, dim=1), torch.cat(d2, dim=1)


def device_recovery_tf32(A_R: torch.Tensor, *, iters: int = 500, lr: float = 1.0) -> torch.Tensor:
    """The recovery solve over the alive rows (r, n) with its products in
    TF32: b (r,) float32."""
    A = to_tf32(A_R.float())
    mv = lambda M, v: M @ to_tf32(v)  # noqa: E731
    n = A.shape[1]
    v = torch.full((n,), 1.0 / float(np.sqrt(n)), dtype=torch.float32, device=A.device)
    for _ in range(8):
        v = mv(A.T, mv(A, v))
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-12)
    sigma_sq = torch.clamp_min(torch.linalg.vector_norm(mv(A, v)) ** 2, 1e-6)
    step = lr / sigma_sq
    b = torch.ones(A.shape[0], dtype=torch.float32, device=A.device) / torch.mean(torch.clamp_min(A.sum(dim=0), 1.0))
    for _ in range(iters):
        b = torch.clamp_min(b - step * mv(A, mv(A.T, b) - 1.0), 0.0)
    a = mv(A.T, b)
    amin = torch.amin(torch.where(A.sum(dim=0) > 0, a, torch.inf))
    return torch.where(amin > 1e-12, b / amin, b)
