"""The distance-evaluation operations one Algorithm-1 solve needs.

A distance between two d-vectors counts 2·d operations (d multiply-adds,
as the products x·cᵀ of a GEMM).  Only work that the answer needs counts:

* the alive workers' local solves, each over its m = n·ell/s points:
  k-median++ seeding, which needs each point's distance to each new center
  only (k − 1 of them), ``local_iters`` assignment passes against k
  centers, ``weiszfeld_iters`` distances of each point to its own center
  in each pass, and the final pass that sizes the clusters;
* the coordinator's solve over the alive workers' (s − t)·k centers, with
  ``coord_iters`` passes and the same terms;
* the cost of the coordinator's k centers on all n points.

Stragglers' local solves, which the program runs as part of a fixed shape,
and the seeding's distances to centers already chosen are not needed.
"""


def _solve(points: int, k: int, iters: int, weiszfeld: int, d: int) -> float:
    seeding = (k - 1) * points
    passes = (iters + 1) * points * k
    own = iters * weiszfeld * points
    return 2.0 * d * (seeding + passes + own)


def flops(cfg: dict, traffic: dict) -> float:
    n, d, s, ell, k = cfg["points"], cfg["dim"], cfg["workers"], cfg["ell"], traffic["k"]
    alive = s - traffic["stragglers"]["t"]
    w = cfg["weiszfeld_iters"]
    local = alive * _solve(n * ell // s, k, cfg["local_iters"], w, d)
    coord = _solve(alive * k, k, cfg["coord_iters"], w, d)
    return local + coord + 2.0 * d * n * k
