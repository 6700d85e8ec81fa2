"""Quickstart: cluster a signed graph with the paper's algorithms.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``. The distributed engine runs on the
initialised ``torch.distributed`` group, or as world size 1 without one.
"""

import argparse

import numpy as np

from repro_torch.core import PRNGKey, build_graph, correlation_cluster
from repro_torch.core.graph import random_arboric


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)
    n, lam = 2_000, 3
    edges, _ = random_arboric(n, lam, rng)
    g = build_graph(n, edges, device=dev)
    print(f"graph: n={n} m={g.m} (λ ≤ {lam} by construction)")

    # Corollary 28: degree-cap (Thm 26, ε=2) + PIVOT → 3-approx in
    # expectation
    res = correlation_cluster(g, method="pivot", lam=lam, key=PRNGKey(0),
                              device=dev)
    print(f"pivot        cost={res.cost}  high-degree singletons="
          f"{res.info['high_degree']}  depth={res.info['depth']}")

    # Same, with Algorithm 1's phase scheduling + MPC round ledger
    res = correlation_cluster(g, method="pivot_phased", lam=lam,
                              key=PRNGKey(0), device=dev)
    print(f"pivot_phased cost={res.cost}  MPC rounds="
          f"{res.info['mpc_rounds']:.0f}  ledger={res.info['ledger']}")

    # Corollary 32: deterministic O(λ²) in O(1) rounds
    res = correlation_cluster(g, method="cliques", device=dev)
    print(f"cliques      cost={res.cost}")

    # Distributed engine (edge-sharded over the torch.distributed group)
    res = correlation_cluster(g, method="pivot", lam=lam, key=PRNGKey(0),
                              distributed=True, device=dev)
    print(f"distributed  cost={res.cost}  rounds={res.info['depth']}")


if __name__ == "__main__":
    main()
