"""Forest (λ=1) special case: matchings ⇒ optimum correlation clustering.

    PYTHONPATH=src python -m repro_torch.examples.forest_clustering \\
        [--device cpu]

The port of ``examples/forest_clustering.py``.
"""

import argparse

import numpy as np

from repro_torch.core import (PRNGKey, build_graph, correlation_cluster,
                              matching_size, max_matching_forest)
from repro_torch.core.graph import random_forest


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(1)
    g = build_graph(5_000, random_forest(5_000, rng), device=dev)
    exact = correlation_cluster(g, method="forest_exact", device=dev)
    approx = correlation_cluster(g, method="forest_approx", key=PRNGKey(0),
                                 device=dev)
    m_star = matching_size(max_matching_forest(g))
    print(f"forest n=5000 m={g.m}, max matching = {m_star}")
    print(f"exact   cost={exact.cost}  (= m − |M*| = {g.m - m_star})")
    print(f"approx  cost={approx.cost}  ratio="
          f"{approx.cost / max(1, exact.cost):.4f}  "
          f"rounds={approx.info['rounds']}")


if __name__ == "__main__":
    main()
