"""Data-pipeline integration: near-dedup a corpus with Algorithm 4 + PIVOT.

    PYTHONPATH=src python -m repro_torch.examples.dedup_pipeline \\
        [--device cpu]

The port of ``examples/dedup_pipeline.py``.
"""

import argparse

from repro_torch.data.dedup import dedup_corpus, dedup_quality
from repro_torch.data.synthetic import synthetic_corpus, token_stream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    corpus = synthetic_corpus(n_docs=200, dup_fraction=0.4, mutate_p=0.05,
                              seed=0)
    res = dedup_corpus(corpus, threshold=0.45, device=args.device)
    q = dedup_quality(res, corpus)
    print(f"similarity graph edges: {res.n_edges}")
    print(f"clusters: {q['clusters']}  kept: {q['kept_fraction']:.1%} of docs")
    print(f"pairs precision {q['pairs_precision']:.3f} / "
          f"recall {q['pairs_recall']:.3f}")
    stream = token_stream(corpus, keep=res.keep)
    print(f"training stream: {len(stream)} tokens after dedup "
          f"(vs {len(token_stream(corpus))} raw)")


if __name__ == "__main__":
    main()
