"""Aggregate per-round metrics across sessions
(reference ``simulation_lib/analysis/analyze_round.py:16-69``: seaborn line
plots per metric; plotting here is optional — the tabulation is the core)."""

import os
from collections import defaultdict

from .session import find_sessions


def collect_round_metrics(root: str) -> dict[str, dict[int, list[float]]]:
    """metric name -> round -> values across sessions."""
    table: dict[str, dict[int, list[float]]] = defaultdict(lambda: defaultdict(list))
    for session in find_sessions(root):
        for round_number, stats in session.round_record.items():
            for metric, value in stats.items():
                table[metric][round_number].append(value)
    return {k: dict(v) for k, v in table.items()}


def plot_round_metrics(root: str, out_dir: str, table=None) -> list[str]:
    """Write one PNG per metric if matplotlib is available.  Pass ``table``
    (from :func:`collect_round_metrics`) to avoid re-walking the root."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # plotting is optional
        return []
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if table is None:
        table = collect_round_metrics(root)
    for metric, rounds in table.items():
        xs = sorted(rounds)
        means = [sum(rounds[x]) / len(rounds[x]) for x in xs]
        fig, ax = plt.subplots()
        ax.plot(xs, means, marker="o")
        ax.set_xlabel("round")
        ax.set_ylabel(metric)
        path = os.path.join(out_dir, f"{metric}.png")
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None) -> None:
    """CLI: tabulate (and optionally plot) per-round metrics across the
    sessions under a root directory (reference usage: run as a script over
    ``session/``)."""
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("root", help="session root (e.g. session/fed_avg)")
    parser.add_argument("--plot-dir", default="", help="write one PNG per metric")
    args = parser.parse_args(argv)
    table = collect_round_metrics(args.root)
    print(
        json.dumps(
            {
                metric: {str(r): vals for r, vals in rounds.items()}
                for metric, rounds in table.items()
            },
            indent=1,
        )
    )
    if args.plot_dir:
        for path in plot_round_metrics(args.root, args.plot_dir, table=table):
            print("wrote", path)


if __name__ == "__main__":
    main()
