"""Tabulate graph-FL experiment sessions into ``exp.{txt,xlsx,json}``.

The port's copy of the JAX package's ``analysis/graph_exp_analyzer.py`` (reference:
``simulation_lib/analysis/graph_exp_analyzer.py:14-91``):
collects config fields, accuracy summaries, and the per-worker byte/edge/node
counters dumped in ``graph_worker_stat.json``, merges them into one row, and
appends to cumulative ``exp.txt`` (CSV), ``exp.xlsx``, ``exp.json`` tables.
Usage mirrors the reference: ``session_path=<dir> python -m
distributed_learning_simulator_tpu_torch.analysis.graph_exp_analyzer`` or
``analyze_graph_session(path)`` programmatically.
"""

import json
import os

import numpy as np

from .session import GraphSession


def _summarize_worker_counters(stats: dict[str, dict]) -> dict:
    """Merge per-worker counters: embedding/model byte totals pass through,
    ``*_edge_cnt``/``*_node_cnt`` become mean±std across workers, dict-valued
    counters (per-round byte maps) sum key-wise."""
    merged: dict = {}
    for _worker, data in stats.items():
        for key, value in data.items():
            if "cnt" not in key and "byte" not in key:
                continue
            if key in ("embedding_bytes", "model_bytes"):
                merged[key] = value
            elif "edge_cnt" in key or "node_cnt" in key:
                merged.setdefault(key, []).append(value)
            elif isinstance(value, dict):
                bucket = merged.setdefault(key, {})
                for sub_key, sub_value in value.items():
                    bucket[sub_key] = bucket.get(sub_key, 0) + sub_value
            else:
                merged[key] = merged.get(key, 0) + value
    for key, value in merged.items():
        if ("edge_cnt" in key or "node_cnt" in key) and isinstance(value, list):
            arr = np.asarray(value, dtype=np.float64)
            merged[key] = {
                "mean": float(arr.mean()),
                "std": float(arr.std(ddof=1)) if arr.size > 1 else 0.0,
            }
    return merged


def analyze_graph_session(session_path: str) -> dict:
    session = GraphSession(session_path)
    config = session.config or {}
    res: dict = {
        "exp_name": config.get("exp_name", ""),
        "distributed_algorithm": config.get("distributed_algorithm"),
        "dataset_name": config.get("dataset_name"),
        "model_name": config.get("model_name"),
        "round": config.get("round"),
        "worker_number": config.get("worker_number"),
    }
    res |= config.get("algorithm_kwargs", {}) or {}
    res |= config.get("extra_hyper_parameters", {}) or {}
    res["last_test_acc"] = session.last_test_acc
    res["mean_test_acc"] = session.mean_test_acc
    res |= _summarize_worker_counters(session.graph_worker_stats)
    res["performance"] = session.round_record
    return res


def write_exp_tables(rows: list[dict], output_dir: str = ".") -> None:
    """Append rows to the cumulative ``exp.txt``/``exp.xlsx``/``exp.json``
    tables (reference behavior: read-modify-write CSV, dicts as JSON strings)."""
    import pandas as pd

    rows = [
        {k: json.dumps(v) if isinstance(v, dict) else v for k, v in row.items()}
        for row in rows
    ]
    lead = [
        "distributed_algorithm",
        "dataset_name",
        "model_name",
        "last_test_acc",
        "mean_test_acc",
        "round",
        "worker_number",
    ]
    df = pd.DataFrame(rows)
    if "exp_name" in df.columns and df["exp_name"].any():
        lead = ["exp_name"] + lead
    cols = [c for c in lead if c in df.columns]
    cols += [c for c in df.columns if c not in cols]
    df = df[cols]
    txt_path = os.path.join(output_dir, "exp.txt")
    if os.path.isfile(txt_path):
        df = pd.concat([pd.read_csv(txt_path), df], ignore_index=True)
    df = df.drop_duplicates(ignore_index=True)
    df.to_csv(txt_path, index=False)
    try:
        df.to_excel(os.path.join(output_dir, "exp.xlsx"), index=False, sheet_name="result")
    except (ImportError, ModuleNotFoundError):  # openpyxl not in the image
        pass
    df.to_json(os.path.join(output_dir, "exp.json"))


if __name__ == "__main__":
    session_path = os.getenv("session_path", "").strip()
    assert session_path, "set session_path=<session dir>"
    write_exp_tables([analyze_graph_session(session_path)])
