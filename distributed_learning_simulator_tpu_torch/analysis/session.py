"""Session-directory loaders.

The port's copy of the JAX package's ``analysis/session.py`` (reference:
``simulation_lib/analysis/session.py:9-63``): load a
run's artifacts — ``round_record.json``, ``config.json``, per-worker
``hyper_parameter.json`` / ``graph_worker_stat.json`` — with cached summary
properties.
"""

import functools
import json
import os


class Session:
    def __init__(self, session_dir: str) -> None:
        self.session_dir = session_dir

    def _load_json(self, *parts) -> dict | None:
        path = os.path.join(self.session_dir, *parts)
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf8") as f:
            return json.load(f)

    @functools.cached_property
    def config(self) -> dict | None:
        return self._load_json("server", "config.json")

    @functools.cached_property
    def round_record(self) -> dict:
        record = self._load_json("server", "round_record.json") or {}
        return {int(k): v for k, v in record.items()}

    @functools.cached_property
    def worker_dirs(self) -> list[str]:
        return sorted(
            os.path.join(self.session_dir, d)
            for d in os.listdir(self.session_dir)
            if d.startswith("worker")
        )

    @functools.cached_property
    def hyper_parameters(self) -> dict[str, dict]:
        out = {}
        for worker_dir in self.worker_dirs:
            path = os.path.join(worker_dir, "hyper_parameter.json")
            if os.path.isfile(path):
                with open(path, encoding="utf8") as f:
                    out[os.path.basename(worker_dir)] = json.load(f)
        return out

    @property
    def last_test_acc(self) -> float | None:
        if not self.round_record:
            return None
        return self.round_record[max(self.round_record)]["test_accuracy"]

    @property
    def mean_test_acc(self) -> float | None:
        if not self.round_record:
            return None
        accs = [v["test_accuracy"] for v in self.round_record.values()]
        return sum(accs) / len(accs)

    @functools.cached_property
    def shapley_values(self) -> dict | None:
        return self._load_json("shapley_values.json")


class GraphSession(Session):
    @functools.cached_property
    def graph_worker_stats(self) -> dict[str, dict]:
        out = {}
        for worker_dir in self.worker_dirs:
            path = os.path.join(worker_dir, "graph_worker_stat.json")
            if os.path.isfile(path):
                with open(path, encoding="utf8") as f:
                    out[os.path.basename(worker_dir)] = json.load(f)
        return out

    @property
    def total_communicated_bytes(self) -> int:
        return sum(
            s.get("communicated_bytes", 0) for s in self.graph_worker_stats.values()
        )


def find_sessions(root: str) -> list[Session]:
    sessions = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if os.path.basename(dirpath) == "server" and "round_record.json" in filenames:
            sessions.append(Session(os.path.dirname(dirpath)))
    return sessions
