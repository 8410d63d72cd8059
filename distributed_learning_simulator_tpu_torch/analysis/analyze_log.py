"""Communication-cost analysis.

The port's copy of the JAX package's ``analysis/analyze_log.py`` (reference:
``simulation_lib/analysis/analyze_log.py:14-279``):
per-algorithm closed-form message counts and byte totals, with the
fed_obd / fed_dropout_avg / single_model_afd variants discounted by logged
compression ratios and send counts.  Works from a session directory plus a
parameter count (the reference scraped run logs with regexes; runs here log
the same quantities, and the closed forms are exposed directly).
"""

import dataclasses
import re


@dataclasses.dataclass
class CommunicationCostModel:
    parameter_count: int
    worker_number: int
    rounds: int
    dtype_bytes: int = 4

    def fed_avg_bytes(self, selected_per_round: int | None = None) -> int:
        """Down + up full-parameter transfer per selected client per round,
        plus the initial distribution (reference closed form,
        ``analyze_log.py:69-107``)."""
        clients = selected_per_round or self.worker_number
        msg_num = 2 * self.rounds * clients + self.worker_number
        return self.parameter_count * self.dtype_bytes * msg_num

    def fed_paq_bytes(self, quant_bytes: float = 1.0, selected_per_round=None) -> int:
        clients = selected_per_round or self.worker_number
        up = self.rounds * clients * self.parameter_count * quant_bytes
        down = (self.rounds * clients + self.worker_number) * (
            self.parameter_count * self.dtype_bytes
        )
        return int(up + down)

    def fed_obd_bytes(
        self,
        dropout_rate: float,
        compression_ratios: list[float],
        selected_per_round=None,
        second_phase_msgs: int = 0,
    ) -> int:
        """Phase-1 uploads carry (1-dropout) of the params through the NNADQ
        codec; broadcasts are quantized too (reference ``analyze_log.py:109-151``)."""
        clients = selected_per_round or self.worker_number
        mean_ratio = (
            sum(compression_ratios) / len(compression_ratios)
            if compression_ratios
            else 1.0
        )
        per_upload = self.parameter_count * self.dtype_bytes * mean_ratio * (
            1.0 - dropout_rate
        )
        per_broadcast = self.parameter_count * self.dtype_bytes * mean_ratio
        total = self.rounds * clients * (per_upload + per_broadcast)
        total += self.worker_number * self.parameter_count * self.dtype_bytes  # init
        total += second_phase_msgs * per_broadcast
        return int(total)

    def send_num_bytes(self, send_nums: list[int]) -> int:
        """fed_dropout_avg / single_model_afd: logged per-upload element
        counts (reference ``analyze_log.py:191-209``)."""
        down = self.rounds * self.worker_number * self.parameter_count
        return int((sum(send_nums) + down) * self.dtype_bytes)


_SEND_NUM_RE = re.compile(r"send_num (\d+)")
_RATIO_RE = re.compile(r"compression ratio: ([0-9.]+)")
_PERCENT_RE = re.compile(r"[0-9.]+%")
_FRACTION_ACC_RE = re.compile(r"test accuracy ([0-9.]+)")
_WORKER_ACC_RE = re.compile(r"\bacc ([0-9.]+)")


def _mean_std(values: list[float]) -> tuple[float, float]:
    mean = sum(values) / len(values)
    # sample std (n-1), matching the reference's torch.std_mean default
    if len(values) < 2:
        return mean, float("nan")
    var = sum((v - mean) ** 2 for v in values) / (len(values) - 1)
    return mean, var**0.5


def _acc_from_line(line: str) -> float | None:
    """Accuracy from one log line, normalized to PERCENT scale (the
    reference's printed unit): its percent spelling (``accuracy ...
    85.3%``), this framework's fraction spellings (``test accuracy 0.853``,
    worker lines ``acc 0.9876``) — mixing reference and framework run logs
    in one sweep stays dimensionally sane."""
    percents = _PERCENT_RE.findall(line)
    if len(percents) == 1:
        return float(percents[0].rstrip("%"))
    if m := _FRACTION_ACC_RE.search(line):
        return float(m.group(1)) * 100.0
    if m := _WORKER_ACC_RE.search(line):
        return float(m.group(1)) * 100.0
    return None


def _is_final_acc_line(line: str, distributed_algorithm: str, rounds: int) -> bool:
    """The per-algorithm regex families of the reference's ``compute_acc``
    (``analysis/analyze_log.py:22-51``), extended to this framework's log
    spelling."""
    if distributed_algorithm == "sign_SGD":
        return "test loss" in line or "test accuracy" in line
    if distributed_algorithm in ("fed_obd_first_stage", "fed_obd_layer"):
        # \b-anchored: 'round: 2' must not substring-match 'round: 25'
        return (
            ("test in" in line or "test accuracy" in line)
            and "accuracy" in line
            and re.search(rf"round: {rounds}\b", line) is not None
        )
    return ("test in" in line and "accuracy" in line) or "test accuracy" in line


def compute_acc(
    paths: list[str],
    distributed_algorithm: str = "",
    worker_number: int = 0,
    rounds: int = 0,
) -> dict:
    """Multi-run final-accuracy scrape (reference ``compute_acc``,
    ``analysis/analyze_log.py:14-66``): the LAST matching test-accuracy line
    of each run log, per-algorithm regex family, mean ± std across runs,
    plus each worker's last train accuracy.  Prints the reference's
    ``test acc <mean> <std>`` line and returns the numbers."""
    final_test_acc: list[float] = []
    worker_acc: dict[int, list[float]] = {}
    for path in paths:
        with open(path, encoding="utf8", errors="replace") as f:
            lines = f.readlines()
        for line in reversed(lines):
            if _is_final_acc_line(line, distributed_algorithm, rounds):
                acc = _acc_from_line(line)
                if acc is not None:
                    final_test_acc.append(acc)
                    break
        for worker_id in range(worker_number):
            # \b stops 'worker 1' from prefix-matching 'worker 10'; both the
            # reference's 'worker N ... train ... accuracy P%' and this
            # framework's 'worker N epoch E loss L acc F' spellings match
            pattern = re.compile(
                rf"worker {worker_id}\b.*(train.*accuracy|\bacc )"
            )
            for line in reversed(lines):
                if pattern.search(line):
                    acc = _acc_from_line(line)
                    if acc is not None:
                        worker_acc.setdefault(worker_id, []).append(acc)
                        break
    result: dict = {"final_test_acc": final_test_acc, "worker_acc": worker_acc}
    if final_test_acc:
        mean, std = _mean_std(final_test_acc)
        result["mean"], result["std"] = mean, std
        print("test acc", round(mean, 2), round(std, 2) if std == std else 0.0)
    return result


def compute_data_amount(
    paths: list[str],
    *,
    distributed_algorithm: str,
    parameter_count: int,
    worker_number: int,
    rounds: int,
    algorithm_kwargs: dict | None = None,
    dtype_bytes: int = 4,
) -> dict:
    """Per-algorithm communicated-data totals (reference
    ``compute_data_amount``, ``analysis/analyze_log.py:69-279``): closed
    forms for fed_avg / fed_paq / fed_obd_sq, log-scraped compression
    ratios for fed_obd, log-scraped ``send_num`` counts for
    fed_dropout_avg / single_model_afd.  Returns the reference's
    ``{"msg_num": int, "data_amount": MB | {"mean", "std"}}`` shape."""
    algorithm_kwargs = algorithm_kwargs or {}
    model = CommunicationCostModel(
        parameter_count=parameter_count,
        worker_number=worker_number,
        rounds=rounds,
        dtype_bytes=dtype_bytes,
    )
    selected = algorithm_kwargs.get("random_client_number") or worker_number
    mib = 1024 * 1024
    uploaded_msgs = rounds * selected
    msg_num = 2 * uploaded_msgs + worker_number
    data_amount: float | dict = 0.0
    algo = distributed_algorithm
    if algo == "fed_avg":
        data_amount = model.fed_avg_bytes(selected) / mib
    elif algo == "fed_paq":
        data_amount = model.fed_paq_bytes(selected_per_round=selected) / mib
    elif algo == "fed_obd_sq":
        second = int(algorithm_kwargs.get("second_phase_epoch", 0))
        msg_num += second * worker_number * 2
        data_amount = (
            model.fed_obd_bytes(
                dropout_rate=float(algorithm_kwargs.get("dropout_rate", 0.0)),
                compression_ratios=[],  # QSGD: no logged NNADQ ratio
                selected_per_round=selected,
                second_phase_msgs=second * worker_number * 2,
            )
            / mib
        )
    elif algo in ("fed_obd", "fed_obd_first_stage"):
        second = int(algorithm_kwargs.get("second_phase_epoch", 0))
        msg_num += second * worker_number * 2
        amounts = []
        for path in paths:
            ratios = scrape_log(path)["compression_ratios"]
            amounts.append(
                model.fed_obd_bytes(
                    dropout_rate=float(algorithm_kwargs.get("dropout_rate", 0.0)),
                    compression_ratios=ratios,
                    selected_per_round=selected,
                    second_phase_msgs=second * worker_number * 2,
                )
                / mib
            )
        mean, std = _mean_std(amounts)
        data_amount = {"mean": round(mean, 2), "std": round(std, 2) if std == std else 0.0}
    elif algo in ("fed_dropout_avg", "single_model_afd"):
        amounts = []
        for path in paths:
            send_nums = scrape_log(path)["send_nums"]
            amounts.append(model.send_num_bytes(send_nums) / mib)
        mean, std = _mean_std(amounts)
        data_amount = {"mean": round(mean, 2), "std": round(std, 2) if std == std else 0.0}
    else:
        raise ValueError(f"no cost model for {distributed_algorithm!r}")
    if isinstance(data_amount, float):
        data_amount = round(data_amount, 2)
    return {"msg_num": msg_num, "data_amount": data_amount}


def scrape_log(path: str) -> dict:
    """Scrape a run log for send counts and compression ratios (the same
    quantities the reference's regex scraper extracts)."""
    send_nums: list[int] = []
    ratios: list[float] = []
    with open(path, encoding="utf8", errors="replace") as f:
        for line in f:
            if m := _SEND_NUM_RE.search(line):
                send_nums.append(int(m.group(1)))
            if m := _RATIO_RE.search(line):
                ratios.append(float(m.group(1)))
    return {"send_nums": send_nums, "compression_ratios": ratios}


def main(argv=None) -> None:
    """CLI: final/mean test accuracy across the sessions under a root, plus
    scraped send counts / compression ratios from their logs (the reference
    script's summary surface, ``analyze_log.py:14-66``)."""
    import argparse
    import json
    import os

    from .session import find_sessions

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("root", help="session root (e.g. session/fed_avg)")
    parser.add_argument(
        "--logfiles",
        nargs="*",
        default=None,
        help="explicit run logs for the multi-run accuracy scrape "
        "(reference invocation: logfiles=<paths> analyze_log)",
    )
    parser.add_argument("--algorithm", default="", help="per-algorithm regex family")
    parser.add_argument("--worker-number", type=int, default=0)
    parser.add_argument("--round", type=int, default=0, dest="rounds")
    args = parser.parse_args(argv)
    logfiles = args.logfiles
    if logfiles is None and os.getenv("logfiles"):
        logfiles = os.getenv("logfiles").split()  # reference CLI surface
    if logfiles:
        compute_acc(
            logfiles,
            distributed_algorithm=args.algorithm,
            worker_number=args.worker_number,
            rounds=args.rounds,
        )
    accs = []
    summary: dict = {"sessions": []}
    for session in find_sessions(args.root):
        entry: dict = {"path": session.session_dir}
        if session.last_test_acc is not None:
            entry["last_test_acc"] = session.last_test_acc
            accs.append(session.last_test_acc)
        # run logs live either under <session>/log/ or at the cwd-relative
        # path recorded in the session's config (config.py derives
        # ``log/<save_dir with separators flattened>.log``)
        candidates: list[str] = []
        log_dir = os.path.join(session.session_dir, "log")
        if os.path.isdir(log_dir):
            candidates += [os.path.join(log_dir, n) for n in sorted(os.listdir(log_dir))]
        config_log = (session.config or {}).get("log_file", "")
        if config_log:
            candidates.append(config_log)
        scraped: dict[str, list] = {"send_nums": [], "compression_ratios": []}
        for candidate in candidates:
            if os.path.isfile(candidate):
                for key, values in scrape_log(candidate).items():
                    scraped[key].extend(values)  # merge across files
        entry.update(scraped)
        summary["sessions"].append(entry)
    if accs:
        mean = sum(accs) / len(accs)
        std = (sum((a - mean) ** 2 for a in accs) / len(accs)) ** 0.5
        summary["final_test_acc_mean"] = mean
        summary["final_test_acc_std"] = std
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
