"""CLI: ``python -m distributed_learning_simulator_tpu_torch --config-name
fed_avg/cifar10.yaml ++fed_avg.model_name=vit_small ...`` (the JAX
package's ``simulator.py`` surface; ``++fed_avg.device=cpu`` runs on the
CPU).  A config with ``fault_tolerance.auto_resume`` runs under
:func:`~.training.train_with_recovery`, as the JAX package's CLI runs it."""

import sys

from .config import load_config
from .training import train, train_with_recovery


def main(argv: list[str]) -> None:
    config = load_config(argv)
    if dict(config.fault_tolerance or {}).get("auto_resume"):
        result = train_with_recovery(config)
    else:
        result = train(config)
    print(result.get("performance", {}))


if __name__ == "__main__":
    main(sys.argv[1:])
