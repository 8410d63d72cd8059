"""CLI: ``python -m distributed_learning_simulator_tpu_torch --config-name
fed_avg/cifar10.yaml ++fed_avg.model_name=vit_small ...`` (the JAX
package's ``simulator.py`` surface; ``++fed_avg.device=cpu`` runs on the
CPU)."""

import sys

from .config import load_config
from .training import train


def main(argv: list[str]) -> None:
    result = train(load_config(argv))
    print(result.get("performance", {}))


if __name__ == "__main__":
    main(sys.argv[1:])
