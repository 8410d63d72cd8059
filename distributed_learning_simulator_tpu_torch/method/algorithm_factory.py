"""The algorithm registry of the threaded executor (the port's copy of the
JAX package's ``method/algorithm_factory.py``): ``register_algorithm``
names a method's client, server, endpoint classes and aggregation
algorithm; ``create_client`` / ``create_server`` build the endpoint and
then the role.  Registered by ``method/``: ``fed_avg``, ``fed_paq``,
``fed_obd``, ``fed_obd_sq``, ``fed_dropout_avg``, ``single_model_afd`` and
``sign_SGD``."""

import dataclasses
from typing import Any

from ..topology.central_topology import CentralTopology, ClientEndpoint, ServerEndpoint


@dataclasses.dataclass
class _Registration:
    algorithm_name: str
    client_cls: type
    server_cls: type
    client_endpoint_cls: type
    server_endpoint_cls: type
    algorithm_cls: type | None


class CentralizedAlgorithmFactory:
    config: dict[str, _Registration] = {}

    @classmethod
    def register_algorithm(
        cls,
        algorithm_name: str,
        client_cls: type,
        server_cls: type,
        client_endpoint_cls: type = ClientEndpoint,
        server_endpoint_cls: type = ServerEndpoint,
        algorithm_cls: type | None = None,
    ) -> None:
        assert algorithm_name not in cls.config, f"duplicate algorithm {algorithm_name}"
        cls.config[algorithm_name] = _Registration(
            algorithm_name, client_cls, server_cls, client_endpoint_cls, server_endpoint_cls, algorithm_cls
        )

    @classmethod
    def has_algorithm(cls, algorithm_name: str) -> bool:
        return algorithm_name in cls.config

    @classmethod
    def create_client(cls, algorithm_name: str, topology: CentralTopology, worker_id: int,
                      endpoint_kwargs: dict | None = None, kwargs: dict | None = None) -> Any:
        reg = cls.config[algorithm_name]
        endpoint = reg.client_endpoint_cls(topology, worker_id, **(endpoint_kwargs or {}))
        return reg.client_cls(endpoint=endpoint, **(kwargs or {}))

    @classmethod
    def create_server(cls, algorithm_name: str, topology: CentralTopology,
                      endpoint_kwargs: dict | None = None, kwargs: dict | None = None) -> Any:
        reg = cls.config[algorithm_name]
        endpoint = reg.server_endpoint_cls(topology, **(endpoint_kwargs or {}))
        kwargs = dict(kwargs or {})
        if reg.algorithm_cls is not None and "algorithm" not in kwargs:
            kwargs["algorithm"] = reg.algorithm_cls()
        return reg.server_cls(endpoint=endpoint, **kwargs)
