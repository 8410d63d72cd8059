"""The graph FL server (the port's copy of the JAX package's
``server/graph_server.py``)."""

from typing import Any

from ..algorithm.graph_algorithm import GraphNodeEmbeddingPassingAlgorithm
from .aggregation_server import AggregationServer


class GraphNodeServer(AggregationServer):
    #: the exchanges interleave messages a buffered flush cannot hold back
    _buffered_capable = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("algorithm", GraphNodeEmbeddingPassingAlgorithm())
        super().__init__(**kwargs)
