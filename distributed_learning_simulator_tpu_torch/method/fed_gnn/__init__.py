"""Federated GNN with boundary-embedding sharing on the threaded executor:
``fed_gnn``, and ``fed_gcn``, whose worker forces ``share_feature`` on."""

from ...server.graph_server import GraphNodeServer
from ...worker.graph_worker import GraphWorker
from ..algorithm_factory import CentralizedAlgorithmFactory


class FedGCNWorker(GraphWorker):
    def __init__(self, **kwargs) -> None:
        super().__init__(**kwargs)
        self._share_feature = True


CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_gnn", client_cls=GraphWorker, server_cls=GraphNodeServer
)
CentralizedAlgorithmFactory.register_algorithm(
    algorithm_name="fed_gcn", client_cls=FedGCNWorker, server_cls=GraphNodeServer
)
