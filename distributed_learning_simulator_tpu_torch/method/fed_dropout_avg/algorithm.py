"""FedDropoutAvg's aggregation: an element's weight is the dataset size
where the upload sent it (its value is not 0), and an element no upload
sent becomes 0 (the total weight taken as 1 there).  The weights are one
an element of the upload's flat vector (``FedAVGAlgorithm``)."""

import torch

from ...algorithm.fed_avg_algorithm import FedAVGAlgorithm


class FedDropoutAvgAlgorithm(FedAVGAlgorithm):
    def _get_weight(self, dataset_size: int, vec: torch.Tensor) -> torch.Tensor:
        return (vec != 0).to(torch.float32) * dataset_size

    def _apply_total_weight(self, vec: torch.Tensor, total_weight) -> torch.Tensor:
        total_weight = torch.where(total_weight == 0, 1.0, total_weight)
        return super()._apply_total_weight(vec, total_weight)
