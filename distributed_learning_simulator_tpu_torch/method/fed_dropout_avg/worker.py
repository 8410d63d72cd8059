"""The FedDropoutAvg client: before each upload every element of its
parameters is zeroed with probability ``dropout_rate``.  The keep draws
are the FedDropoutAvg session's for the round's reserved
:class:`~...ops.quantization.SessionKey` (``CodecRandom.dropout_uniform``
of the link's random source, leaf by leaf in the JAX package's key order
and layout), so the two executors drop the same elements.  The count of
sent values is logged (``send_num`` / ``total_num``) for the analysis's
cost model."""

from typing import Any

import numpy as np
import torch

from ...message import ParameterMessage
from ...models.convert import jax_leaves
from ...utils.logging import get_logger
from ...worker.aggregation_worker import AggregationWorker


class FedDropoutAvgWorker(AggregationWorker):
    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._dropout_rate = float(self.config.algorithm_kwargs["dropout_rate"])
        self._send_parameter_diff = False

    def _get_sent_data(self) -> ParameterMessage:
        sent_data = super()._get_sent_data()
        assert isinstance(sent_data, ParameterMessage)
        key = self.trainer.reserved_quant_key  # every round of this role is armed
        layout = self.trainer.engine.layout
        vec = layout.flatten(sent_data.parameter)  # a copy: the kept best model stays whole
        # the keep probability as JAX's bernoulli compares it: an f32
        keep_prob = torch.tensor(np.float32(1.0 - self._dropout_rate), device=vec.device)
        leaves = jax_leaves(layout.keys, layout.shapes)
        for i, leaf in enumerate(leaves):
            uniform = self._endpoint.random.dropout_uniform(
                key.seed, key.aggregate, key.slot, i, len(leaves), (leaf.size,), vec.device
            )
            vec[leaf.start : leaf.stop].mul_(leaf.from_jax((uniform.to(vec.device) < keep_prob).to(torch.float32)))
        get_logger().info("send_num %s", int(torch.count_nonzero(vec)))
        get_logger().info("total_num %s", vec.numel())
        sent_data.parameter = layout.split(vec)
        return sent_data
