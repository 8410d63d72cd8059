"""Core enums (the port's copy of ``distributed_learning_simulator_tpu.ml_type``)."""

import enum


class MachineLearningPhase(enum.StrEnum):
    Training = "training"
    Validation = "validation"
    Test = "test"
