"""Core enums and exceptions (the port's copy of
``distributed_learning_simulator_tpu.ml_type``)."""

import enum


class MachineLearningPhase(enum.StrEnum):
    Training = "training"
    Validation = "validation"
    Test = "test"


class ExecutorHookPoint(enum.StrEnum):
    """Hook points fired by the threaded executor's trainer."""

    BEFORE_EXECUTE = "before_execute"
    BEFORE_EPOCH = "before_epoch"
    BEFORE_BATCH = "before_batch"
    AFTER_BATCH = "after_batch"
    OPTIMIZER_STEP = "optimizer_step"
    AFTER_EPOCH = "after_epoch"
    AFTER_EXECUTE = "after_execute"


class StopExecutingException(Exception):
    """Raised by a hook to stop the trainer."""


class TaskAbortedError(Exception):
    """Another executor of the task failed; unwind this thread."""
