"""Batching, hyper-parameters, the hand-written SGD and the compute engine."""
