from .engine import ContinuousBatchingEngine, PagePool, Request  # noqa: F401
