"""Continuous-batching serving subsystem (engine, scheduler, sampling,
metrics, deterministic simulation, serving sentinel): the JAX package's
numpy host loop, copied, over the PyTorch `ModelExecutor`. See engine.py
for the architecture."""
from repro_torch.serve.engine import (EngineAbort, EngineStuck, FaultPolicy,
                                      GenResult, ModelExecutor, ServeEngine)
from repro_torch.serve.metrics import MetricsCollector
from repro_torch.serve.sampling import (NonFiniteLogits, SamplingParams,
                                        is_finished, sample_token)
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.simulate import (SimClock, SimCost, SimExecutor,
                                        poisson_arrivals)

__all__ = [
    "EngineAbort", "EngineStuck", "FaultPolicy", "GenResult",
    "ModelExecutor", "ServeEngine", "MetricsCollector", "NonFiniteLogits",
    "SamplingParams", "is_finished", "sample_token", "Request", "Scheduler",
    "SimClock", "SimCost", "SimExecutor", "poisson_arrivals",
]
