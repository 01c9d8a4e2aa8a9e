"""The serving facade, the counterpart of ``repro.gnn.serving``: train,
then answer requests.

    from repro_torch.gnn import serve, train
    from repro_torch.configs.gnn import GNNModelConfig, PlatformConfig

    cfg = GNNModelConfig("graphsage", fanouts=(10, 5), batch_targets=256)
    with train(cfg, PlatformConfig(), graph=g, epochs=5) as result:
        with serve(cfg, graph=g, params=result.params,
                   slo_ms=50.0, num_workers=2) as server:
            logits = server.predict([123, 456])          # synchronous
            fut = server.submit([789])                    # coalesced path
            print(fut.result(), server.stats()["p99_ms"])

The server runs on the card unless ``device="cpu"`` is given, and keeps
its own copy of the parameters there. It inherits the fault-tolerant host
substrate: sampler-worker respawn, straggler speculation, absolute fetch
deadlines, fault injection (``model_cfg.fault.fault_spec``) — a killed or
hung worker makes requests late, never wrong and never lost. See
:mod:`repro_torch.core.serving` for the runtime (bucket ladder, SLO
micro-batching, one CUDA graph a bucket).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.configs.gnn import GNNModelConfig
from repro_torch.core.serving import ServeConfig, ServingRuntime
from repro_torch.data.graphs import Graph

# re-exported for callers configuring the runtime directly
GNNServer = ServingRuntime


def serve(model_cfg: GNNModelConfig, *, graph: Graph, params=None,
          algorithm: str = "distdgl", slo_ms: float = 50.0,
          buckets: Optional[Sequence[int]] = None, num_workers: int = 0,
          fetch_timeout_s: float = 30.0, seed: int = 0,
          warmup: bool = True, device=None) -> ServingRuntime:
    """Stand up a request-driven inference server over ``graph``.

    ``params`` is a parameter tree — typically ``TrainResult.params``, or
    numpy arrays — or None to materialize a fresh (untrained) set from
    ``seed`` by the port's own init (``nn.param.init_params``), handy for
    latency benchmarking: those are not the reference's
    ``jax.random`` weights from the same seed. ``num_workers`` sizes the
    supervised sampler pool (0 = sample in-process; results are
    bit-identical either way). ``warmup=True`` builds every bucket's
    forward (on the card, captures its CUDA graph) before returning, so
    the first request never pays a capture; if the warm-up raises, the
    runtime is closed first. Close the returned server (or use it as a
    context manager) to stop the dispatcher and tear down the pool.
    """
    if algorithm not in ("distdgl", "pagraph", "p3"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if params is None:
        from repro_torch.gnn import models as gnn_models
        from repro_torch.nn.param import init_params
        spec = gnn_models.param_spec(model_cfg, graph.features.shape[1],
                                     graph.num_classes)
        params = init_params(spec, seed, "cpu")
    cfg = ServeConfig(slo_ms=slo_ms,
                      buckets=None if buckets is None else tuple(buckets),
                      num_workers=num_workers,
                      fetch_timeout_s=fetch_timeout_s)
    runtime = ServingRuntime(graph, model_cfg, params, algorithm=algorithm,
                             serve_cfg=cfg, seed=seed, device=device)
    if warmup:
        try:
            runtime.warmup()
        except BaseException:
            runtime.close()
            raise
    return runtime
