"""The serve daemon of the port: one long-running process on the CUDA
card that coalesces concurrent requests into batched passes on the
hand-written kernels (the counterpart of the JAX package's serve/).

  batcher.py    MicroBatcher / ContinuousBatcher: coalescing, the 429
                admission bound, deadlines, poison bisection, the
                hung-dispatch watchdog (a copy)
  executors.py  the six executors on the port's commands; a burst of
                /v1/depth requests is one launch of the depth kernel's
                batch axis a region
  server.py     ServeApp, the HTTP handler, make_server, ServerThread
  warmstart.py  replay a warmup manifest's launch geometries
  client.py     ServeClient, stdlib urllib (a copy)
  metrics.py    request, batch and cache counters, latency histograms,
                SLO gauges (a copy)
  flight.py     the flight recorder of recent span trees (a copy)

Entry point: ``python -m goleft_tpu_torch serve`` (commands/serve.py).
"""
