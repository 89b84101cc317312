"""The fleet plane over ``DecodeEngine`` (port of ``paddle_tpu/serving``):
everything that only exists BETWEEN engines.

- :mod:`router` — ``FleetRouter``: health-gated, session-affine,
  least-loaded dispatch over N replicas with chunked
  retry-with-failover: an engine that dies mid-generation is replayed
  on a healthy replica with its emitted tokens folded into the prompt.
  ``DecodeEngineServer`` is the per-engine HTTP surface
  (healthz/readyz/stats/metrics/generate/adopt), ``HTTPReplica`` its
  client, ``FleetSLOSignal`` the per-engine burn rates federated into
  the router's shed/scale signal.
- :mod:`disagg` — prefill/decode disaggregation: ``PrefillWorker``
  computes prompt KV with the dense forward on the card and ships FULL
  pages as int8 page frames; a decode engine adopts them through
  ``DecodeEngine.adopt_pages``, with the prefix-cache keys re-derived
  from the frame's tokens. ``MigrationClient`` wraps the ship in a
  deadline and bounded retries, with a local-prefill degrade leg.

Quickstart (two engines on the card, one router)::

    from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                                   DecodeModelConfig,
                                                   init_decode_params)
    from paddle_tpu_torch.serving import DecodeEngineServer, FleetRouter

    cfg = DecodeModelConfig()
    params = init_decode_params(cfg, seed=11)      # shared weights
    engines = [DecodeEngine(cfg, params=params, kv_codec="int8")
               for _ in range(2)]
    for e in engines:
        e.warm()
        e.start()
    router = FleetRouter(engines, chunk_tokens=8)  # in-process replicas
    tokens = router.generate([1, 2, 3], max_new_tokens=32)

    # or remote: DecodeEngineServer(engine, port=8101).start() per
    # process, then FleetRouter([HTTPReplica("127.0.0.1:8101"), ...])
"""
from .disagg import (FRAME_MAGIC, FRAME_VERSION, MalformedPageFrame,
                     MigrationClient, PageFrame, PrefillShipment,
                     PrefillWorker, decode_frame, encode_frame,
                     migration_cost, quantize_rows)
from .router import (DecodeEngineServer, FleetRouter, FleetSLOSignal,
                     HTTPReplica, LocalReplica, ReplicaUnroutable)

__all__ = [
    "DecodeEngineServer", "FleetRouter", "FleetSLOSignal", "HTTPReplica",
    "LocalReplica", "ReplicaUnroutable",
    "FRAME_MAGIC", "FRAME_VERSION", "MalformedPageFrame", "MigrationClient",
    "PageFrame", "PrefillShipment", "PrefillWorker", "decode_frame",
    "encode_frame", "migration_cost", "quantize_rows",
]
