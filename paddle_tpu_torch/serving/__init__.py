"""The fleet plane over ``DecodeEngine`` (port of ``paddle_tpu/serving``):
prefill/decode disaggregation (:mod:`.disagg`). ``PrefillWorker``
computes prompt KV with the dense forward on the card and ships FULL
pages as int8 page frames; a decode engine adopts them through
``DecodeEngine.adopt_pages``, with the prefix-cache keys re-derived from
the frame's tokens. ``MigrationClient`` wraps the ship in a deadline
and bounded retries, with a local-prefill degrade leg. The router
(``serving/router.py`` in the reference) is a later port slice."""
from .disagg import (FRAME_MAGIC, FRAME_VERSION, MalformedPageFrame,
                     MigrationClient, PageFrame, PrefillShipment,
                     PrefillWorker, decode_frame, encode_frame,
                     migration_cost, quantize_rows)

__all__ = [
    "FRAME_MAGIC", "FRAME_VERSION", "MalformedPageFrame", "MigrationClient",
    "PageFrame", "PrefillShipment", "PrefillWorker", "decode_frame",
    "encode_frame", "migration_cost", "quantize_rows",
]
