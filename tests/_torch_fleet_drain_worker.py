"""Worker for the fleet SIGTERM graceful-drain test
(tests/test_torch_fleet.py), on the port alone: two tiny decode engines
on the CPU behind a ``FleetRouter``, a batch of routed requests in
flight, then SIGTERM to ITSELF. ``install_sigterm_drain`` takes the
router duck-typed (it only needs ``drain(timeout=...)``): the handler
must stop router admission, flush every in-flight request through the
replicas, report how many completed, and exit 0 — the parent asserts
rc 0, zero lost requests and a flight-recorder dump."""
import os
import signal
import sys
import time

import numpy as np


def main():
    from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                                   DecodeModelConfig)
    from paddle_tpu_torch.inference.serving import install_sigterm_drain
    from paddle_tpu_torch.serving import FleetRouter

    n_requests = int(os.environ.get("DRAIN_REQUESTS", "8"))
    cfg = DecodeModelConfig(vocab_size=32, n_layers=1, n_heads=2,
                            head_dim=8, ffn_dim=32, max_context=32)
    engines = []
    for _ in range(2):
        e = DecodeEngine(cfg, seed=5, n_pages=16, page_size=8,
                         max_pages_per_seq=4, device="cpu")
        e.warm()
        e.start()
        engines.append(e)
    router = FleetRouter(engines, chunk_tokens=4)

    handles = []
    for i in range(n_requests):
        rng = np.random.RandomState(i)
        prompt = [int(t) for t in rng.randint(0, 32, size=4)]
        handles.append(router.submit(prompt, max_new_tokens=4,
                                     session=f"s{i}"))

    def report():
        # runs in the drain thread AFTER router.drain(): every admitted
        # request must be resolved — a value counts as kept, a typed
        # failure as lost
        done = sum(1 for h in handles if h.done())
        ok = sum(1 for h in handles
                 if h.done() and h.error() is None)
        print(f"DRAINED done={done} ok={ok} total={n_requests}",
              flush=True)

    install_sigterm_drain(router, on_drained=report, exit_code=0)
    os.kill(os.getpid(), signal.SIGTERM)
    # unreachable when the handler exits; bounded so a broken handler
    # fails the test on its exit code, not by a hang
    time.sleep(30)
    print("HANDLER DID NOT EXIT", flush=True)
    sys.exit(3)


if __name__ == "__main__":
    main()
