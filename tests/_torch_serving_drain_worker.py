"""Worker for the SIGTERM graceful-drain test (tests/test_torch_serving.py),
on the port alone: saves a tiny inference blob with the port's static
graph, starts the continuous-batching engine on the CPU, queues a batch
of requests, then SIGTERMs ITSELF. The ``install_sigterm_drain`` handler
must stop admission, flush every queued/in-flight request, report how
many completed, and exit 0 — the parent asserts rc 0 and zero lost
requests."""
import os
import signal
import sys
import tempfile
import time

import numpy as np


def main():
    import paddle_tpu_torch.static as static
    from paddle_tpu_torch.inference.serving import (AnalysisPredictor,
                                                    ServingEngine,
                                                    install_sigterm_drain)

    n_requests = int(os.environ.get("DRAIN_REQUESTS", "12"))
    with tempfile.TemporaryDirectory() as tmp:
        main_p, startup = static.Program(), static.Program()
        with static.program_guard(main_p, startup):
            x = static.data("x", [-1, 8])
            h = static.nn.fc(x, 16, act="relu")
            out = static.nn.fc(h, 3)
        exe = static.Executor(static.CPUPlace())
        scope = static.Scope()
        with static.scope_guard(scope):
            exe.run(startup)
            blob = os.path.join(tmp, "blob")
            static.save_inference_model(blob, ["x"], [out], exe, main_p)

        predictor = AnalysisPredictor(blob, batch_buckets=(1, 2, 4),
                                      device="cpu")
        predictor.warm()
        engine = ServingEngine(predictor).start()

        handles = [engine.submit(
            {"x": np.full((1 + i % 2, 8), float(i), np.float32)})
            for i in range(n_requests)]

        def report():
            # runs in the drain thread AFTER engine.drain(): every
            # admitted request must be resolved — a value counts as
            # kept, a typed failure as lost
            done = sum(1 for h in handles if h.done())
            ok = sum(1 for h in handles
                     if h.done() and h.error() is None)
            print(f"DRAINED done={done} ok={ok} total={n_requests}",
                  flush=True)

        install_sigterm_drain(engine, on_drained=report, exit_code=0)
        os.kill(os.getpid(), signal.SIGTERM)
        # unreachable when the handler exits; bounded so a broken
        # handler fails the test on its exit code, not by a hang
        time.sleep(30)
        print("HANDLER DID NOT EXIT", flush=True)
        sys.exit(3)


if __name__ == "__main__":
    main()
