"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and hold
every kernel on them against its plain PyTorch version.

    python3 chip_smoke.py                 # all phases, one card
    python3 chip_smoke.py --kernels-only  # build + phase 1 only
    python3 chip_smoke.py --bag-shapes    # K6's time at each of BAG_SHAPES

Phases, each printing one JSON line; any failure exits non-zero and
prints no result line. Phases 2-4f run right after phase 1's decode
kernels (K4, K5) and before its other checks: once a torch.profiler
session has run in a process, its host-side launches stay slower, and
a decode tick is its host's launch loop.

0. build    every CUDA kernel from ``paddle_tpu_torch/ops/cuda/csrc``,
            one nvcc per source, all started together (ptxas report
            included); the HMMA/HGMMA instructions of each kernel function
            of the flash and fused xent libraries, from ``cuobjdump
            -sass``, and a failure unless every instantiation of the
            tensor-core kernels (``short_fwd_mma``, ``short_bwd_mma``,
            ``flash_fwd_mma``, ``flash_dq_mma``, ``flash_dkv_mma``,
            the head widths 192 and 256's ``flash_fwd_wg``,
            ``short_fwd_wg`` and ``short_bwd_wg``,
            ``xent_fwd_mma``, ``xent_bwd_mma``, ``xent_fwd_ws``,
            ``xent_bwd_ws``: every K2 kernel but the f32 form's
            elementwise split pass) has some; the wide libraries' wgmma
            kernels must hold HGMMA and no local memory (``cuobjdump
            -res-usage``: their registers and stack / local bytes are
            printed), and none of the designs they replaced
            (``short_bwd_wide``, the wide ``flash_fwd_mma`` /
            ``short_fwd_mma``) may be left in those libraries;
1. kernels  each kernel against its plain version on the card at its
            main path's shapes: paged attention over f32, bf16, f16 and
            int8 pools within atol/rtol 1e-4 (sum order), two launches
            bit for bit, a len-0 row of zeros, a -1 table entry, its
            cluster size; sampling bit for bit
            (decode slice) at V 32000 and 50257, top_k 0, 1, 4, 8, 50,
            1024, V - 1 and V, on random rows and on rows of ties, +-0.0
            and -inf, a relaunch equal, timed at top_k 0, 8 and 50; flash
            attention forward and backward at
            BERT-base's 128 x 128 x 12 x 64 in bf16 (atol 2e-2 + rtol
            1e-2, one bf16 ulp) and f32 (atol 1e-4), one f32 case at
            L = 512, one f32 causal case, GPT-2 small's causal 8 x 1024
            in bf16 (its forward timed beside causal SDPA), bf16 with
            Lq != Lk, a ragged causal L and D = 128, dropout
            0.1 with the keep mask read back bit for bit, two launches of
            every bf16 flash kernel (here and in the short, masked and
            external-lse checks below) equal bit for bit; K1a/K1b's f16
            forms (``check_flash_f16``) at the NMT's 64 x 128 x 8 x 64
            with dropout 0.1, causal and not, dO at 2^15 times a unit
            gradient, a peaked softmax, dO at scale 1, a key-padded batch,
            and f16 and bf16 at the decoding lengths (Lq 1, 17, 64, 127
            against Lk 128; causal L 1, 17, 64), element by element (one
            unit of the type plus four unit roundoffs of the terms'
            2-norm, and the f32 sums' rounding where dS cancels), two f16
            launches bit for bit, the f16 launches counted apart, the f16
            and bf16 forms timed beside SDPA over f16; the fused
            vocabulary cross-entropy forward and backward
            at 16384 x 768 x 30592 f32 with ~15% ignored rows (largest
            error within 1e-4 of the largest value, two launches equal
            bit for bit, each of its kernels' device time); fused AdamW over
            BERT-base's parameter list, bit for bit; fused Momentum over
            ResNet-50's 161 parameters, with and without Nesterov, bit
            for bit; the short-sequence flash kernels at BERT phase 2's
            32 x 512 x 12 x 64 in bf16 with dropout 0.1 (atol 2e-2 +
            rtol 1e-2), at L = 128 in f32 (atol 1e-4), a causal and a
            D = 128 case, each against the plain version and against the
            streaming kernel, the dropout mask bit for bit, and their
            times beside the streaming kernel's and SDPA's at L 128 and
            512, and their f16 forms (dO at scale 1 and 2^15, a peaked
            softmax, causal L 256 and 512, D 128 at L 384, L 128: the
            backward's clusters of 2, 4, 6 and 8) element by element by
            the 2-byte rule, two launches bit for bit, K1c f16's lse
            K1a f16's, timed beside SDPA over f16 at L 512; fused SGD over LeNet's and BERT-base's parameter lists
            with weight decay 0 and 1e-4 and over 1,400 small tensors (two
            launches, offset views among them), bit for bit, a skipped step
            launching nothing, its one-tensor launch floor timed; fused
            Lamb over BERT-base's: m, v and r bit for bit, the norms
            phase 1 takes within rtol 1e-6 of f64 norms, p bit for bit
            the plain apply given those norms, two launches
            bit for bit, one count of each kernel a call; K3's static
            forms (sgd, momentum, adam, lamb), one launch a tensor over
            the static example's 25 tensors and BERT-base's 206,
            FoundInfinite absent, false and true, bit for bit with the
            beta-pow outputs; the embedding bag (K6) at
            ``tools/op_bench.py:163``'s table 100000 x 256 and ids 4096 x
            64, sum, mean and sqrtn over an f32 and a bf16 table with
            all-padding bags and ids >= V, and over a 24,000-row table
            that fits in L2 (f32 atol 1e-5 + rtol 1e-5, bf16 one ulp;
            two launches bit for bit); K1a/K1b's
            masked form at phase 2's padded 32 x
            512 x 12 x 64 bf16 with dropout 0.1 (atol 2e-2 + rtol 1e-2),
            128 x 128 f32, causal, fully masked rows (the mean of V) and
            a masked first kv tile (atol 1e-4), in bf16 batch entries
            with no live key and a causal left-padded batch, with the kv
            tiles the bf16 forward skips, the dropout mask through a key
            mask bit for bit; K1b's external-lse form (``flash_ring``)
            through the ring's arithmetic in one process at GPT-2 small's
            8 x 1024 x 12 x 64 bf16, kv in 2 and 4 chunks, causal, full and
            key-padded, against the one-launch K1a/K1b and the plain
            versions (bf16 atol 2e-2 + rtol 1e-2, one f32 case at 1e-4),
            and alone at the SP block 8 x 512 x 12 x 64; its f16 form
            through the ring (causal in 2 and 4 chunks, full in 2, dO at
            scale 1 and 2^15) and alone at the SP block (full, diagonal,
            a block holding little of each row's mass) by the 2-byte rule,
            two launches bit for bit, timed beside aten's flash backward
            over f16; K3's ZeRO chunk
            entry (``chunk_lamb``) at the book net's chunk over {"dp": 2}
            (9,216 elements, both ranks' positions), BERT-base's
            word-embedding chunk (11,720,704) and a 524,288-element chunk
            over 64 segments, FoundInfinite absent, false and true: m, v
            and the beta-pows bit for bit, p within 1e-6 of its largest
            value, two runs bit for bit, two launches a call, the ticket
            left at 0; slice 2b's forms: K2a/K2b over bf16 and over f16
            inputs at BERT-base's head and with h eight times larger
            (a peaked softmax), f16 at a loss scale of 2^10 (lse and
            the label logit within 1e-5 of their largest value; dh, dW,
            db in the type, element by element, against the plain
            version's f32 values within one unit of the type plus four
            unit roundoffs of the 2-norm of the element's terms, the
            rounding of P' (db, an f32 sum: 2^-16 of their 1-norm);
            dW's softmax part, its rows no label hits,
            within a relative norm of two unit roundoffs; two launches
            bit for bit), K3's master forms over 2-byte
            parameters with f32 masters, through the f32 forms' checks
            (adam at BERT-base's list in bf16, momentum at ResNet-50's
            in f16, sgd with its decay at LeNet's in bf16, lamb at
            BERT-base's in bf16): parameters, masters and state bit for
            bit the plain versions, two launches bit for bit, a skipped
            call launching nothing; slice 1b's 2-byte forms without
            masters (``k3_2byte``: state in the parameters' type, each
            operation rounded to it) over bf16 and f16, Adam and AdamW,
            SGD with and without its L2 term and Lamb at BERT-base's 206
            tensors, Momentum with and without Nesterov at ResNet-50's
            161: bit for bit the plain versions (Lamb's apply given the
            kernel's sums, the sums within rtol 1e-6 of f64), two
            launches bit for bit, one count a call, a skipped call
            launching nothing, timed beside ``AdamW`` / ``SGD(momentum=
            0.9)`` / ``SGD`` with ``fused=True`` over the same 2-byte
            tensors; every K1 form at head widths 192 and 256
            (``wide_case``: the ``wide`` rows of check_flash,
            check_flash_f16, check_flash_masked, check_flash_short,
            check_flash_short_f16 and check_flash_ring): f32, bf16 and
            f16, causal, key-masked (entries with no live key; a batch
            whose shorter entries end kv tiles early, so the forward
            skips dead tiles), dropout 0.1, ragged Lq != Lk, lengths that
            end inside the forward's 128-row q tile and inside a kv
            tile (L 130, 200, 320, 333, 459; causal and not, bf16 and
            f16), the external-lse backward at the SP block, the short
            kernels at L 128, 384 and 512 (they take L % 128 == 0: the
            wide backward's clusters of 2, 6 and 8, causal L 384 in bf16
            and f16, and how many clusters the card holds), each against
            its plain version by its check's
            tolerance, its launch counts moved, the 2-byte forms twice
            bit for bit, each timed beside SDPA (aten's flash backward
            for the external-lse form) and its bound. Kernel, plain and
            library times and the least time the card could take (bound);
2. int8     the decode engine at the full width of its README
            configuration (vocab 32000, 24 layers, 16 x 128 heads, ffn
            8192, page 128, 16 pages a sequence, batch 8, 512 pages,
            int8 pool), greedy, 16 concurrent requests of 16-1500
            prompt tokens, 32 new tokens each, in two legs: the async
            tick (the default) and the sync tick (``async_decode=
            False``); tokens identical; every request finishes, the int8
            attention kernel launches n_layers times a tick; each leg's
            tokens/s, tick ms (exact percentiles of each tick's dispatch
            + host + fetch, beside the engine's bucketed decode_step_ms),
            dispatch / host / fetch split, overlap share, and the busy
            share of a profiled window driven on this thread (a window
            with no paged attention kernel is profiled again, then
            reported "not measured"); then the async tick driven on
            this thread with ``torch.cuda.set_sync_debug_mode`` around
            every dispatch: no synchronising call;
3. f32      the same model over an f32 pool, async, greedy, 4 requests;
            tokens equal the dense oracle (``reference_generate`` on the
            card) except where the oracle's top-2 logit gap is < 1e-3 (a
            tie, printed as such); the f32 attention kernel launched
            n_layers times a tick;
4. sample   int8 pool, temperature 0.8, top_k 8, sample_seed 7, run
            twice: identical tokens, the sampling kernel launched;
4b. bf16    pools in bf16 and in f16 (``dtype=``), 4 requests: K4a's
            2-byte forms launched n_layers times a tick; tokens equal a
            run with the plain versions swapped in except at a top-2 gap
            < 1e-3 (of the dense forward with K/V rounded as the pool
            holds them);
4c. spec    ``spec_k=4`` over the int8 pool, 8 requests (4 of a motif
            repeated six times, 4 random): tokens equal a non-spec
            engine's except at near ties, the accept rate, K4b n_layers
            times a verify tick;
4d. host_tier  8 requests of 500 + 200 tokens over an int8 pool of 33
            pages with a host tier: at least one session parks and one
            resumes through the prefetcher, none is preempted, tokens
            bit for bit those of a 512-page twin, K4b n_layers times a
            tick in both;
4e. adopt   the port's ``PrefillWorker`` ships the 8 full pages of a
            1100-token prompt as an int8 frame; the engine adopts them,
            shares them at the prompt's prefill (8 prefix hits) and
            writes only the suffix; tokens equal a locally prefilled
            twin's except at near ties, K4b n_layers times a tick in
            both;
4f. fleet   ``serving.FleetRouter`` (chunks of 8 tokens) over two
            README-width int8 engines of 128 pages sharing one params
            dict, 8 sessions of 16-1000 prompt tokens, 32 new each, in
            three legs on fresh engines: A in process (``LocalReplica``),
            every request served, both engines ticking; B the same with
            session 0's replica stopped after its first chunk: every
            request served, failovers and replays >= 1, tokens equal A's
            except at a top-2 gap < 1e-3 (each such tie printed); C over
            two ``DecodeEngineServer`` listeners on loopback and
            ``HTTPReplica`` (tokens as B's rule), then GET /metrics per
            server parsed with the decode counters in it, one
            ``FleetSLOSignal`` refresh, a ``PrefillWorker`` frame of a
            1100-token prompt PUT to /adopt on both and that prompt
            routed with >= 8 prefix hits, and a malformed frame answered
            400 ``MalformedPageFrame``; K4b n_layers times a tick in
            every leg; tokens/s, router e2e p50/p99, dispatches,
            affinity hits, failovers, replays, near ties a leg;
5. bert_parity  a tiny BERT (2 layers, hidden 128, seq 128, batch 8, no
            dropout, f32) trained one AdamW step through ``TrainStep``
            with the kernels and again with the plain versions, on the
            card: loss, every gradient and every updated parameter agree;
6. bert     BERT-base pretraining (vocab 30592, 12 layers, 12 x 64
            heads, ffn 3072), batch 128 x seq 128, AMP O1 bf16, dropout
            0.1, AdamW lr 1e-4, the same batch every step (as
            ``bench.py`` ``bench_bert``): 3 warm-up and 10 timed steps;
            tokens/s, step ms, MFU, the loss (finite, falling), exact
            kernel launches per step, and a profiled step by family;
6e. api_bert  ``examples/train_bert.py`` as a user runs it, its import
            changed (``paddle.to_tensor`` inputs, 1 + 50 steps): it must
            print ``device: gpu:0`` and ``OK``; exactly phase 6's
            launches a step; 3 + 10 timed steps beside phase 6's; a step
            fed ``Tensor``s against one fed the same tensors plain under
            torch.profiler: the same kernels, copies and fills; 6 timed
            pairs of the two, alternating which goes first (reported);
6f. api_bert_eager  phase 6's model at dropout 0 in the eager loop
            (``model.loss``, ``backward``, ``step``, ``clear_grad``,
            ``float``), 10 steps with phase 6's launches a step, its
            first 3 losses within 1e-5 of ``TrainStep``'s from the same
            weights;
6c. bert_recompute  phase 6 under ``RecomputeOptimizer(AdamW)`` with the
            12 encoder layers as checkpoints: every step-1 gradient bit
            for bit a fresh phase-6 model's (same weights, seed and
            dropout; both steps under PyTorch's deterministic algorithms,
            whose embedding backward otherwise adds with atomics),
            exactly 24 K1a and 12 K1b launches a step (each layer's
            forward again in the backward), peak memory below that
            fresh model's step and phase 6's, step ms beside phase 6's;
6a. bert_o2_parity  phase 5's tiny BERT at AMP O2 bf16 with f32 masters
            (``amp.decorate``), one AdamW step with the kernels (K1a,
            K1b, K2's bf16 form, K3-adam's master form; no f32 K2/K3) and
            again with the plain versions: the bf16 losses within 2 bf16
            units, each gradient within 5e-2 of its largest value (the
            key biases' exactly-zero gradient within 1e-3), the masters
            within two steps' reach, every parameter its master's cast;
6b. bert_o2  phase 6 at AMP O2 bf16 with f32 masters: exactly 12 K1a,
            12 K1b, one K2a and one K2b bf16 form and one K3-adam master
            a step and no f32 K2/K3 launch, the loss (finite, falling),
            every parameter bf16 and its master's cast bit for bit after
            the last step; tokens/s, step ms, MFU, peak memory and the
            profiled step's busy share beside phase 6's;
6d. bert_o2_pure  phase 6b WITHOUT masters (``decorate(master_weight=
            False)``: bf16 weights and AdamW moments): the first loss
            (the terms added in f32) within 1e-4 relative of a
            plain-version copy's, exactly 12 + 12 K1, one K2a + K2b bf16
            and one K3-adam 2-byte launch a step and no f32, master or
            other K3 form, every parameter and moment bf16; tokens/s,
            step ms and peak memory beside phase 6b's;
7. resnet_parity  a small ResNet (BottleneckBlock [1, 1, 1, 1], 64 x 64,
            batch 4, f32) trained two Momentum steps through
            ``TrainStep`` with the kernel and again with the plain version,
            on the card with cuDNN deterministic: losses, parameters,
            velocities and running statistics bit for bit;
8. resnet50 ResNet-50, batch 128 x 3 x 224 x 224, 1000 classes, AMP O1
            bf16, Momentum lr 0.1 mu 0.9, the same batch every step (as
            ``bench.py`` ``bench_resnet``; cuDNN's default algorithm
            choice, ``cudnn.benchmark`` off): 3 warm-up and 10 timed
            steps; imgs/s, step ms, MFU, peak memory, the loss (finite),
            one Momentum launch a step, and a profiled step by family;
8b. resnet50_fp16  phase 8 at AMP O2 fp16 with f32 masters: Momentum
            with ``L2Decay(1e-4)`` and ``multi_precision``,
            ``GradScaler(init_loss_scaling=128)`` in the eager loop
            (``scaler.scale(loss).backward(); scaler.minimize(opt,
            scaled); opt.clear_grad()``): 3 warm-up and 10 timed steps,
            one K3-momentum master a step unskipped, the loss finite;
            then the scale forced to 2**40 for two steps: no K3 launch,
            parameters, masters and velocities bit for bit, the step
            count unchanged, the scale 2**39 after; the state restored,
            one more step launches one K3; imgs/s, step ms, peak memory,
            skipped steps and a profiled step by family beside phase 8's;
8c. resnet50_lars  phase 8 with ``LarsMomentum(0.1, momentum=0.9,
            lars_coeff=0.001, lars_weight_decay=0.0005)``: no K3 launch,
            161 ``optimizer_rule.LarsMomentum`` counts a step (the rule in
            tensor operations, as JAX runs it in XLA), the loss finite,
            imgs/s and step ms beside phase 8's;
8d. optimizer_rules_parity  the eight XLA-only rules, DGCMomentum with a
            warm-up, GradientMerge(k=4), LookAhead, EMA and ModelAverage,
            3 steps over the f32 shapes of BERT-base cut to 3 of its 12
            layers (62 tensors: the run's time limit) on the card against
            the same code on the CPU: each tensor within 1e-5 of its
            largest value (bit for bit counted), DGC's masks equal, one
            rule count a parameter and step, Dpsgd's noise by its
            moments;
9. bert_lamb_parity  a tiny BERT (2 layers, hidden 128, seq 128, batch
            8, f32, dropout 0.1, ``flash_short_seq`` on) trained two Lamb
            steps with global-norm clipping through ``TrainStep`` with
            the kernels and again with the plain versions, on the card:
            losses, gradients, parameters and moments agree;
10. bert512_lamb  BERT-base phase 2, batch 32 x seq 512 (``bench_bert
            (seq=512)``), AMP O1 bf16, dropout 0.1, ``flash_short_seq``
            on, Lamb on a linear warm-up into a polynomial decay,
            ``ClipGradByGlobalNorm(1.0)``: 3 warm-up and 10 timed steps;
            tokens/s, step ms, MFU, peak memory, the loss (finite; the
            first step's equal to the plain versions' from a copy of the
            model within rtol 1e-4), exact launches a step (12 + 12 short
            flash, no streaming flash, 1 + 1 xent, 1 + 1 Lamb, no Adam)
            and a profiled step by family;
10b. bert512_fp16  phase 10 at AMP O1 fp16 with no loss scaler: exactly
            12 + 12 f16 short flash launches a step and no other K1, the
            first loss within 2^-11 (relative) of a plain-version copy's
            one step, the rest as phase 10;
10c. bert512_d192  phase 10 with BERT-base's width in 4 heads of 192:
            exactly 12 + 12 short flash launches a step at head width 192
            (no plain attention), the first loss within rtol 1e-4 of a
            plain-version copy's one step, the rest as phase 10;
11. lenet_sgd  LeNet at batch 128 x 1 x 28 x 28, SGD lr 0.01 with L2
            1e-4 (in the kernel): 3 warm-up and 10 timed steps; steps/s,
            the loss (finite, falling), one SGD launch a step covering
            every parameter, a profiled step's kernels, name for name,
            those of a step without the decay (in a process of its own,
            each window led by spin kernels the trace must hold);
12. static_parity  the static example's network at batch 8, two steps
            through the static Executor with each static optimizer, with
            the kernels and again with the plain versions, cuDNN
            deterministic: losses and every persistable bit for bit;
13. static_resnet  ``examples/train_resnet_static.py`` as written
            (Momentum lr 0.05 mu 0.9, batch 64 x 3 x 32 x 32, its loop of
            3 epochs x 8 batches over the synthetic CIFAR-10 sample):
            steps/s, step ms, peak memory, a profiled step, the loss
            (finite, falling), exactly 25 static Momentum launches a step
            and no other kernel; then the inference model saved, loaded
            and its logits equal to the test-mode program's;
13b. serving  ``inference.AnalysisPredictor`` over that inference model
            (buckets 1, 2, 4, 8, 16, warmed) behind a
            ``ServingEngine`` on its thread: 64 requests of 1-4 rows
            from 4 threads, each within atol 1e-4 of the request run
            alone, fewer batches than requests, none degraded; then
            ``serve.dispatch`` armed twice: the retry and the degraded
            row-by-row leg on the card serve every request within atol
            1e-4; ``ServingHealthServer``'s /readyz 200, 503 after
            ``drain()``; requests/s, e2e p50/p99, batch fill;
14-16. static_resnet_adam, _lamb, _sgd  the same network, 13 steps with
            Adam 2e-3, Lamb 1e-3 (25 + 25 launches a step) and SGD 0.05 +
            L2Decay(1e-4);
17. bag_parity  the bag model below at table 1000 x 64, ids 64 x 16,
            two SGD steps with the K6 kernel and again with its plain
            version: losses, gradients and parameters agree;
18. embedding_bag  ids 4096 x 64 (~20% padding_idx 0) through
            ``incubate.layers.fused_embedding_seq_pool(size=(100000,
            256), padding_idx=0)`` (it creates the table), ``nn.Linear(
            256, 2)``, cross-entropy, SGD lr 0.01: 3 warm-up and 10
            timed steps; steps/s, step ms, peak memory, the loss
            (finite, falling), one K6 and one SGD launch a step, a
            profiled step;
19. bert_masked_parity  phase 5 on a padded batch (lengths 16-127, a
            (B, 1, 1, 128) bool key-padding mask, no MLM labels at
            padding) through the masked flash kernels;
20. bert512_masked  phase 10's configuration on a padded batch
            (lengths from ``RandomState(0)`` in 128-512, row 0 full):
            exactly 12 + 12 masked flash launches a step and no short or
            unmasked ones, tokens/s over valid and over all tokens, step
            ms, MFU (an upper figure: the closed form at full length),
            a profiled step; then one eval forward at dropout 0 with the
            kernels and with the plain version (atol 2e-2 + rtol 1e-2);
21. gpt_sp_parity  a small GPT (2 layers, hidden 128, 2 x 64 heads,
            vocab 1024, batch 4 x 256, f32, no dropout), two AdamW lr
            1e-3 steps through ``TrainStep(mesh, data_spec=(None, "sp"),
            sequence_parallel="sp")`` as two processes on the card over
            gloo, and again in one process: losses, all-reduced
            gradients and parameters agree (atol 1e-4 + rtol 1e-4); the
            ranks launch K1a and the external-lse K1b per live block and
            no saved-form K1b;
22. gpt      GPT-2 small (vocab 50257, 12 layers, 12 x 64 heads, ffn
            3072), batch 8 x 1024, AMP O1 bf16, attention dropout 0,
            hidden dropout 0.1, AdamW lr 1e-4 wd 0.01, the same batch
            every step: 3 warm-up and 10 timed steps; tokens/s, step
            ms, MFU, peak memory, the loss (finite, falling), exactly
            12 + 12 flash launches and one Adam launch a step, a
            profiled step;
22b. gpt_d256  phase 22 with GPT-2 small's width in 3 heads of 256:
            the same parameter count and closed-form FLOPs, exactly
            12 + 12 flash launches at head width 256 (no plain attention)
            and one Adam launch a step, the loss falling, a profiled step;
23. gpt_sp   the same model and global batch over ``{"sp": 2}``, two
            processes on the card over gloo (the ring exchange staged
            through pinned host buffers), rank 0 reporting: tokens/s over
            the global 8192 tokens, step ms, peak memory and staged bytes
            a rank, the loss (finite, falling), exact launches a step
            (rank 0: 12 K1a + 12 external-lse K1b; rank 1: 24 + 24; no
            saved-form K1b), a profiled step with the time in the
            collectives;
23b. gpt_sp_fp16  phase 23 at AMP O1 fp16 with no loss scaler, 3 warm-up
            and 5 timed steps: rank 0 12 K1a f16 + 12 external-lse K1b
            f16 a step, rank 1 24 + 24, no bf16 or f32 K1, the ranks'
            losses equal, finite and falling;
24. static_zero_parity  the book's recognize_digits conv net
            (``tests/test_book.py:62-81``) over ``{"dp": 2}``, two
            processes on the card over gloo, global batch 64, 2 steps a
            leg through ``CompiledProgram``, cuDNN deterministic:
            comm(f32) -> zero2(f32) -> comm(f32) equal to comm(f32) bit
            for bit (Momentum, through the absorb and the flip-back),
            zero3(f32) too; zero2 Lamb within rtol 1e-5 + atol 1e-6 of
            comm Lamb; zero2(int8) Adam within 1e-2 of comm(int8) Adam;
            the replicated dp step within 1e-5 of the one-rank Program;
            every step's launches exact; zero.zero counted, zero.xla not;
25. static_zero  the same net, ``zero_stage=2``, ``comm_quant="int8"``,
            Lamb lr 1e-3, the same batch every step: 3 warm-up and 10
            timed steps; step ms, steps/s, staged bytes a step, the ZeRO
            counters, the loss (finite, falling), one chunk_lamb_phase1
            and one chunk_lamb_apply a step on each rank and no static
            Lamb, rank 0's profiled step with the host ms in the
            ``collectives.*`` spans;
26. nmt_parity  a narrower NMT (vocab 1000, d_model 128, 2 x 64 heads,
            2 + 2 layers, ffn 256, dropout 0, batch 8 x 128), three Adam
            steps through ``TrainStep`` with the kernels and again with
            the plain versions, in f32 (losses within rtol 1e-5) and at
            AMP O1 fp16 (K1's f16 forms; rtol 2e-3);
27. nmt      ``bench_nmt`` at its full width (vocab 32000, d_model 512,
            8 x 64 heads, 6 + 6 layers, ffn 2048, dropout 0.1), batch 64
            x seq 128, Adam lr 1e-4, AMP O1 bf16, ``TrainStep``, the ids
            of ``bench.py:1653-1661``: 3 warm-up and 10 timed steps;
            tokens/s (2 B S a step), step ms, MFU (``bench.py:1662-1666``
            over 989 TFLOP/s), peak memory, the loss (finite, falling),
            exactly 18 K1a + 18 K1b (the decoder's subsequent mask runs
            as causal masking), one K2a + K2b and one K3-adam a step and
            no per-query plain attention, a profiled step;
28. nmt_decode  the trained model's ``greedy_decode`` and
            ``beam_search_decode`` (beam 4, max_len 64) of 8 sources, f32,
            against the same model with the plain versions: tokens equal
            but at near ties (a greedy row at a top-2 gap < 1e-3; a beam
            entry at best scores within 1e-3); tokens/s, K1's launches;
29. nmt_fp16 the same model at AMP O1 fp16 in the eager loop with
            ``GradScaler()`` (first scale 2^15): 18 + 18 f16 K1 launches a
            step and no bf16 one, one K2a + K2b, one K3-adam an unskipped
            step; the loss scale and skipped steps; then a forced overflow
            (2^40 for two steps: no K3, parameters and moments unchanged
            bit for bit, the scale 2^39 after) and one step after the
            restore; the figures beside ``nmt``'s;
29b. api_wgan  ``examples/train_wgan_gp.py`` (30 steps, a double
            gradient through ``autograd.grad(create_graph=True)``): OK,
            exactly 2 K3-adam a step and no other launch;
29c. api_nmt  ``examples/translate_beam.py`` (300 steps, head width 16,
            beam 4): OK (accuracy > 0.8), attention on the counted plain
            route (``attention_plain``) and no K1, 300 K2a/K2b/K3-adam;
            head width 16 on the card against the CPU within 1e-5; head
            widths 192/256 launch K1a, within 1e-4 of the CPU;
29d. ops_parity  every case of ``tests/_torch_op_cases.py`` (each op of
            the op library) on CUDA against the CPU, forward and
            gradient, every method of the method table and operator on a
            CUDA ``Tensor``, the random ops' determinism under
            ``paddle.seed``: integer/boolean/layout results bit for bit,
            floats within the case's tolerance, every result a
            ``Tensor`` on the card;
30. the ``kernels`` line (launches summed over the phases that drive
    each kernel's path: 2-4f for the decode kernels, 6, 6e, 6f, 10,
    27, 29 and 29c for the fused xent, 6b for its bf16 form and
    K3-adam's master form, 8b for K3-momentum's, 6, 6b, 6e, 6f and 27
    for the streaming flash kernels, 29 for their f16 forms, 6, 6e, 6f,
    27, 29, 29b and 29c for Adam,
    8 for Momentum, 10 for the short flash kernels and Lamb, 10b for
    their f16 forms, 11 for SGD, 13-16 for the static forms, 18 for K6,
    20 for the masked flash kernels, 23 for the external-lse K1b, 23b for
    its f16 form (and K1a f16), 25 for the chunk Lamb, both ranks, 6d
    for K3-adam's bf16 form without masters (and 6c for the streaming
    flash kernels, K2 and Adam), 22b for K1a/K1b at head width 256 and
    10c for K1c/K1d at head width 192 (rows ``*_d256`` and ``*_d192``,
    timed at those phases' shapes); K2's f16 form, K3-sgd's and K3-lamb's
    master forms and the other 2-byte forms without masters run on no
    phase's path, ``"main_path": false``, launches 0: at O1 the
    vocabulary heads take f32 from a black-listed norm), then the card's
    name and power limit, then the result line.

Weights are random, made on the card from a seed. Depth and width are
the configurations' own.
"""
from __future__ import annotations

import argparse
import ctypes
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
ATOL = RTOL = 1e-4            # paged attention: the sum order differs

FULL = dict(vocab_size=32000, n_layers=24, n_heads=16, head_dim=128,
            ffn_dim=8192, max_context=2048)
ENGINE = dict(max_batch=8, page_size=128, max_pages_per_seq=16)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseFailed(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------
HOST_AHEAD_CYCLES = 4_000_000  # ~2 ms of spinning at the H100's clocks


def time_ms(torch, fn, iters: int = 20, warmup: int = 3,
            spin: int = HOST_AHEAD_CYCLES) -> float:
    """Median device time of one call, L2 flushed before each (the
    decode step reads each layer's pages cold). A spin kernel queued
    before the start event keeps the device busy while the host runs
    the call's Python (argument checks, pointer tables), so a call that
    launches one kernel is timed by that kernel alone; a call whose
    host work outlasts the spin (the plain versions) still counts its
    gaps. ``spin`` (cycles) sets how much host work is hidden."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 0: the tensor-core kernels' instructions
# ---------------------------------------------------------------------------
TENSOR_CORE_KERNELS = ("short_fwd_mma", "short_bwd_mma", "flash_fwd_mma",
                       "flash_dq_mma", "flash_dkv_mma", "flash_fwd_wg",
                       "short_fwd_wg", "short_bwd_wg", "xent_fwd_mma",
                       "xent_bwd_mma", "xent_fwd_ws", "xent_bwd_ws")
# the wgmma kernels of the wide libraries (head widths 192 and 256), and
# the designs they replaced, which those libraries no longer hold
WIDE_LIBS = ("flash_attention_wide", "flash_short_wide")
WIDE_WG_KERNELS = ("flash_fwd_wg", "short_fwd_wg", "short_bwd_wg")
WIDE_GONE = ("short_bwd_wide", "flash_fwd_mma", "short_fwd_mma")


def sass_functions(build, libs):
    """{library: {kernel function: (HMMA, HGMMA) instruction counts}} from
    the SASS of each library (the toolkit's ``cuobjdump``, one process a
    library, all at once)."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    procs = {lib: subprocess.Popen([tool, "-sass", str(build._lib_path(lib))],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for lib in libs}
    out = {}
    for lib, proc in procs.items():
        text, err = proc.communicate(timeout=300)
        expect(proc.returncode == 0, f"cuobjdump failed on {lib}: "
                                     f"{err[-500:]}")
        fns, fn = {}, None
        for line in text.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                fns[fn] = [0, 0]
            elif fn is not None and " HMMA." in line:
                fns[fn][0] += 1
            elif fn is not None and " HGMMA." in line:
                fns[fn][1] += 1
        out[lib] = {f: tuple(n) for f, n in fns.items()}
    return out


def tensor_core_counts(build):
    """HMMA (``mma.sync``) plus HGMMA (``wgmma``) instructions in each
    kernel function of the flash libraries (both widths' libraries) and
    the fused xent library, read from their SASS; fails unless every
    instantiation of the tensor-core kernels has some. Returns
    ({function: count}, the wide libraries' rows of ``wide_wg_check``)."""
    libs = ("flash_attention", "flash_short", "fused_xent") + WIDE_LIBS
    sass = sass_functions(build, libs)
    counts = {fn: sum(n) for fns in sass.values() for fn, n in fns.items()}
    for name in TENSOR_CORE_KERNELS:
        got = [n for fn, n in counts.items() if name in fn]
        expect(bool(got) and min(got) > 0,
               f"{name}: no tensor-core instruction in {got}")
    return counts, wide_wg_check(build, {lib: sass[lib] for lib in WIDE_LIBS})


def resource_usage(build, lib):
    """{kernel function: {"REG", "STACK", "LOCAL", ...}} of a library, from
    ``cuobjdump -res-usage``."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-res-usage", str(build._lib_path(lib))],
                          capture_output=True, text=True, timeout=300)
    expect(proc.returncode == 0, f"cuobjdump -res-usage failed on {lib}: "
                                 f"{proc.stderr[-500:]}")
    out, fn = {}, None
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function ") and line.endswith(":"):
            fn = line[len("Function "):-1].strip()
        elif fn is not None and line.startswith("REG:"):
            out[fn] = {k: int(v) for k, v in (
                t.split(":", 1) for t in line.split()
                if ":" in t and t.split(":", 1)[1].isdigit())}
            fn = None
    return out


def wide_wg_check(build, sass):
    """The wide libraries' wgmma kernels: every instantiation of
    ``WIDE_WG_KERNELS`` holds HGMMA and uses no local memory (STACK and
    LOCAL 0 in ``cuobjdump -res-usage``: no spill), and none of the
    designs they replaced (``WIDE_GONE``) is left. Returns each
    instantiation's registers (at launch; setmaxnreg moves them at run
    time), local bytes and HGMMA / HMMA counts."""
    rows = {}
    for lib, fns in sass.items():
        gone = [fn for fn in fns if any(g in fn for g in WIDE_GONE)]
        expect(not gone, f"{lib} still holds {gone}")
        res = resource_usage(build, lib)
        for fn, (hmma, hgmma) in fns.items():
            if not any(k in fn for k in WIDE_WG_KERNELS):
                continue
            r = res.get(fn, {})
            rows[fn] = {"lib": lib, "hgmma": hgmma, "hmma": hmma,
                        "registers": r.get("REG"), "stack": r.get("STACK"),
                        "local": r.get("LOCAL")}
            expect(hgmma > 0, f"{fn}: no HGMMA in {lib}")
            expect(r.get("LOCAL") == 0 and r.get("STACK") == 0,
                   f"{fn}: local memory in {lib} ({r})")
    for name in WIDE_WG_KERNELS:
        expect(any(name in fn for fn in rows), f"{name}: not built")
    return rows


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_case(torch, rng, B, H, D, S, T, P, lens, quant, dtype=None):
    """Inputs at one shape: distinct live pages per row, -1 past the
    live pages, and one -1 inside the live length of the longest row
    (which reads page 0, as the JAX paths do). ``dtype`` rounds an
    unquantized pool to a 2-byte type."""
    dev = "cuda"
    q = torch.tensor(rng.randn(B, H, D).astype(np.float32), device=dev)
    perm = rng.permutation(np.arange(1, P))
    table = np.full((B, T), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        live = -(-n // S)
        table[b, :live] = perm[used:used + live]
        used += live
    longest = int(np.argmax(lens))
    if -(-lens[longest] // S) > 2:
        table[longest, 1] = -1
    if quant:
        kp = torch.randint(-127, 128, (P, S, H, D), dtype=torch.int8,
                           device=dev)
        vp = torch.randint(-127, 128, (P, S, H, D), dtype=torch.int8,
                           device=dev)
        ks = torch.rand((P, S), device=dev) * 0.02
        vs = torch.rand((P, S), device=dev) * 0.02
    else:
        kp = torch.randn((P, S, H, D), device=dev)
        vp = torch.randn((P, S, H, D), device=dev)
        if dtype is not None:
            kp, vp = kp.to(dtype), vp.to(dtype)
        ks = vs = None
    return (q, kp, vp, ks, vs, torch.tensor(table, device=dev),
            torch.tensor(np.asarray(lens, np.int32), device=dev))


def check_attention(torch, pa, rng, quant, timing, dtype=None):
    """K4 (K4b when ``quant``; K4a over an f32 pool, or over a
    ``dtype`` pool: bf16 or f16) against its plain version."""
    B, H, D, S, T, P = 8, 16, 128, 128, 16, 512
    lens = [1, 127, 128, 129, 700, 2047, 1500, 300]
    q, kp, vp, ks, vs, table, lens_t = attention_case(
        torch, rng, B, H, D, S, T, P, lens, quant, dtype)

    if quant:
        def kern():
            return pa._cuda_paged_attention_quant(q, kp, vp, ks, vs, table,
                                                  lens_t)

        def plain():
            return pa._plain_paged_attention_quant(q, kp, vp, ks, vs, table,
                                                   lens_t)
    else:
        def kern():
            return pa._cuda_paged_attention(q, kp, vp, table, lens_t)

        def plain():
            return pa._plain_paged_attention(q, kp, vp, table, lens_t)

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    expect(bool(torch.isfinite(out).all()), "non-finite attention output")
    expect(torch.allclose(out, ref, atol=ATOL, rtol=RTOL),
           f"paged attention ({kp.dtype}) disagrees: max abs err {err}")
    expect(same_bits(torch, (out,), (kern(),)),
           f"paged attention ({kp.dtype}): two launches give different "
           f"bits")

    # small odd shape: page 16, head_dim 64
    small = attention_case(torch, rng, 3, 4, 64, 16, 5, 24, [1, 17, 80],
                           quant, dtype)
    sq, skp, svp, sks, svs, stab, slen = small
    if quant:
        so = pa._cuda_paged_attention_quant(sq, skp, svp, sks, svs, stab,
                                            slen)
        sr = pa._plain_paged_attention_quant(sq, skp, svp, sks, svs, stab,
                                             slen)
    else:
        so = pa._cuda_paged_attention(sq, skp, svp, stab, slen)
        sr = pa._plain_paged_attention(sq, skp, svp, stab, slen)
    small_err = float((so - sr).abs().max())
    expect(torch.allclose(so, sr, atol=ATOL, rtol=RTOL),
           f"paged attention ({kp.dtype}) at S=16 D=64 disagrees: "
           f"max abs err {small_err}")
    # len 0 (outside the contract) gives zeros; the other rows still
    # agree, one of them past its table's T * S = 80 tokens (clamped)
    zq, zkp, zvp, zks, zvs, ztab, zlen = attention_case(
        torch, np.random.RandomState(7), 3, 4, 64, 16, 5, 24, [0, 17, 80],
        quant, dtype)
    zlen[2] = 100
    if quant:
        zo = pa._cuda_paged_attention_quant(zq, zkp, zvp, zks, zvs, ztab,
                                            zlen)
        zr = pa._plain_paged_attention_quant(zq, zkp, zvp, zks, zvs, ztab,
                                             zlen)
    else:
        zo = pa._cuda_paged_attention(zq, zkp, zvp, ztab, zlen)
        zr = pa._plain_paged_attention(zq, zkp, zvp, ztab, zlen)
    expect(not bool(zo[0].any()), f"paged attention ({kp.dtype}): a "
                                  f"len-0 row is not zeros")
    expect(torch.allclose(zo[1:], zr[1:], atol=ATOL, rtol=RTOL),
           f"paged attention ({kp.dtype}) beside a len-0 row, or past "
           f"T pages, disagrees")

    row = {"pool": str(kp.dtype).split(".")[-1],
           "max_abs_err": err, "max_abs_err_small": small_err,
           "bitwise_relaunch": True, "len0_zeros": True,
           "past_T_clamped": True,
           "minus1_entry_row": int(np.argmax(lens)),
           "cluster_size": pa.cluster_size(T),
           "cluster_size_small": pa.cluster_size(5)}
    if timing:
        n_tok = int(sum(lens))
        elem = kp.element_size()
        kv_bytes = 2 * n_tok * H * D * elem + (2 * n_tok * 4 if quant
                                               else 0)
        io_bytes = 2 * B * H * D * 4 + B * T * 4 + B * 4
        flops = 4 * n_tok * H * D
        t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        # library yardstick: one SDPA call over pre-gathered, contiguous
        # (dequantised) K/V with the ragged mask
        safe = table.long().clamp(min=0)
        kg = kp[safe].reshape(B, T * S, H, D).float()
        vg = vp[safe].reshape(B, T * S, H, D).float()
        if quant:
            kg = kg * ks[safe].reshape(B, T * S)[..., None, None]
            vg = vg * vs[safe].reshape(B, T * S)[..., None, None]
        kg = kg.permute(0, 2, 1, 3).contiguous()
        vg = vg.permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(T * S, device="cuda")[None, :]
                < lens_t[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        F = torch.nn.functional

        def lib():
            return F.scaled_dot_product_attention(q4, kg, vg,
                                                  attn_mask=mask)

        lib_out = lib()[:, :, 0]
        expect(torch.allclose(lib_out, ref, atol=1e-3, rtol=1e-3),
               "SDPA yardstick disagrees with the plain version")
        row.update({
            "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lib),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "live_tokens": n_tok})
    return row


SAMPLE_TOP_KS = (0, 1, 4, 8, 50, 1024)   # then V - 1 and V


def sample_rows(rng, B, V, ties):
    """(B, V) f32 logits, randn * 3; with ``ties`` each row is a hard
    case of the top-k threshold: copies of one value straddling ranks 8,
    50 and 1024, a maximum held three times, a run of +-0.0 at ranks
    50 to 1024, half the row -inf, a row of one value, ten copies of
    the minimum (rank V - 1), and one plain row."""
    x = (rng.randn(B, V) * 3).astype(np.float32)
    if not ties:
        return x
    for b in range(B):
        row, kind = x[b], b % 8
        top = np.sort(row)[::-1]
        if kind in (0, 1, 2):                     # around ranks 8, 50, 1024
            rank, copies = ((5, 10), (40, 30), (1000, 100))[kind]
            row[rng.choice(V, copies, replace=False)] = top[rank]
        elif kind == 3:                           # a tied maximum
            row[rng.choice(V, 3, replace=False)] = top[0] + 1.0
        elif kind == 4:                           # +-0.0 at ranks 50..1024
            row[:] = -np.abs(row) - 1.0
            row[:30] = np.abs(row[:30])
            row[30:30 + 600] = 0.0
            row[630:630 + 600] = -0.0
            rng.shuffle(row)
        elif kind == 5:                           # half the row -inf
            row[rng.choice(V, V // 2, replace=False)] = -np.inf
        elif kind == 6:                           # one value
            row[:] = 1.5
        elif kind == 7:                           # ten copies of the min
            row[rng.choice(V, 10, replace=False)] = top[-1] - 1.0
    return x


def check_sampling(torch, samp, rng, timing):
    """K5 against its plain version, bit for bit: top_k 0, 1, 4, 8, 50,
    1024, V - 1 and V at temperatures 0.7 and 1.0, over the engine's 8
    rows at V 32000 (the engine's vocabulary) and 50257 (GPT-2's, which
    the cluster of 8 does not divide), each on random rows and on rows of
    tied values, +-0.0 and -inf; a relaunch gives the same tokens; one
    count a call. Timed at the engine's shape at top_k 0, 8 and 50."""
    B = 8
    cases = mismatches = 0
    for V in (32000, 50257):
        for ties in (False, True):
            logits = torch.tensor(sample_rows(rng, B, V, ties),
                                  device="cuda")
            noise = torch.tensor(rng.gumbel(size=(B, V)).astype(np.float32),
                                 device="cuda")
            for top_k in SAMPLE_TOP_KS + (V - 1, V):
                for temp in (0.7, 1.0):
                    out = samp._cuda_sample(logits, noise, temp, top_k)
                    again = samp._cuda_sample(logits, noise, temp, top_k)
                    ref = samp._plain_sample(logits, noise, temp, top_k,
                                             1.0)
                    cases += 1
                    if not (torch.equal(out, ref) and torch.equal(out,
                                                                  again)):
                        mismatches += 1
    expect(mismatches == 0, f"sampling kernel disagrees bitwise in "
                            f"{mismatches} of {cases} cases")
    row = {"max_abs_err": 0.0, "bitwise_cases": cases,
           "cluster": 8, "top_ks": list(SAMPLE_TOP_KS) + ["V - 1", "V"]}
    if timing:
        V, temp = 32000, 0.8
        logits = torch.tensor(sample_rows(rng, B, V, False), device="cuda")
        noise = torch.tensor(rng.gumbel(size=(B, V)).astype(np.float32),
                             device="cuda")
        ms = {k: time_ms(torch, lambda k=k: samp._cuda_sample(
            logits, noise, temp, k)) for k in (0, 8, 50)}
        # logits and noise read once, a token written; a masked call does
        # the scale, 4 digit rounds, the mask, the add and the compare
        t_b, by = bound_of(2 * B * V * 4 + B * 4, B * V * 8,
                           F32_FLOPS_PER_S)
        row.update({
            "ms": ms[8], "ms_top_k0": ms[0], "ms_top_k50": ms[50],
            "plain_ms": time_ms(torch, lambda: samp._plain_sample(
                logits, noise, temp, 8, 1.0)),
            "library_ms": None, "bound_ms": t_b, "bound_by": by,
            "bound_rates": rates(F32_FLOPS_PER_S, "f32")})
    return row


# ---------------------------------------------------------------------------
# phases 2-4: the decode engine
# ---------------------------------------------------------------------------
def run_engine(eng, prompts, max_new):
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    outs, errors = [], []
    for h in handles:
        try:
            outs.append(h.result(timeout=600))
        except Exception as e:   # typed failure: the phase fails below
            errors.append(f"{type(e).__name__}: {e}")
            outs.append(None)
    wall = time.perf_counter() - t0
    return outs, errors, wall


def prompts_for(rng, lengths, vocab):
    return [rng.randint(1, vocab, size=n).tolist() for n in lengths]


def device_breakdown(torch, eng, prompts):
    """Device time by kernel family over a window of decode ticks only
    (profiling starts once every prompt is prefilled), under
    torch.profiler, and the device's busy share of that window. The
    engine is driven by ``run_once`` on this thread: a second profiler
    session in a process has recorded no kernel launched from the
    scheduler's thread. A window without a paged attention kernel is
    "not measured", never a number."""
    from torch.profiler import ProfilerActivity, profile

    handles = [eng.submit(p, max_new_tokens=128) for p in prompts]
    while eng.counters.get("decode_prefills", 0) < len(prompts):
        expect(not any(h.error() for h in handles),
               "the profiled window's prefills failed")
        eng.run_once()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ticks0 = eng.counters.get("decode_steps", 0)
            while eng.sched.pending():
                eng.run_once()
            eng._drain_inflight()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ticks = eng.counters.get("decode_steps", 0) - ticks0
    except RuntimeError as e:   # the profiler itself: not measured
        return {"device_ms": "not measured", "error": str(e)}
    errors = [f"{type(h.error()).__name__}: {h.error()}" for h in handles
              if h.error()]
    expect(not errors, f"profiled window failed: {errors[:3]}")
    fams = {"paged_attention": 0.0, "fused_sample": 0.0, "gemm": 0.0,
            "other": 0.0}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA" \
                or getattr(e, "is_user_annotation", False):
            continue        # a record_function range is not device work
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        name = e.name.lower()
        if "paged_attn_kernel" in name:
            fam = "paged_attention"
        elif "sample_kernel" in name:
            fam = "fused_sample"
        elif "gemm" in name or "gemv" in name or "cutlass" in name \
                or "sm90_xmma" in name:
            fam = "gemm"
        else:
            fam = "other"
        fams[fam] += us / 1e3
    if ticks > 0 and fams["paged_attention"] <= 0:
        return {"device_ms": "not measured", "ticks": ticks,
                "recorded_ms": fams,
                "reason": "no paged attention kernel in the window"}
    # the profiler's own host work stretches the window's ticks, so the
    # busy share reads low; the device ms a tick does not
    busy = sum(fams.values())
    return {"window_ms": wall * 1e3, "ticks": ticks, "device_ms": fams,
            "device_ms_per_tick": busy / max(1, ticks),
            "device_busy_share": busy / (wall * 1e3)}


def tick_recorder(eng):
    """Each tick's dispatch + host + fetch ms as the engine notes them:
    the exact per-tick times beside ``decode_step_ms``'s buckets."""
    ticks, real = [], eng._note_phases

    def note(dispatch_ms, host_ms, fetch_ms):
        ticks.append(dispatch_ms + host_ms + fetch_ms)
        real(dispatch_ms, host_ms, fetch_ms)

    eng._note_phases = note
    return ticks


def step_stats(eng, launches, n_layers, wall, n_tok, tick_ms):
    """One leg's decode figures, read from the engine (its histograms
    and tick phase sums) and from ``tick_recorder``'s list, not from
    wrapping its step: under the async tick a step's wall time is not
    its device time."""
    c = eng.counters
    ticks = c["decode_steps"]
    lat = eng.engine_latency_stats()
    hist = eng._h_step.snapshot()
    phases = eng.tick_phase_totals()
    n = max(1, int(hist["count"]))
    expect(len(tick_ms) == ticks, f"{len(tick_ms)} ticks noted, "
                                  f"{ticks} counted")
    return {
        "tokens_per_s": n_tok / wall, "wall_s": wall,
        "decode_ticks": ticks, "prefills": c["decode_prefills"],
        # exact, over each tick's dispatch + host + fetch
        "tick_p50_ms": float(np.percentile(tick_ms, 50)),
        "tick_p99_ms": float(np.percentile(tick_ms, 99)),
        "tick_max_ms": max(tick_ms),
        # bucket-interpolated (the engine's decode_step_ms ladder: ...,
        # 10, 25, 50 ms); the mean is exact
        "step_p50_ms": lat["step_p50_ms"], "step_p99_ms": lat["step_p99_ms"],
        "step_mean_ms": hist["sum"] / n,
        "prefill_p50_ms": lat["prefill_p50_ms"],
        "tick_phase_mean_ms": {k: v / n for k, v in phases.items()},
        "decode_overlap_frac": c.get("decode_overlap_frac"),
        "mfu": c.get("mfu"), "step_model_flops": c.get("step_model_flops"),
        "launches": launches,
        "attention_launches_per_tick": n_layers,
    }


def sync_points_in_dispatch(torch, eng, prompts, max_new):
    """Drive ``eng`` on this thread and count the synchronising CUDA
    calls ``torch.cuda.set_sync_debug_mode`` flags inside the async
    dispatch (control upload, the step, the fetch's copy and event):
    the pipeline's rule is that there are none. Returns (the count, a
    few messages, the outputs)."""
    import warnings

    real = eng._dispatch_async
    flagged = []

    def watched(*a):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = real(*a)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        flagged.extend(str(w.message)[:200] for w in seen
                       if "called a synchronizing" in str(w.message))
        return out

    eng._dispatch_async = watched
    eng.sched.accepting = True       # not started: admit on this thread
    try:
        handles = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        while eng.sched.pending():
            eng.run_once()
        eng._drain_inflight()
        outs = [h.result(timeout=60) for h in handles]
    finally:
        del eng._dispatch_async
    return len(flagged), flagged[:3], outs


INT8_LEG_ORDER = ("async", "sync", "sync", "async")


def int8_engine(dec, params, cfg, leg):
    eng = dec.DecodeEngine(cfg, params=params, n_pages=512, kv_codec="int8",
                           async_decode=None if leg == "async" else False,
                           **ENGINE)
    eng.warm()
    expect(eng._async_decode is (leg == "async"),
           f"the {leg} leg runs the wrong tick")
    return eng


def phase_int8(torch, dec, counters, params, cfg, rng):
    """The README configuration over an int8 pool: the async tick (the
    default) and the sync tick (``async_decode=False``) on the same
    prompts, each run twice in turn (async, sync, sync, async; a fresh
    engine a run) after an untimed pass, tokens identical; K4b n_layers
    times a tick in every run. The profiled windows come after every
    timed run, one a leg in a fresh engine, then the dispatch's sync
    check."""
    lengths = np.linspace(16, 1500, 16).astype(int).tolist()
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    # an untimed pass first: a process's first prefill at each prompt
    # length pays for its GEMM shapes, which would fall on the first leg
    eng = int8_engine(dec, params, cfg, "sync")
    eng.start()
    try:
        run_engine(eng, prompts, 2)
    finally:
        eng.stop()
    del eng
    runs, total, first = {"async": [], "sync": []}, {}, None
    for leg in INT8_LEG_ORDER:
        eng = int8_engine(dec, params, cfg, leg)
        tick_ms = tick_recorder(eng)
        eng.start()
        try:
            counters.reset()
            outs, errors, wall = run_engine(eng, prompts, 32)
            torch.cuda.synchronize()
            launches = counters.snapshot()
        finally:
            eng.stop()
        c = eng.counters
        expect(not errors, f"int8 engine ({leg}) requests failed: "
                           f"{errors[:3]}")
        expect(c.get("decode_failed", 0) == 0, "decode_failed > 0")
        expect(all(len(o) == 32 and all(0 <= t < cfg.vocab_size
                                        for t in o) for o in outs),
               f"int8 engine ({leg}) emitted malformed tokens")
        ticks = c["decode_steps"]
        k4b = launches.get("paged_attention_quant", 0)
        expect(k4b == cfg.n_layers * ticks,
               f"int8 attention ({leg}) launched {k4b} times, want "
               f"n_layers x ticks = {cfg.n_layers} x {ticks}")
        first = outs if first is None else first
        expect(outs == first, f"the {leg} tick gave other tokens")
        runs[leg].append(step_stats(eng, launches, cfg.n_layers, wall,
                                    sum(len(o) for o in outs), tick_ms))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del eng
        torch.cuda.empty_cache()
    row = {"phase": "int8_engine", "requests": len(prompts),
           "prompt_tokens": int(sum(lengths)), "max_new_tokens": 32,
           "tokens_identical": True, "order": list(INT8_LEG_ORDER)}
    for leg in ("async", "sync"):
        for attempt in (1, 2):     # the profiler can miss a window's kernels
            eng = int8_engine(dec, params, cfg, leg)
            busy = device_breakdown(torch, eng, prompts[::2])
            busy["attempts"] = attempt
            if isinstance(busy["device_ms"], dict):
                break
            if attempt == 1:
                del eng
                torch.cuda.empty_cache()
        row[leg] = {"runs": runs[leg], "breakdown": busy,
                    "tokens_per_s": [r["tokens_per_s"] for r in runs[leg]]}
        if leg == "async":
            n_sync, msgs, sync_outs = sync_points_in_dispatch(
                torch, eng, prompts[:3], 12)
            expect(n_sync == 0, f"the async dispatch synchronised "
                                f"{n_sync} times: {msgs}")
            expect(sync_outs == [o[:12] for o in first[:3]],
                   "the main-thread async drive disagrees with the leg")
            row["dispatch_sync_points"] = n_sync
        del eng
        torch.cuda.empty_cache()
    return row, total


def kv_round_trip(torch, dec, kind):
    """What a pool of ``kind`` does to a K/V row: bf16 and f16 round,
    int8 quantizes per token row; None for an f32 pool."""
    if kind == "int8":
        from paddle_tpu_torch.ps.codec import decode_kv_rows, encode_kv_rows

        return lambda x: decode_kv_rows(*encode_kv_rows(x))
    if kind in ("bfloat16", "float16"):
        dt = getattr(torch, kind)
        return lambda x: x.to(dt).float()
    return None


def top2_gap(torch, dec, cfg, params, tokens, pool=None):
    """The dense forward's top-2 logit gap at the end of ``tokens``,
    with K and V as the engine's pool holds them (``pool``: "int8",
    "bfloat16", "float16" or None for f32)."""
    import math

    rt = kv_round_trip(torch, dec, pool)
    dev = params["tok_emb"].device
    ids = torch.tensor([tokens], device=dev)
    L = len(tokens)
    h = params["tok_emb"][ids] + params["pos_emb"][:L][None]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))

    def attn(i, q, k, v):
        if rt is not None:
            k, v = rt(k), rt(v)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(cfg.head_dim)
        s = torch.where(causal[None, None], s, torch.full_like(s, -1e30))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    with torch.no_grad():
        logits = dec.model._forward_layers(cfg, params, h, attn)[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def match_except_ties(torch, dec, cfg, params, prompts, outs, refs, pool,
                      what):
    """Each output equals its reference, or they part at a near tie: a
    top-2 gap < 1e-3 of the dense forward (K/V as ``pool`` holds them)
    at the first differing token. Returns (matched, ties)."""
    ties, matched = [], 0
    for p, out, ref in zip(prompts, outs, refs):
        diverge = next((i for i, (a, b) in enumerate(zip(out, ref))
                        if a != b), None)
        if diverge is None and len(out) == len(ref):
            matched += 1
            continue
        expect(diverge is not None, f"{what}: outputs of other lengths")
        gap = top2_gap(torch, dec, cfg, params, p + ref[:diverge], pool)
        expect(gap < 1e-3, f"{what} diverged at token {diverge} with a "
                           f"top-2 gap of {gap}")
        ties.append({"prompt_len": len(p), "token": diverge, "gap": gap})
    return matched, ties


def phase_f32(torch, dec, counters, params, cfg, rng):
    eng = dec.DecodeEngine(cfg, params=params, n_pages=160, **ENGINE)
    eng.warm()
    expect(eng._async_decode, "the f32 engine does not run the async tick")
    eng.start()
    lengths = [16, 300, 700, 1100]
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    max_new = 16
    counters.reset()
    outs, errors, wall = run_engine(eng, prompts, max_new)
    torch.cuda.synchronize()
    launches = counters.snapshot()
    c = eng.counters
    eng.stop()
    expect(not errors, f"f32 engine requests failed: {errors[:3]}")
    expect(c.get("decode_failed", 0) == 0, "decode_failed > 0")
    expect(launches.get("paged_attention", 0) == cfg.n_layers
           * c["decode_steps"], "the f32 attention kernel was not launched "
                                "n_layers times a tick")
    del eng
    torch.cuda.empty_cache()
    refs = [dec.reference_generate(cfg, params, p, max_new) for p in prompts]
    matched, ties = match_except_ties(torch, dec, cfg, params, prompts, outs,
                                      refs, None, "f32 engine")
    return {"phase": "f32_engine", "async": True, "requests": len(prompts),
            "matched_oracle": matched, "ties": ties, "wall_s": wall,
            "decode_ticks": c["decode_steps"],
            "launches": launches}, launches


def plain_attention(pa):
    """The paged attention entry with the kernels' plain versions (a
    ``swapped`` target for ``model.paged_attention``)."""
    def attend(q, k_pages, v_pages, page_table, seq_lens, k_scales=None,
               v_scales=None):
        if k_scales is not None:
            return pa._plain_paged_attention_quant(
                q, k_pages, v_pages, k_scales, v_scales, page_table,
                seq_lens)
        return pa._plain_paged_attention(q, k_pages, v_pages, page_table,
                                         seq_lens)
    return attend


def phase_2byte(torch, dec, counters, params, cfg, rng, pa):
    """``dtype="bfloat16"`` and ``"float16"``: K4a over 2-byte pages,
    n_layers launches a tick; tokens equal a run with the plain versions
    swapped in, except at a near tie."""
    lengths = [16, 300, 700, 1100]
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    max_new = 16
    row, total = {"phase": "bf16_engine", "requests": len(prompts)}, {}
    for dtype, counter in (("bfloat16", "paged_attention_bf16"),
                           ("float16", "paged_attention_f16")):
        runs = []
        for plain in (False, True):
            eng = dec.DecodeEngine(cfg, params=params, n_pages=160,
                                   dtype=dtype, **ENGINE)
            eng.warm()
            expect(eng._k_pages.dtype == getattr(torch, dtype),
                   f"the pool is not {dtype}")
            counters.reset()
            swaps = [(dec.model, "paged_attention", plain_attention(pa))] \
                if plain else []
            with swapped(swaps):
                eng.start()
                outs, errors, wall = run_engine(eng, prompts, max_new)
                eng.stop()
            torch.cuda.synchronize()
            launches = counters.snapshot()
            c = eng.counters
            expect(not errors, f"{dtype} engine requests failed: "
                               f"{errors[:3]}")
            if plain:
                expect(launches.get(counter, 0) == 0,
                       "the plain run launched the kernel")
            else:
                got = launches.get(counter, 0)
                expect(got == cfg.n_layers * c["decode_steps"],
                       f"{counter} launched {got} times, want "
                       f"{cfg.n_layers} x {c['decode_steps']}")
                leg = {"launches": launches, "wall_s": wall,
                       "decode_ticks": c["decode_steps"],
                       "tokens_per_s": sum(map(len, outs)) / wall}
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            runs.append(outs)
            del eng
            torch.cuda.empty_cache()
        leg["matched_plain"], leg["ties"] = match_except_ties(
            torch, dec, cfg, params, prompts, runs[0], runs[1], dtype,
            f"{dtype} engine against its plain run")
        row[dtype] = leg
    return row, total


def motif_prompts(rng, vocab, n, motif_len, reps):
    """Prompts made of a random motif repeated (templated or retrieval-
    stuffed text), where the n-gram proposer finds drafts."""
    return [np.tile(rng.randint(1, vocab, size=motif_len), reps).tolist()
            for _ in range(n)]


def phase_spec(torch, dec, counters, params, cfg, rng):
    """``spec_k=4`` over an int8 pool: tokens equal a non-spec engine's
    except at near ties; K4b n_layers times a verify tick."""
    prompts = motif_prompts(rng, cfg.vocab_size, 4, 48, 6) \
        + prompts_for(rng, [200, 900, 40, 600], cfg.vocab_size)
    max_new = 48
    res = {}
    for spec_k in (4, 0):
        eng = dec.DecodeEngine(cfg, params=params, n_pages=256,
                               kv_codec="int8", spec_k=spec_k, **ENGINE)
        eng.warm()
        eng.start()
        counters.reset()
        outs, errors, wall = run_engine(eng, prompts, max_new)
        eng.stop()
        torch.cuda.synchronize()
        launches = counters.snapshot()
        c = eng.counters
        expect(not errors, f"spec_k={spec_k} requests failed: {errors[:3]}")
        res[spec_k] = (outs, wall, launches, c)
        del eng
        torch.cuda.empty_cache()
    outs, wall, launches, c = res[4]
    ticks = c["decode_steps"]
    expect(launches.get("paged_attention_quant", 0) == cfg.n_layers * ticks,
           f"spec: K4b launched {launches.get('paged_attention_quant')} "
           f"times, want {cfg.n_layers} x {ticks} verify ticks")
    matched, ties = match_except_ties(torch, dec, cfg, params, prompts,
                                      outs, res[0][0], "int8",
                                      "spec engine against the plain one")
    n_tok = sum(map(len, outs))
    return {"phase": "spec_engine", "spec_k": 4, "requests": len(prompts),
            "matched_non_spec": matched, "ties": ties,
            "spec_proposed": c.get("spec_proposed", 0),
            "spec_accepted": c.get("spec_accepted", 0),
            "spec_accept_rate": c.get("spec_accept_rate", 0.0),
            "verify_ticks": ticks, "non_spec_ticks": res[0][3]["decode_steps"],
            "tokens_per_s": n_tok / wall,
            "non_spec_tokens_per_s": n_tok / res[0][1],
            "launches": launches}, launches


def phase_host_tier(torch, dec, counters, params, cfg, rng):
    """An int8 pool too small for the batch: sessions park to the host
    tier and resume through the prefetcher; tokens bitwise a big-pool
    twin's (int8 pages park verbatim)."""
    prompts = prompts_for(rng, [500] * 8, cfg.vocab_size)
    max_new = 200
    res = {}
    for name, n_pages, tier in (("tight", 33, 1 << 32), ("twin", 512, 0)):
        eng = dec.DecodeEngine(cfg, params=params, n_pages=n_pages,
                               kv_codec="int8", host_kv_bytes=tier, **ENGINE)
        eng.warm()
        eng.start()
        counters.reset()
        outs, errors, wall = run_engine(eng, prompts, max_new)
        eng.stop()
        torch.cuda.synchronize()
        expect(not errors, f"host tier ({name}) requests failed: "
                           f"{errors[:3]}")
        launches, c = counters.snapshot(), eng.counters
        k4b = launches.get("paged_attention_quant", 0)
        expect(k4b == cfg.n_layers * c["decode_steps"],
               f"host tier ({name}): K4b launched {k4b} times, want "
               f"{cfg.n_layers} x {c['decode_steps']} ticks")
        res[name] = (outs, wall, launches, c, eng.engine_latency_stats())
        del eng
        torch.cuda.empty_cache()
    outs, wall, launches, c, lat = res["tight"]
    parked = c.get("kv_sessions_parked", 0)
    resumed = c.get("kv_sessions_resumed", 0)
    fallbacks = c.get("kv_restore_fallbacks", 0)
    expect(parked >= 1, "no session parked")
    expect(resumed - fallbacks >= 1, "no resume came from the prefetcher")
    expect(c.get("decode_preempted", 0) == 0, "a session was preempted")
    expect(outs == res["twin"][0],
           "parked sessions' tokens differ from the big-pool twin's")
    return {"phase": "host_tier", "requests": len(prompts),
            "n_pages": 33, "bitwise_twin": True, "parked": parked,
            "resumed": resumed, "restore_fallbacks": fallbacks,
            "offload_bytes": c.get("kv_offload_bytes", 0),
            "page_restores": c.get("kv_page_restores", 0),
            "restore_wait_p99_ms": lat["restore_wait_p99_ms"],
            "wall_s": wall, "twin_wall_s": res["twin"][1],
            "decode_ticks": c["decode_steps"], "launches": launches}, launches


def phase_adopt(torch, dec, counters, params, cfg, rng):
    """The port's PrefillWorker ships an int8 frame of a 1100-token
    prompt's 8 full pages; the engine adopts it, shares those pages at
    the prompt's prefill and writes only the suffix's; tokens equal a
    locally prefilled twin's except at near ties."""
    from paddle_tpu_torch.serving import MigrationClient, PrefillWorker

    S = ENGINE["page_size"]
    prompt = prompts_for(rng, [1100], cfg.vocab_size)[0]
    worker = PrefillWorker(cfg, params=params, page_size=S)
    t0 = time.perf_counter()
    shipment = worker.prefill(prompt)
    ship_ms = (time.perf_counter() - t0) * 1e3
    expect(shipment.n_pages == 1100 // S, "the frame misses full pages")
    outs = {}
    for name in ("adopt", "local"):
        eng = dec.DecodeEngine(cfg, params=params, n_pages=64,
                               kv_codec="int8", **ENGINE)
        eng.warm()
        eng.start()
        counters.reset()
        if name == "adopt":
            t0 = time.perf_counter()
            rep = MigrationClient(eng.adopt_pages).migrate(shipment)
            adopt_ms = (time.perf_counter() - t0) * 1e3
            expect(rep["ok"] and rep["adopted"] == shipment.n_pages,
                   f"adoption failed: {rep}")
        hits0 = eng.pool.prefix_hits
        out, errors, _ = run_engine(eng, [prompt], 32)
        eng.stop()
        torch.cuda.synchronize()
        expect(not errors, f"adopt ({name}) request failed: {errors}")
        hits = eng.pool.prefix_hits - hits0
        got, ticks = counters.snapshot(), eng.counters["decode_steps"]
        k4b = got.get("paged_attention_quant", 0)
        expect(k4b == cfg.n_layers * ticks,
               f"adopt ({name}): K4b launched {k4b} times, want "
               f"{cfg.n_layers} x {ticks} ticks")
        if name == "adopt":
            expect(hits == shipment.n_pages,
                   f"the prefill shared {hits} pages, want "
                   f"{shipment.n_pages}")
            launches, adopt_ticks = got, ticks
        else:
            expect(hits == 0, "the local twin hit a prefix")
        outs[name] = out[0]
        del eng
        torch.cuda.empty_cache()
    matched, ties = match_except_ties(torch, dec, cfg, params, [prompt],
                                      [outs["adopt"]], [outs["local"]],
                                      "int8", "adopted against local")
    return {"phase": "adopt", "prompt_tokens": len(prompt),
            "frame_bytes": len(shipment.frame),
            "encoded_bytes": shipment.encoded_bytes,
            "f32_bytes": shipment.f32_bytes, "shared_pages": shipment.n_pages,
            "suffix_tokens": len(prompt) - shipment.n_pages * S,
            "prefill_worker_ms": ship_ms, "adopt_ms": adopt_ms,
            "matched_local": matched, "ties": ties,
            "decode_ticks": adopt_ticks, "launches": launches}, launches


FLEET_SESSIONS = 8
FLEET_NEW = 32


def fleet_engines(dec, params, cfg):
    """Two README-width int8 engines on the card over one params dict,
    128 pages each, warmed and started."""
    engines = []
    for _ in range(2):
        e = dec.DecodeEngine(cfg, params=params, n_pages=128,
                             kv_codec="int8", **ENGINE)
        e.warm()
        e.start()
        engines.append(e)
    return engines


def fleet_leg(torch, counters, router, engines, prompts, cfg, kill=False):
    """Route every prompt (session i each) through ``router``; with
    ``kill`` the replica pinned to session 0 is stopped once that
    session's first chunk lands. Returns (tokens, figures)."""
    stopped = []

    def on_chunk(emitted):
        if not stopped:
            name = router.session_replica("s0")
            idx = [r.name for r in router.replicas].index(name)
            engines[idx].stop()
            stopped.append(name)

    counters.reset()
    t0 = time.perf_counter()
    handles = [router.submit(p, max_new_tokens=FLEET_NEW, session=f"s{i}",
                             on_chunk=on_chunk if kill and i == 0 else None)
               for i, p in enumerate(prompts)]
    outs, errors = [], []
    for h in handles:
        try:
            outs.append(h.result(timeout=600))
        except Exception as e:   # typed failure: the phase fails below
            errors.append(f"{type(e).__name__}: {e}")
            outs.append(None)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = counters.snapshot()
    expect(not errors, f"fleet requests failed: {errors[:3]}")
    expect(all(len(o) == FLEET_NEW and all(0 <= t < cfg.vocab_size
                                           for t in o) for o in outs),
           "the fleet emitted malformed tokens")
    ticks = [e.counters.get("decode_steps", 0) for e in engines]
    k4b = launches.get("paged_attention_quant", 0)
    expect(k4b == cfg.n_layers * sum(ticks),
           f"K4b launched {k4b} times, want n_layers x ticks = "
           f"{cfg.n_layers} x {ticks}")
    c = router.counters
    lat = router.engine_latency_stats()
    return outs, {
        "tokens_per_s": sum(len(o) for o in outs) / wall, "wall_s": wall,
        "e2e_p50_ms": lat["e2e_p50_ms"], "e2e_p99_ms": lat["e2e_p99_ms"],
        "dispatches": c.get("router_dispatches", 0),
        "affinity_hits": c.get("router_affinity_hits", 0),
        "failovers": c.get("router_failovers", 0),
        "replays": c.get("router_replays", 0),
        "ticks_per_engine": ticks, "launches": launches,
        "stopped": stopped}


def http_get(endpoint, path):
    import http.client

    host, _, port = endpoint.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_fleet(torch, dec, counters, params, cfg, rng):
    """The port's FleetRouter (chunk_tokens 8) over two README-width
    int8 engines, 8 sessions of 16-1000 prompt tokens and 32 new each:
    leg A unkilled through LocalReplica; leg B on fresh engines with
    session 0's replica stopped after its first chunk (failover +
    replay; tokens equal A's except at a top-2 gap < 1e-3, each such
    tie printed); leg C through two DecodeEngineServers on loopback and
    HTTPReplica (tokens as B's rule), then GET /metrics per server
    parsed, one FleetSLOSignal refresh, a PrefillWorker frame of a
    1100-token prompt PUT to /adopt on both servers and that prompt
    routed with prefix hits, and a malformed frame answered 400
    MalformedPageFrame. K4b n_layers times a tick in every leg."""
    import http.client

    from paddle_tpu_torch.observability import parse_prometheus_text
    from paddle_tpu_torch.serving import (DecodeEngineServer, FleetRouter,
                                          FleetSLOSignal, HTTPReplica,
                                          LocalReplica, MalformedPageFrame,
                                          MigrationClient, PrefillWorker)

    lengths = np.linspace(16, 1000, FLEET_SESSIONS).astype(int).tolist()
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    row = {"phase": "fleet", "sessions": FLEET_SESSIONS,
           "prompt_tokens": int(sum(lengths)), "max_new_tokens": FLEET_NEW,
           "chunk_tokens": 8, "engines": 2, "n_pages": 128,
           "kv_codec": "int8"}
    total, outs = {}, {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    for leg in ("A", "B"):
        engines = fleet_engines(dec, params, cfg)
        router = FleetRouter([LocalReplica(e, name=f"local:{i}")
                              for i, e in enumerate(engines)],
                             chunk_tokens=8, config=cfg)
        try:
            outs[leg], fig = fleet_leg(torch, counters, router, engines,
                                       prompts, cfg, kill=leg == "B")
        finally:
            router.stop()
        add(fig["launches"])
        if leg == "A":
            expect(all(t > 0 for t in fig["ticks_per_engine"]),
                   f"an engine served nothing: {fig['ticks_per_engine']}")
        else:
            expect(fig["failovers"] >= 1 and fig["replays"] >= 1,
                   f"no failover/replay: {fig}")
            matched, ties = match_except_ties(
                torch, dec, cfg, params, prompts, outs["B"], outs["A"],
                "int8", "fleet failover against unkilled")
            fig.update(matched_unkilled=matched, near_ties=ties)
        row[f"leg_{leg}"] = fig
        del router, engines
        torch.cuda.empty_cache()

    engines = fleet_engines(dec, params, cfg)
    # an int8 frame of 8 README-width pages is ~100 MB: past the
    # listener's default 64 MiB body cap (a 413), so the cap is raised
    servers = [DecodeEngineServer(e, port=0, max_body_bytes=256 << 20)
               .start() for e in engines]
    try:
        replicas = [HTTPReplica(s.endpoint) for s in servers]
        router = FleetRouter(replicas, chunk_tokens=8, config=cfg)
        outs["C"], fig = fleet_leg(torch, counters, router, engines,
                                   prompts, cfg)
        add(fig["launches"])
        matched, ties = match_except_ties(
            torch, dec, cfg, params, prompts, outs["C"], outs["A"], "int8",
            "fleet over HTTP against local")
        fig.update(matched_unkilled=matched, near_ties=ties)
        scraped = []
        for s in servers:
            status, body = http_get(s.endpoint, "/metrics")
            samples = parse_prometheus_text(body.decode())
            expect(status == 200 and samples.get("decode_requests", 0) > 0
                   and samples.get("decode_steps", 0) > 0,
                   f"/metrics on {s.endpoint} lacks the decode counters")
            scraped.append(len(samples))
        fig["metrics_samples"] = scraped
        slo = FleetSLOSignal([s.endpoint for s in servers])
        fig["slo_burning"] = sorted(slo.refresh())
        fig["scale_hint"] = slo.scale_hint()
        S = ENGINE["page_size"]
        prompt = prompts_for(rng, [1100], cfg.vocab_size)[0]
        shipment = PrefillWorker(cfg, params=params,
                                 page_size=S).prefill(prompt)
        reports = [MigrationClient(r.adopt).migrate(shipment)
                   for r in replicas]
        expect(all(rep["ok"] and rep["adopted"] == shipment.n_pages
                   for rep in reports), f"PUT /adopt failed: {reports}")
        hits0 = sum(e.pool.prefix_hits for e in engines)
        adopted_out = router.generate(prompt, max_new_tokens=FLEET_NEW,
                                      timeout=600)
        hits = sum(e.pool.prefix_hits for e in engines) - hits0
        expect(hits >= shipment.n_pages and len(adopted_out) == FLEET_NEW,
               f"the adopted prompt shared {hits} pages")
        try:
            replicas[0].adopt(b"not a page frame")
            expect(False, "a malformed frame was adopted")
        except MalformedPageFrame:
            pass
        conn = http.client.HTTPConnection(replicas[0].host,
                                          replicas[0].port, timeout=30)
        conn.request("PUT", "/adopt", body=b"garbage")
        resp = conn.getresponse()
        resp.read()
        conn.close()
        expect(resp.status == 400 and resp.getheader("X-Paddle-Error")
               == "MalformedPageFrame", "a bad frame was not a typed 400")
        fig.update(adopt_frame_bytes=len(shipment.frame),
                   adopt_prefix_hits=hits, malformed_status=resp.status)
        row["leg_C"] = fig
    finally:
        for s in servers:
            s.stop()
        for e in engines:
            e.stop()
    del engines, servers
    torch.cuda.empty_cache()
    row["near_ties"] = len(row["leg_B"]["near_ties"]) + \
        len(row["leg_C"]["near_ties"])
    return row, total


def phase_sample(torch, dec, counters, params, cfg, rng):
    lengths = [20, 150, 400, 900]
    prompts = prompts_for(rng, lengths, cfg.vocab_size)
    runs, total = [], {}
    for _ in range(2):
        eng = dec.DecodeEngine(cfg, params=params, n_pages=512,
                               kv_codec="int8", temperature=0.8, top_k=8,
                               sample_seed=7, **ENGINE)
        eng.warm()
        eng.start()
        counters.reset()
        outs, errors, wall = run_engine(eng, prompts, 24)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        c = eng.counters
        eng.stop()
        del eng
        torch.cuda.empty_cache()
        expect(not errors, f"sampling engine requests failed: {errors[:3]}")
        expect(c.get("decode_failed", 0) == 0, "decode_failed > 0")
        expect(launches.get("fused_sample", 0) > 0,
               "the sampling kernel was not launched")
        runs.append(outs)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    expect(runs[0] == runs[1], "two seeded sampling runs differ")
    expect(all(0 <= t < cfg.vocab_size for o in runs[0] for t in o),
           "sampled tokens out of vocabulary")
    return {"phase": "sampling_engine", "requests": len(prompts),
            "replayed": True, "launches": total}, total


# ---------------------------------------------------------------------------
# phase 1, training kernels: flash attention, fused xent, fused Adam
# ---------------------------------------------------------------------------
def rates(flops_per_s, kind):
    """The rates a row's bounds are taken at."""
    return {"bytes_per_s": HBM_BYTES_PER_S, "ops_per_s": flops_per_s,
            "ops_type": kind}


def bound_of(bytes_, flops, rate):
    """(least ms, what bounds it) for ``bytes_`` moved once and
    ``flops`` at ``rate``."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def same_bits(torch, first, second):
    """Whether two launches' outputs are equal bit for bit (compared as
    integers of their width, so -0.0 and NaN payloads count too)."""
    ints = {2: torch.int16, 4: torch.int32}
    return len(first) == len(second) and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.contiguous().view(ints[a.element_size()]),
            b.contiguous().view(ints[b.element_size()]))
        for a, b in zip(first, second))


def check_flash(torch, fa, timing):
    """K1a/K1b against the plain version: BERT-base's shapes in bf16 and
    f32 with dropout 0.1, f32 at L = 512, f32 causal, GPT-2 small's
    causal 8 x 1024 in bf16, and bf16 with Lq != Lk, a ragged causal L
    and D = 128; two launches of each bf16 kernel give the same bits;
    the dropout mask read back bit for bit. Times K1a at BERT's shape
    and at GPT-2's causal one beside SDPA."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    cases = [("bf16", 128, 128, 128, 12, 64, bf, False, 0.1),
             ("f32", 128, 128, 128, 12, 64, torch.float32, False, 0.1),
             ("f32_L512", 8, 512, 512, 12, 64, torch.float32, False, 0.0),
             ("f32_causal", 8, 256, 256, 12, 64, torch.float32, True, 0.1),
             ("bf16_causal_L1024", 8, 1024, 1024, 12, 64, bf, True, 0.0),
             ("bf16_Lq_ne_Lk", 4, 200, 333, 12, 64, bf, False, 0.1),
             ("bf16_ragged_causal", 4, 200, 200, 12, 64, bf, True, 0.1),
             ("bf16_D128", 4, 256, 256, 12, 128, bf, False, 0.1)]
    seed = 0x5EED1234ABCD
    row = {"cases": {}}
    main = gpt = None
    for name, B, Lq, Lk, H, D, dt, causal, p in cases:
        q, k, v, do = [torch.randn((B, n, H, D), generator=gen,
                                   device=dev).to(dt)
                       for n in (Lq, Lk, Lk, Lq)]
        out, lse = fa._cuda_fwd(q, k, v, causal, p, seed)
        rout, rlse = fa._plain_fwd(q, k, v, causal, p, seed)
        grads = fa._cuda_bwd(q, k, v, out, lse, do, causal, p, seed)
        rgrads = fa._plain_bwd(q, k, v, rout, rlse, do, causal, p, seed)
        torch.cuda.synchronize()
        atol, rtol = (2e-2, 1e-2) if dt == torch.bfloat16 else (1e-4, 0.0)
        errs = {"out": max_err(out, rout), "lse": max_err(lse, rlse)}
        for gname, got, want in zip(("dq", "dk", "dv"), grads, rgrads):
            errs[gname] = max_err(got, want)
            expect(bool(torch.isfinite(got.float()).all()),
                   f"flash {name}: non-finite {gname}")
            expect(torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol),
                   f"flash {name}: {gname} disagrees, max abs err "
                   f"{errs[gname]}")
        expect(torch.allclose(out.float(), rout.float(), atol=atol,
                              rtol=rtol),
               f"flash {name}: out disagrees, max abs err {errs['out']}")
        expect(errs["lse"] <= 1e-4, f"flash {name}: lse err {errs['lse']}")
        if dt == torch.bfloat16:
            expect(same_bits(torch, (out, lse) + grads, fa._cuda_fwd(
                q, k, v, causal, p, seed) + fa._cuda_bwd(
                q, k, v, out, lse, do, causal, p, seed)),
                f"flash {name}: two launches give different bits")
        row["cases"][name] = errs
        if name == "bf16":
            main = (q, k, v, do, out, lse, p)
        elif name == "bf16_causal_L1024":
            gpt = (q, k, v)
        del q, k, v, do, rout, grads, rgrads
    row["wide"] = wide_rows(torch, fa, "stream", gen,
                            wide_cases(torch, WIDE_FLASH), seed, timing)
    # the dropout mask, bit for bit: q = k = 0 gives P = 1/L, v = I reads
    # keep / (L (1 - p)) back out of the kernel's output
    L, p = 64, 0.1
    z = torch.zeros((4, L, 3, 64), device=dev)
    eye = torch.eye(L, device=dev).reshape(1, L, 1, 64).expand(4, L, 3, 64)
    out, _ = fa._cuda_fwd(z, z, eye.contiguous(), False, p, seed)
    keep = fa.philox_keep_mask(seed, 12, L, L, p, dev)
    got = (out > 0).permute(0, 2, 1, 3).reshape(12, L, L)
    expect(torch.equal(got, keep), "flash dropout mask differs from the "
                                   "plain Philox mask")
    row["mask_bitwise"] = True
    row["keep_rate"] = float(keep.float().mean())
    row["fwd_max_abs_err"] = max(c["out"] for c in row["cases"].values())
    row["bwd_max_abs_err"] = max(max(c["dq"], c["dk"], c["dv"])
                                 for c in row["cases"].values())
    if timing:
        q, k, v, do, out, lse, p = main
        B, L, H, D = q.shape
        el = B * L * H * D * 2                      # one bf16 tensor
        # forward: q, k, v in, out and lse out; QK^T and PV at bf16 rate
        fb, fby = bound_of(4 * el + B * H * L * 4, 4 * B * H * L * L * D,
                           BF16_FLOPS_PER_S)
        # backward: q, k, v, out, dout, lse in; dq, dk, dv out; S, dP,
        # dV, dQ, dK products
        bb, bby = bound_of(8 * el + B * H * L * 4, 10 * B * H * L * L * D,
                           BF16_FLOPS_PER_S)
        F = torch.nn.functional
        qh, kh, vh, doh = (x.permute(0, 2, 1, 3).contiguous()
                           for x in (q, k, v, do))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))

        def lib_fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, dropout_p=p)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p)
            return torch.autograd.grad(o, (qg, kg, vg), doh)

        lib_out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qg, kg, vg), doh,
                                       retain_graph=True)

        row.update({
            "fwd_ms": time_ms(torch, lambda: fa._cuda_fwd(
                q, k, v, False, p, seed)),
            "fwd_plain_ms": time_ms(torch, lambda: fa._plain_fwd(
                q, k, v, False, p, seed), iters=5),
            "fwd_library_ms": time_ms(torch, lib_fwd),
            "fwd_bound_ms": fb, "fwd_bound_by": fby,
            "bwd_ms": time_ms(torch, lambda: fa._cuda_bwd(
                q, k, v, out, lse, do, False, p, seed)),
            "bwd_plain_ms": time_ms(torch, lambda: fa._plain_bwd(
                q, k, v, out, lse, do, False, p, seed), iters=5),
            "fwd_bwd_library_ms": time_ms(torch, lib_fwd_bwd),
            "bwd_library_ms": time_ms(torch, lib_bwd),
            "bwd_bound_ms": bb, "bwd_bound_by": bby,
            "bound_rates": rates(BF16_FLOPS_PER_S, "bf16 tensor-core")})
        # GPT-2 small's causal forward beside causal SDPA: the products
        # below the diagonal only
        q, k, v = gpt
        B, L, H, D = q.shape
        el = B * L * H * D * 2
        cb, cby = bound_of(4 * el + B * H * L * 4,
                           4 * B * H * D * L * (L + 1) // 2,
                           BF16_FLOPS_PER_S)
        qh, kh, vh = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, v))
        row.update({
            "causal_L1024_fwd_ms": time_ms(torch, lambda: fa._cuda_fwd(
                q, k, v, True, 0.0, seed)),
            "causal_L1024_fwd_library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True)),
            "causal_L1024_fwd_bound_ms": cb,
            "causal_L1024_fwd_bound_by": cby})
    return row


# K1's 2-byte forms, element by element (the 2-byte rule of K2's check):
# each P' or dS the kernels round to the type moves an element of
# out, dq, dk or dv by about u times the 2-norm of its terms
# (``flash_attention._term_norms``), so the check allows
# FLASH_TERMS_K of those beside one unit of the output's own rounding
# and 1e-6 of the largest value; the plain version computes in f32 from
# the same 2-byte inputs, its backward from the kernel's out and lse.
# dq and dk are also allowed FLASH_F32_SUMS D f32 unit roundoffs of the
# sums behind dP and delta: where dS cancels (a row whose one live key
# makes dP' = delta up to out's rounding, L = 1) it is those sums'
# rounding noise, which the kernel's order and cuBLAS's give apart
FLASH_UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
FLASH_TERMS_K = 4
FLASH_F32_SUMS = 2 * 2.0 ** -24
NMT_ATTENTION = (64, 128, 8, 64)   # bench_nmt's B, L, heads, head_dim
LOSS_SCALE = 2.0 ** 15             # GradScaler's default first scale


def unit_of(torch, x, dtype):
    """One unit in the last place of ``dtype`` at |x| (f32 x), as f32."""
    xb = x.abs().to(dtype)
    return (torch.nextafter(xb, torch.full_like(xb, float("inf")))
            - xb).float()


def ring_block_bounds(torch, fa, q, k, v, do, lse, causal, bias, sums):
    """Per element of (out, dq, dk, dv), a bound of any ring block's
    partial: the 1-norm of the element's terms over every key (P |V|,
    P^T |dO|; for dq and dk ``sums`` of ``_term_norms``, which bound
    |dS| by P (|dP'| + |delta|)), P = exp(S - lse) with the whole
    sequence's lse."""
    B, L, H, D = q.shape
    qm, km, vm, dom = (fa._heads(x.float(), torch.float32)
                       for x in (q, k, v, do))
    prob = torch.exp(fa._scores(qm, km, 1.0 / D ** 0.5, causal, bias)
                     - lse.float().unsqueeze(-1))

    def back(x):
        return x.reshape(B, H, L, D).permute(0, 2, 1, 3)

    return (back(torch.matmul(prob, vm.abs())), sums[0], sums[1],
            back(torch.matmul(prob.transpose(1, 2), dom.abs())))


def flash_2byte_vs_plain(torch, fa, q, k, v, do, causal, p, seed,
                         bias=None, case="", form="stream", glob=None):
    """One launch of a 2-byte flash form over q, k, v against the plain
    version in f32 (the rule above); fails past the tolerance. ``form``:
    "stream" K1a + K1b, "short" K1c + K1d, "ext" the external-lse K1b
    alone, given ``glob`` = (out, lse) of the whole sequence whose k/v
    block this is (no dropout; delta = rowsum(dO out) in f32, as the ring
    takes it), or "ring" the ring's walk over ``glob`` = its n chunks
    (``ring_attention_chunks``, K1a and the external-lse K1b a block;
    each of the n blocks' outputs is rounded to the type once more before
    the f32 sums, as JAX's ring rounds it, so each element is also allowed
    n half units of the type at the bound of a block partial,
    ``ring_block_bounds``: where the partials cancel, or where dq at dO
    scale 1 is an f16 subnormal, a count of the sum's own units or
    roundoffs does not bound it). Returns ({name: tolerance used},
    {name: max abs err}, the kernels' (out, lse, dq, dk, dv); ext: (dq,
    dk, dv); ring: (out, dq, dk, dv))."""
    if form == "ring":
        from paddle_tpu_torch.parallel import ring

        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = ring.ring_attention_chunks(qg, kg, vg, glob, causal, bias=bias)
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        out = out.detach()
        got_all = (out,) + grads
    else:
        got_all = flash_form(fa, form, q, k, v, do, causal, p, seed, bias,
                             glob)
        if form == "ext":
            (out, lse), grads = glob, got_all
            delta = ext_delta(do, out, lse)
        else:
            out, lse, grads = got_all[0], got_all[1], got_all[2:]
    f = [x.float() for x in (q, k, v, out, do)]
    rout, rlse = fa._plain_fwd(f[0], f[1], f[2], causal, p, seed, bias)
    if form == "ext":
        want = fa._plain_bwd_ext(f[0], f[1], f[2], f[4], lse, delta, causal,
                                 bias)
        names, gots = ("dq", "dk", "dv"), grads
    else:
        if form == "ring":   # the backward's lse: the whole sequence's
            lse = rlse
        want = (rout,) + fa._plain_bwd(f[0], f[1], f[2], f[3], lse, f[4],
                                       causal, p, seed, bias)
        names, gots = ("out", "dq", "dk", "dv"), (out,) + grads
    norms, sums = fa._term_norms(q, k, v, out, lse, do, causal, p, seed,
                                 bias)
    u = FLASH_UNIT_ROUNDOFF[str(q.dtype).replace("torch.", "")]
    floor = (0.0,) + tuple(FLASH_F32_SUMS * q.shape[3] * x for x in sums) \
        + (0.0,)
    ring = (0.0,) * 4
    if form == "ring":
        ring = tuple(0.5 * glob * unit_of(torch, x, q.dtype)
                     for x in ring_block_bounds(torch, fa, q, k, v, do, lse,
                                                causal, bias, sums))
    if form == "ext":
        norms, floor = norms[1:], floor[1:]
    torch.cuda.synchronize()
    used, errs = {}, {}
    if form != "ext":
        errs["lse"] = max_err(lse, rlse)
        expect(errs["lse"] <= 1e-4, f"flash {q.dtype}: lse err "
                                    f"{errs['lse']}")
    for name, got, ref, n, fl, rb in zip(names, gots, want, norms, floor,
                                         ring):
        expect(got.dtype == q.dtype and bool(torch.isfinite(got).all()),
               f"flash {q.dtype}: {name} non-finite or of another type")
        errs[name] = max_err(got, ref)
        used[name] = tolerance_ratio(
            torch, got, ref, FLASH_TERMS_K * u * n + fl + rb
            + 1e-6 * float(ref.abs().max()))
        expect(used[name] <= 1.0,
               f"flash {q.dtype} {form} {case}: {name} is off the plain "
               f"version by {used[name]} of its tolerance")
    return used, errs, got_all


def attention_inputs(torch, gen, B, Lq, Lk, H, D, dt, q_mul=1.0,
                     do_scale=LOSS_SCALE):
    """q, k, v ~ N(0, 1) (q times ``q_mul``: 8 gives a peaked softmax)
    and dO = ``do_scale`` times a unit gradient, the gradient of a mean
    over the B Lq tokens (N(0, 1) / (B Lq)), all of type ``dt``."""
    def r(n, mul=1.0):
        return (torch.randn((B, n, H, D), generator=gen, device="cuda")
                * mul).to(dt)
    return r(Lq, q_mul), r(Lk), r(Lk), r(Lq, do_scale / (B * Lq))


# ---------------------------------------------------------------------------
# K1 at head widths 192 and 256: the D 192/256 rows of
# check_flash, check_flash_f16, check_flash_masked, check_flash_short,
# check_flash_short_f16 and check_flash_ring
# ---------------------------------------------------------------------------
WIDE_COUNTERS = {"stream": ("flash_attention_fwd", "flash_attention_bwd"),
                 "masked": ("flash_attention_masked_fwd",
                            "flash_attention_masked_bwd"),
                 "short": ("flash_attention_short_fwd",
                           "flash_attention_short_bwd"),
                 "ext": ("flash_attention_ext_bwd",)}


def ext_delta(do, out, lse):
    """delta = rowsum(dO out) in f32 as (B*H, Lq), as the ring takes it."""
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(lse.shape).contiguous()


def flash_form(fa, form, q, k, v, do, causal, p, seed, bias=None,
               glob=None, plain=False):
    """One forward and backward of a flash form through the kernels, or
    (``plain``) their plain versions: "stream" K1a + K1b (with ``bias``
    their masked form), "short" K1c + K1d, "ext" the external-lse K1b
    alone given ``glob`` = (out, lse) of the whole sequence. Returns
    (out, lse, dq, dk, dv); "ext" (dq, dk, dv)."""
    if form == "ext":
        out, lse = glob
        fn = fa._plain_bwd_ext if plain else fa._cuda_bwd_ext
        return fn(q, k, v, do, lse, ext_delta(do, out, lse), causal, bias)
    if plain:
        fwd, bwd, extra = fa._plain_fwd, fa._plain_bwd, (bias,)
    elif form == "short":
        fwd, bwd, extra = fa._cuda_short_fwd, fa._cuda_short_bwd, ()
    else:
        fwd, bwd, extra = fa._cuda_fwd, fa._cuda_bwd, (bias,)
    out, lse = fwd(q, k, v, causal, p, seed, *extra)
    return (out, lse) + bwd(q, k, v, out, lse, do, causal, p, seed, *extra)


def wide_case(torch, fa, form, name, q, k, v, do, causal, p, seed,
              bias=None, glob=None, rule=False, timing=False):
    """One K1 case at head width 192 or 256: the kernels against their
    plain versions by the calling check's tolerance (bf16 atol 2e-2 +
    rtol 1e-2 and f32 atol 1e-4, lse within 1e-4; ``rule``: the 2-byte
    rule of ``flash_2byte_vs_plain``), the form's launch counts moved by
    one a launch, the 2-byte forms launched twice bit for bit; with
    ``timing`` each half beside its plain version, the library call and
    its bound (``wide_times``)."""
    from paddle_tpu_torch.ops.cuda import counters

    sfx = "_f16" if q.dtype == torch.float16 else ""
    kind = "masked" if form == "stream" and bias is not None else form
    before = counters.snapshot()
    if rule:
        used, errs, got = flash_2byte_vs_plain(
            torch, fa, q, k, v, do, causal, p, seed, bias, case=name,
            form=form, glob=glob)
        row = {"tolerance_used": used, "max_abs_err": errs}
    else:
        got = flash_form(fa, form, q, k, v, do, causal, p, seed, bias, glob)
        want = flash_form(fa, form, q, k, v, do, causal, p, seed, bias, glob,
                          plain=True)
        torch.cuda.synchronize()
        atol, rtol = (1e-4, 0.0) if q.dtype == torch.float32 else (2e-2, 1e-2)
        keys = ("dq", "dk", "dv") if form == "ext" \
            else ("out", "lse", "dq", "dk", "dv")
        errs = {}
        for key, a, b in zip(keys, got, want):
            errs[key] = max_err(a, b)
            expect(bool(torch.isfinite(a.float()).all()),
                   f"flash {kind} {name}: non-finite {key}")
            expect(errs[key] <= 1e-4 if key == "lse" else torch.allclose(
                a.float(), b.float(), atol=atol, rtol=rtol),
                f"flash {kind} {name}: {key} disagrees, max abs err "
                f"{errs[key]}")
        row = {"max_abs_err": errs}
        del want
    launches = 1
    if q.dtype != torch.float32:
        expect(same_bits(torch, got, flash_form(fa, form, q, k, v, do, causal,
                                                p, seed, bias, glob)),
               f"flash {kind} {name}: two launches give different bits")
        launches = 2
    after = counters.snapshot()
    moved = {c + sfx: after.get(c + sfx, 0) - before.get(c + sfx, 0)
             for c in WIDE_COUNTERS[kind]}
    expect(all(n == launches for n in moved.values()),
           f"flash {kind} {name}: launch counts {moved}, want {launches} "
           f"each")
    row["launches"] = moved
    if timing:
        row.update(wide_times(torch, fa, form, q, k, v, do, causal, p, seed,
                              bias, glob, got))
    return row


def wide_times(torch, fa, form, q, k, v, do, causal, p, seed, bias, glob,
               got):
    """Device ms of a wide case's halves (the forward, and the backward
    from the kernel's out and lse; "ext": the backward alone), of their
    plain versions and of the library call (SDPA's forward, and its
    backward replaying a retained graph; "ext": aten's flash backward,
    2-byte full blocks only), and each half's bound: each tensor once at
    3.35 TB/s, or the products (causal: on and below the diagonal) at the
    inputs' rate (989 TFLOP/s for the 2-byte forms, f32 67 outside the
    tensor cores), the larger."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    two = q.dtype != torch.float32
    rate = BF16_FLOPS_PER_S if two else F32_FLOPS_PER_S
    eq, ek = B * Lq * H * D * q.element_size(), B * Lk * H * D * q.element_size()
    rows = B * H * Lq * 4 + (0 if bias is None else B * Lk * 4)
    flops = B * H * Lq * Lk * D * ((Lq + 1) / (2 * Lq) if causal else 1.0)
    t = {"shape": [B, Lq, Lk, H, D], "causal": causal, "dropout": p,
         "bound_rates": rates(rate, "2-byte tensor-core" if two else "f32")}
    if form == "ext":
        out, lse = glob
        delta = ext_delta(do, out, lse)
        lib = flash_ring_library(torch, q, k, v, do, out, lse) \
            if two and not causal and bias is None else None
        t["bwd_bound_ms"], t["bwd_bound_by"] = bound_of(
            3 * eq + 4 * ek + 2 * rows, 10 * flops, rate)
        t.update({
            "bwd_ms": time_ms(torch, lambda: fa._cuda_bwd_ext(
                q, k, v, do, lse, delta, causal, bias), iters=10),
            "bwd_plain_ms": time_ms(torch, lambda: fa._plain_bwd_ext(
                q, k, v, do, lse, delta, causal, bias), iters=3, warmup=1),
            "bwd_library_ms": None if lib is None
            else time_ms(torch, lib, iters=10)})
        return t
    out, lse = got[0], got[1]
    if form == "short":
        fwd, bwd, extra = fa._cuda_short_fwd, fa._cuda_short_bwd, ()
    else:
        fwd, bwd, extra = fa._cuda_fwd, fa._cuda_bwd, (bias,)
    t["fwd_bound_ms"], t["fwd_bound_by"] = bound_of(
        2 * eq + 2 * ek + rows, 4 * flops, rate)
    t["bwd_bound_ms"], t["bwd_bound_by"] = bound_of(
        4 * eq + 4 * ek + rows, 10 * flops, rate)
    t.update({
        "fwd_ms": time_ms(torch, lambda: fwd(q, k, v, causal, p, seed,
                                             *extra), iters=10),
        "bwd_ms": time_ms(torch, lambda: bwd(q, k, v, out, lse, do, causal,
                                             p, seed, *extra), iters=10),
        "fwd_plain_ms": time_ms(torch, lambda: fa._plain_fwd(
            q, k, v, causal, p, seed, bias), iters=3, warmup=1),
        "bwd_plain_ms": time_ms(torch, lambda: fa._plain_bwd(
            q, k, v, out, lse, do, causal, p, seed, bias), iters=3,
            warmup=1)})
    if causal and bias is not None:    # SDPA takes a mask or is_causal
        t["fwd_library_ms"] = t["bwd_library_ms"] = None
        return t
    F = torch.nn.functional
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3).contiguous()
                       for x in (q, k, v, do))
    amask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=amask, dropout_p=p, is_causal=causal)
    t.update({
        "fwd_library_ms": time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=amask, dropout_p=p, is_causal=causal),
            iters=10),
        "bwd_library_ms": time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), doh, retain_graph=True), iters=10)})
    return t


def wide_rows(torch, fa, form, gen, cases, seed, timing, rule=False,
              masks=None):
    """``wide_case`` over ``cases`` = (name, B, Lq, Lk, H, D, dtype,
    causal, p, dO's multiple of a unit gradient or None for N(0, 1),
    q's multiplier) with inputs from ``gen`` (``attention_inputs``);
    ``masks``: name -> the (B, Lk) key lengths of a masked case. Returns
    {name: row}."""
    out = {}
    for name, B, Lq, Lk, H, D, dt, causal, p, scale, q_mul in cases:
        q, k, v, do = attention_inputs(torch, gen, B, Lq, Lk, H, D, dt, q_mul,
                                       B * Lq if scale is None else scale)
        lens = (masks or {}).get(name)
        bias = None if lens is None else fa.kv_mask_bias(
            len_mask(torch, lens, Lk), B, Lk)
        out[name] = wide_case(torch, fa, form, name, q, k, v, do, causal, p,
                              seed, bias, rule=rule, timing=timing)
        del q, k, v, do
    return out


# check_flash's D 192/256 cases (dO a unit gradient, q unscaled): GPT-2
# small at 3 heads of 256 (gpt_d256's shape, its K1a/K1b kernel-line rows),
# ragged Lq != Lk, ragged causal, dropout, f32; lengths that end inside
# the wide forward's 128-row q tile (a last tile of 2 and of 64 rows: the
# second warpgroup's rows all past Lq) and inside a 64-row kv tile,
# causal and not
WIDE_FLASH = (
    ("bf16_D256_causal_L1024", 8, 1024, 1024, 3, 256, "bfloat16", True, 0.0),
    ("bf16_D192", 4, 512, 512, 4, 192, "bfloat16", False, 0.1),
    ("bf16_D256_Lq_ne_Lk", 2, 200, 333, 3, 256, "bfloat16", False, 0.1),
    ("bf16_D192_ragged_causal", 2, 200, 200, 4, 192, "bfloat16", True, 0.1),
    ("bf16_D256_causal_L320", 2, 320, 320, 3, 256, "bfloat16", True, 0.1),
    ("bf16_D192_Lq130_Lk459", 2, 130, 459, 4, 192, "bfloat16", False, 0.0),
    ("f32_D256_causal", 2, 256, 256, 3, 256, "float32", True, 0.1),
    ("f32_D192_Lq_ne_Lk", 2, 200, 333, 4, 192, "float32", False, 0.1))


def wide_cases(torch, table):
    """``wide_rows``' cases from a table of (name, B, Lq, Lk, H, D, dtype
    name, causal, p): N(0, 1) inputs, as the atol checks draw them."""
    return [(n, B, lq, lk, H, D, getattr(torch, dt), c, p, None, 1.0)
            for n, B, lq, lk, H, D, dt, c, p in table]


def wide_kernel_row(case, part):
    """A kernel-line row (``split``'s keys) from a timed wide case."""
    errs = case["max_abs_err"]
    keys = ("out",) if part == "fwd" else ("dq", "dk", "dv")
    return {"max_abs_err": max(errs[k] for k in keys),
            "ms": case[part + "_ms"], "plain_ms": case[part + "_plain_ms"],
            "bound_ms": case[part + "_bound_ms"],
            "bound_by": case[part + "_bound_by"],
            "library_ms": case[part + "_library_ms"]}


def check_flash_f16(torch, fa, counters, timing):
    """K1a/K1b's f16 forms (and the bf16 ones beside them) at the NMT's
    shapes: 64 x 128 x 8 x 64 with dropout 0.1, causal (the decoder's
    self-attention) and not (encoder and cross), dO at the GradScaler's
    2^15 times a unit gradient, a peaked softmax (q x 8), dO at scale 1,
    a key-padded batch; the decode lengths (Lq 1, 17, 64, 127 against Lk
    128; causal L 1, 17, 64; batch 8, no dropout) in f16 and bf16; two
    f16 launches bit for bit; the f16 launches counted apart from the
    bf16 ones. Every case is held element by element (the rule above
    FLASH_UNIT_ROUNDOFF). Times the f16 and bf16 forms at the NMT's shape
    beside SDPA over f16."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    f16, bf = torch.float16, torch.bfloat16
    B, L, H, D = NMT_ATTENTION
    seed = 0x5EED2020
    row = {"cases": {}}
    before = counters.snapshot()
    n_f16 = n_bf16 = 0
    main = None
    for name, causal, p, q_mul, scale in (
            ("nmt_cross", False, 0.1, 1.0, LOSS_SCALE),
            ("nmt_self_causal", True, 0.1, 1.0, LOSS_SCALE),
            ("nmt_peaked_causal", True, 0.1, 8.0, LOSS_SCALE),
            ("nmt_scale1_causal", True, 0.1, 1.0, 1.0)):
        q, k, v, do = attention_inputs(torch, gen, B, L, L, H, D, f16,
                                       q_mul, scale)
        used, errs, got = flash_2byte_vs_plain(torch, fa, q, k, v, do,
                                               causal, p, seed, case=name)
        n_f16 += 1
        row["cases"][name] = {"tolerance_used": used, "max_abs_err": errs}
        if name == "nmt_cross":
            again = fa._cuda_fwd(q, k, v, False, p, seed)
            again += fa._cuda_bwd(q, k, v, got[0], got[1], do, False, p,
                                  seed)
            n_f16 += 1
            expect(same_bits(torch, got, again),
                   "flash f16: two launches give different bits")
            row["f16_relaunch_bitwise"] = True
            main = (q, k, v, do, got[0], got[1])
        del q, k, v, do, got
    # a key-padded batch (a src_mask of key-padding shape) in f16
    q, k, v, do = attention_inputs(torch, gen, 8, L, L, H, D, f16)
    lens = torch.tensor([128, 100, 77, 64, 33, 17, 5, 1], device="cuda")
    bias = fa.kv_mask_bias(
        torch.arange(L, device="cuda")[None, :] < lens[:, None], 8, L)
    used, errs, _ = flash_2byte_vs_plain(torch, fa, q, k, v, do, False, 0.1,
                                         seed, bias, case="masked")
    row["cases"]["masked_f16"] = {"tolerance_used": used,
                                  "max_abs_err": errs}
    # the decode lengths
    for dt in (f16, bf):
        tag = "f16" if dt == f16 else "bf16"
        for lq, lk, causal in ((1, 128, False), (17, 128, False),
                               (64, 128, False), (127, 128, False),
                               (1, 1, True), (17, 17, True),
                               (64, 64, True)):
            q, k, v, do = attention_inputs(torch, gen, 8, lq, lk, H, D, dt)
            used, errs, _ = flash_2byte_vs_plain(
                torch, fa, q, k, v, do, causal, 0.0, seed,
                case=f"Lq {lq} Lk {lk} causal {causal}")
            if dt == bf:
                n_bf16 += 1
            else:
                n_f16 += 1
            row["cases"][f"{tag}_Lq{lq}_Lk{lk}" + ("_causal" if causal
                                                    else "")] = {
                "tolerance_used": used, "max_abs_err": errs}
    after = counters.snapshot()
    moved = {c: after.get(c, 0) - before.get(c, 0) for c in (
        "flash_attention_fwd_f16", "flash_attention_bwd_f16",
        "flash_attention_masked_fwd_f16", "flash_attention_masked_bwd_f16",
        "flash_attention_fwd", "flash_attention_bwd")}
    row["launches"] = moved
    # head widths 192 and 256 over f16 (each case counts its own launches)
    row["wide"] = wide_rows(torch, fa, "stream", gen, [
        ("f16_D192_scale2^15", 4, 512, 512, 4, 192, f16, False, 0.1,
         LOSS_SCALE, 1.0),
        ("f16_D256_causal_scale1", 4, 512, 512, 3, 256, f16, True, 0.1, 1.0,
         1.0),
        ("f16_D256_peaked_scale2^15", 2, 256, 256, 3, 256, f16, False, 0.1,
         LOSS_SCALE, 8.0),
        ("f16_D192_Lq17_Lk128", 8, 17, 128, 4, 192, f16, False, 0.0,
         LOSS_SCALE, 1.0),
        ("f16_D192_causal_L200_scale2^15", 2, 200, 200, 4, 192, f16, True,
         0.1, LOSS_SCALE, 1.0),
        ("f16_D256_Lq130_Lk333_scale1", 2, 130, 333, 3, 256, f16, False, 0.1,
         1.0, 1.0)], seed, timing, rule=True)
    expect(moved["flash_attention_fwd_f16"] == n_f16
           and moved["flash_attention_bwd_f16"] == n_f16
           and moved["flash_attention_masked_fwd_f16"] == 1
           and moved["flash_attention_masked_bwd_f16"] == 1
           and moved["flash_attention_fwd"] == n_bf16
           and moved["flash_attention_bwd"] == n_bf16,
           f"flash f16: launch counts {moved}, want {n_f16} f16, 1 masked "
           f"f16 and {n_bf16} bf16 pairs")
    cases = row["cases"].values()
    row["fwd_max_abs_err"] = max(c["max_abs_err"]["out"] for c in cases)
    row["bwd_max_abs_err"] = max(max(c["max_abs_err"][g]
                                     for g in ("dq", "dk", "dv"))
                                 for c in cases)
    row["max_tolerance_used"] = max(
        max(c["tolerance_used"].values()) for c in cases)
    if timing:
        row.update(time_flash_2byte(torch, fa, main, seed))
    return row


def time_flash_2byte(torch, fa, main, seed, p=0.1):
    """K1a/K1b over f16 and bf16 at the NMT's shape, causal and not, with
    dropout ``p``; the plain versions; SDPA over f16 as the library call
    (its forward, and its backward replaying a retained graph); each
    half's bound (bytes once at 3.35 TB/s, or the products at 989
    TFLOP/s; causal: the products on and below the diagonal)."""
    q, k, v, do, out, lse = main
    B, L, H, D = q.shape
    F = torch.nn.functional
    el = B * L * H * D * 2
    row = {}
    for causal in (False, True):
        frac = (L + 1) / (2 * L) if causal else 1.0
        fb, fby = bound_of(4 * el + B * H * L * 4,
                           4 * B * H * L * L * D * frac, BF16_FLOPS_PER_S)
        bb, bby = bound_of(8 * el + B * H * L * 4,
                           10 * B * H * L * L * D * frac, BF16_FLOPS_PER_S)
        tag = "_causal" if causal else ""
        for dt in (torch.float16, torch.bfloat16):
            t = "f16" if dt == torch.float16 else "bf16"
            qq, kk, vv, dd = (x.to(dt) for x in (q, k, v, do))
            o, ls = fa._cuda_fwd(qq, kk, vv, causal, p, seed)
            row[f"{t}{tag}_fwd_ms"] = time_ms(torch, lambda: fa._cuda_fwd(
                qq, kk, vv, causal, p, seed))
            row[f"{t}{tag}_bwd_ms"] = time_ms(torch, lambda: fa._cuda_bwd(
                qq, kk, vv, o, ls, dd, causal, p, seed))
        qh, kh, vh, doh = (x.permute(0, 2, 1, 3).contiguous()
                           for x in (q, k, v, do))
        qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p,
                                                 is_causal=causal)
        row.update({
            f"f16{tag}_fwd_plain_ms": time_ms(torch, lambda: fa._plain_fwd(
                q, k, v, causal, p, seed), iters=5),
            f"f16{tag}_bwd_plain_ms": time_ms(torch, lambda: fa._plain_bwd(
                q, k, v, out, lse, do, causal, p, seed), iters=5),
            f"f16{tag}_fwd_library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, dropout_p=p, is_causal=causal)),
            f"f16{tag}_bwd_library_ms": time_ms(
                torch, lambda: torch.autograd.grad(
                    lib_out, (qg, kg, vg), doh, retain_graph=True)),
            f"f16{tag}_fwd_bound_ms": fb, f"f16{tag}_fwd_bound_by": fby,
            f"f16{tag}_bwd_bound_ms": bb, f"f16{tag}_bwd_bound_by": bby})
        del lib_out, qg, kg, vg
    for half in ("fwd", "bwd"):
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            row[f"{half}_{key}"] = row[f"f16_{half}_{key}"]
    row["bound_rates"] = rates(BF16_FLOPS_PER_S, "f16 tensor-core (the "
                               "bf16 rate)")
    return row


def kernel_device_ms(torch, fn, pattern):
    """Device ms of each kernel one call of ``fn`` launches whose name
    matches ``pattern`` (torch.profiler, after a warm-up call), by the
    match; "not measured" where the profiler gives no device time."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(HOST_AHEAD_CYCLES)   # the trace's first kernel
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        found = re.search(pattern, e.name)
        if found is None:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        out[found.group(0)] = out.get(found.group(0), 0.0) + us / 1e3
    return out if out and sum(out.values()) > 0 else "not measured"


# the 2-byte K2 checks. Each P' the kernels round to the type moves by
# at most its unit roundoff u (relative), so an element of dh or dW moves
# from the plain version's f32 value by about u times the 2-norm of its
# terms (``fused_xent._term_norms``; at most that where a few terms
# dominate): the check allows XENT_TERMS_K of those beside one unit of
# the output's rounding; db sums f32 P', so it is allowed 2^-16 of the
# 1-norm of its terms (the f32 sum's order and exp's rounding, with
# room) beside its unit. dW's softmax part (its rows no label hits), as
# a relative norm, within two unit roundoffs (about 0.6 of one is
# expected: P' and the output each round once). f16's gradient is taken
# at a loss scale of 2^10, as f16 trains under a GradScaler (unscaled,
# dW's softmax part would be f16 subnormals); bf16's and f32's at 1
XENT_UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
XENT_TERMS_K = 4
XENT_DB_L1 = 2.0 ** -16
XENT_SOFTMAX_RTOL = {k: 2 * u for k, u in XENT_UNIT_ROUNDOFF.items()}
XENT_LOSS_SCALE = {"float32": 1.0, "bfloat16": 1.0, "float16": 1024.0}


def tolerance_ratio(torch, got, want, extra):
    """The largest |got - want| (want f32) over one unit of got's type at
    the larger of the two magnitudes plus ``extra`` (a tensor or a
    float), element by element: <= 1 passes."""
    big = torch.maximum(got.abs(), want.abs().to(got.dtype))
    unit = (torch.nextafter(big, torch.full_like(big, float("inf")))
            - big).float()
    return float(((got.float() - want).abs() / (unit + extra)).max())


def rel_norm(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def xent_vs_plain(torch, fx, row, tag, h, w, b, lab, g):
    """One K2a + K2b launch on (h, W, bias) against the plain version.
    The f32 form: every output within 1e-4 of its largest value. The
    2-byte forms: lse and the label logit within 1e-5 of theirs; dh, dW
    and db against the plain version's f32 values element by element,
    within one unit of the type plus XENT_TERMS_K unit roundoffs of the
    2-norm of the element's terms (db: XENT_DB_L1 of their 1-norm) plus
    1e-6 of the largest value; dW's softmax part within ``XENT_SOFTMAX_RTOL``; dh's
    softmax part (dh less its label term -g W[label]) reported the same
    way. Returns the kernels' (lse, ll, dh, dW, db)."""
    two = h.dtype != torch.float32
    name_t = str(h.dtype).replace("torch.", "")
    lse, ll = fx._cuda_fwd(h, w, b, lab)
    got = (lse, ll) + fx._cuda_bwd(h, w, b, lab, lse, g)
    rlse, rll = fx._plain_fwd(h, w, b, lab)
    want = (rlse, rll) + fx._plain_bwd(h, w, b, lab, rlse, g)
    torch.cuda.synchronize()
    for name, x, y in zip(("lse", "ll", "dh", "dw", "db"), got, want):
        expect(x.dtype == y.dtype, f"xent {name_t}: {name} is {x.dtype}, "
                                   f"want {y.dtype}")
        expect(bool(torch.isfinite(x).all()),
               f"xent {name_t}: non-finite {tag}{name}")
        err, scale = max_err(x, y), float(y.abs().max())
        row[tag + name + "_max_abs_err"] = err
        row[tag + name + "_max_abs"] = scale
        if x.dtype == torch.float32:
            tol = (1e-5 if two else 1e-4) * scale
            expect(err <= tol, f"xent {name_t}: {tag}{name} disagrees, max "
                               f"abs err {err} against {tol}")
    if two:
        del want
        u = XENT_UNIT_ROUNDOFF[name_t]
        f32 = fx._plain_bwd(h.float(), w.float(), b.float(), lab, lse, g)
        n2h, n2w, n1b = fx._term_norms(h, w, b, lab, lse, g)
        for name, x, y, extra in zip(
                ("dh", "dw", "db"), got[2:], f32,
                (XENT_TERMS_K * u * n2h, XENT_TERMS_K * u * n2w,
                 XENT_DB_L1 * n1b)):
            ratio = tolerance_ratio(torch, x, y,
                                    extra + 1e-6 * float(y.abs().max()))
            row[tag + name + "_tolerance_used"] = ratio
            expect(ratio <= 1.0, f"xent {name_t}: {tag}{name} is off the "
                                 f"plain version by {ratio} of its "
                                 f"tolerance")
        del n2h, n2w, n1b, extra
        valid = lab >= 0
        hit = torch.zeros(w.shape[0], dtype=torch.bool, device=h.device)
        hit[lab[valid].long()] = True
        rel = rel_norm(got[3].float()[~hit], f32[1][~hit])
        row[tag + "dw_softmax_rel_err"] = rel
        row[tag + "dw_rows_no_label_hits"] = int((~hit).sum())
        expect(rel <= XENT_SOFTMAX_RTOL[name_t],
               f"xent {name_t}: {tag}dW's softmax part is {rel} off the "
               f"plain version (limit {XENT_SOFTMAX_RTOL[name_t]})")
        label = torch.where(valid[:, None], -g[:, None]
                            * w.float()[lab.clamp(min=0).long()], 0.0)
        row[tag + "dh_softmax_rel_err"] = rel_norm(got[2].float() - label,
                                                   f32[0] - label)
        del f32, label
    return got


def check_xent(torch, fx, timing, dtype_name="float32"):
    """K2a/K2b against the plain version at BERT-base's MLM head (see
    ``xent_vs_plain``), two launches bit for bit: the f32 form, or the
    2-byte form over bf16 or f16 h, W and bias, checked also with h
    eight times larger (a peaked softmax, whose part of dh the type
    resolves; at the first input it is below a unit of dh's label
    term)."""
    dev = "cuda"
    dt = getattr(torch, dtype_name)
    two = dt != torch.float32
    gen = torch.Generator(device=dev).manual_seed(11 if two else 1)
    N, H, V = 16384, 768, 30592
    h = torch.randn((N, H), generator=gen, device=dev).to(dt)
    w = (torch.randn((V, H), generator=gen, device=dev) * 0.02).to(dt)
    b = (torch.randn((V,), generator=gen, device=dev) * 0.02).to(dt)
    lab = torch.randint(0, V, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    ignored = torch.rand((N,), generator=gen, device=dev) < 0.15
    lab = torch.where(ignored, torch.full_like(lab, -1), lab)
    valid = lab >= 0
    # d(mean)/d(row loss), times the loss scale
    g = valid.float() / valid.sum().float() * XENT_LOSS_SCALE[dtype_name]
    row = {"dtype": dtype_name, "ignored_rows": int(ignored.sum()),
           "loss_scale": XENT_LOSS_SCALE[dtype_name]}
    if two:
        xent_vs_plain(torch, fx, row, "peaked_", h * 8, w, b, lab, g)
        torch.cuda.empty_cache()
    got = xent_vs_plain(torch, fx, row, "", h, w, b, lab, g)
    lse = got[0]
    expect(same_bits(torch, got, fx._cuda_fwd(h, w, b, lab)
                     + fx._cuda_bwd(h, w, b, lab, lse, g)),
           f"xent {dtype_name}: two launches give different bits")
    row["fwd_max_abs_err"] = max(row["lse_max_abs_err"],
                                 row["ll_max_abs_err"])
    row["bwd_max_abs_err"] = max(row["dh_max_abs_err"],
                                 row["dw_max_abs_err"],
                                 row["db_max_abs_err"])
    if timing:
        # the f32 form runs every product as three bf16 tensor-core terms
        # (its rate: 989 / 3 TFLOP/s), the 2-byte forms as one (f16's
        # dense rate is bf16's); h, W, bias in the input type, labels,
        # lse, ll and g f32; the backward forms the logits once more
        # (from lse) beside dh and dW
        terms = 1 if two else 3
        es = h.element_size()
        io = (N * H + V * H + V) * es + N * 4
        fwd_io, fwd_ops = io + 2 * N * 4, 2 * N * H * V
        bwd_io = io + 2 * N * 4 + (N * H + V * H + V) * es
        bwd_ops = 6 * N * H * V
        fb, fby = bound_of(fwd_io, terms * fwd_ops, BF16_FLOPS_PER_S)
        bb, bby = bound_of(bwd_io, terms * bwd_ops, BF16_FLOPS_PER_S)
        F = torch.nn.functional
        lab64 = lab.long()
        hg, wg, bg = (x.clone().requires_grad_() for x in (h, w, b))

        def lib_logits(x, y, z):
            return (torch.matmul(x, y.t()) + z).float()

        def lib_fwd():
            return F.cross_entropy(lib_logits(h, w, b), lab64,
                                   ignore_index=-1)

        def lib_fwd_bwd():
            loss = F.cross_entropy(lib_logits(hg, wg, bg), lab64,
                                   ignore_index=-1)
            return torch.autograd.grad(loss, (hg, wg, bg))

        lib_loss = F.cross_entropy(lib_logits(hg, wg, bg), lab64,
                                   ignore_index=-1)

        def lib_bwd():
            return torch.autograd.grad(lib_loss, (hg, wg, bg),
                                       retain_graph=True)

        row.update({
            "fwd_ms": time_ms(torch, lambda: fx._cuda_fwd(h, w, b, lab),
                              iters=10, warmup=1),
            "fwd_plain_ms": time_ms(torch, lambda: fx._plain_fwd(
                h, w, b, lab), iters=5, warmup=1),
            "fwd_library_ms": time_ms(torch, lib_fwd, iters=10, warmup=1),
            "fwd_bound_ms": fb, "fwd_bound_by": fby,
            "bwd_ms": time_ms(torch, lambda: fx._cuda_bwd(
                h, w, b, lab, lse, g), iters=10, warmup=1),
            "bwd_plain_ms": time_ms(torch, lambda: fx._plain_bwd(
                h, w, b, lab, lse, g), iters=5, warmup=1),
            "fwd_bwd_library_ms": time_ms(torch, lib_fwd_bwd, iters=5,
                                          warmup=1),
            "bwd_library_ms": time_ms(torch, lib_bwd, iters=10, warmup=1),
            "bwd_bound_ms": bb, "bwd_bound_by": bby,
            "bwd_bound_4_products_ms": terms * 8 * N * H * V
            / BF16_FLOPS_PER_S * 1e3,
            "bound_rates": rates(BF16_FLOPS_PER_S / terms,
                                 f"{'bf16' if not two else dtype_name} "
                                 f"tensor-core, {terms} term"
                                 f"{'s' if terms > 1 else ''} a product"),
            "fwd_kernels_ms": kernel_device_ms(torch, lambda: fx._cuda_fwd(
                h, w, b, lab), r"xent_\w+"),
            "bwd_kernels_ms": kernel_device_ms(torch, lambda: fx._cuda_bwd(
                h, w, b, lab, lse, g), r"xent_\w+")})
        if not two:
            row.update({
                "fwd_bound_f32_ms": bound_of(fwd_io, fwd_ops,
                                             F32_FLOPS_PER_S)[0],
                "bwd_bound_f32_ms": bound_of(bwd_io, bwd_ops,
                                             F32_FLOPS_PER_S)[0]})
            row["split_ms"] = {
                k: (v if isinstance(v, str) else v.get("xent_split_" + k))
                for k, v in (("fwd", row["fwd_kernels_ms"]),
                             ("bwd", row["bwd_kernels_ms"]))}
        del lib_loss
    return row


def k3_form(torch, ps, gs, dtype_name):
    """K3's f32 form (params, grads, masters None), or with a 2-byte
    ``dtype_name`` its master form: the parameters and gradients cast to
    that type, the f32 ``ps`` their masters."""
    if dtype_name == "float32":
        return ps, gs, None
    dt = getattr(torch, dtype_name)
    return [p.to(dt) for p in ps], [g.to(dt) for g in gs], ps


def k3_names(names, masters):
    """The counters of a form's kernels (``_master`` for the master
    form)."""
    return [n + ("" if masters is None else "_master") for n in names]


def k3_compare(torch, counters, label, names, state, kernel, plain,
               skip=None):
    """``kernel(state, skip=False)`` (one count of each of ``names`` a
    call) run twice, each on copies of ``state`` ([params, masters or
    None, the rule's state lists...]), the two bit for bit; the first
    against ``plain(copies, first)`` bit for bit; a master form (or any
    form with ``skip`` True) also: a skipped call launches nothing and
    changes nothing; a master form: each parameter is its master's cast.
    Returns the two kernel runs."""
    if skip is None:
        skip = state[1] is not None
    def copy():
        return [None if xs is None else [x.clone() for x in xs]
                for xs in state]

    def flat(s):
        return [x for xs in s if xs is not None for x in xs]

    runs = []
    for _ in range(2):
        k = copy()
        before = {n: counters.get(n) for n in names}
        if skip:
            kernel(k, skip=True)
            expect(all(counters.get(n) == before[n] for n in names),
                   f"{label}: a skipped call launched a kernel")
            expect(same_bits(torch, flat(k), flat(state)),
                   f"{label}: a skipped call changed the state")
        kernel(k)
        expect(all(counters.get(n) == before[n] + 1 for n in names),
               f"{label}: not one count of each kernel a call")
        runs.append(k)
    expect(same_bits(torch, flat(runs[0]), flat(runs[1])),
           f"{label}: two launches differ")
    want = copy()
    plain(want, runs[0])
    torch.cuda.synchronize()
    differ = sum(int(not same_bits(torch, [a], [b]))
                 for a, b in zip(flat(runs[0]), flat(want)))
    expect(differ == 0, f"{label} differs bitwise in {differ} tensors")
    if state[1] is not None:
        ps, ws = runs[0][0], runs[0][1]
        expect(same_bits(torch, ps, [w.to(p.dtype) for p, w in zip(ps, ws)]),
               f"{label}: a parameter is not its master's cast")
    return runs


def k3_library(torch, ps, gs, ws, make_opt):
    """One PyTorch call set computing the same function (timed, never
    called by the port): a fused ``torch.optim`` step over copies of the
    parameters (f32, or 2-byte without masters) and gradients of their
    type, or of the masters with f32 copies of the gradients followed by
    ``torch._foreach_copy_`` into the 2-byte parameters."""
    lib_w = [torch.nn.Parameter(w.clone()) for w in (ps if ws is None
                                                      else ws)]
    for p, g in zip(lib_w, gs):
        p.grad = g.to(p.dtype, copy=True)
    opt = make_opt(lib_w)
    if ws is None:
        return opt.step
    dst = [p.clone() for p in ps]

    def run():
        opt.step()
        torch._foreach_copy_(dst, [p.detach() for p in lib_w])

    return run


def k3_row(dtype_name, shapes, n, per):
    return {"dtype": dtype_name, "params": len(shapes), "elements": n,
            "max_abs_err": 0.0, "bitwise": True, "bytes_per_element": per}


def check_adam(torch, fo, counters, shapes, timing, dtype_name="float32"):
    """K3-adam (AdamW's decoupled decay) over BERT-base's parameter list,
    bit for bit (``k3_compare``); with a 2-byte ``dtype_name``, its
    master form."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)

    def make(scale, positive=False):
        out = []
        for s in shapes:
            x = torch.randn(s, generator=gen, device=dev) * scale
            out.append(x.abs() if positive else x)
        return out

    ps, gs, ms, vs = make(0.02), make(1e-3), make(1e-4), make(1e-6, True)
    ps, gs, ws = k3_form(torch, ps, gs, dtype_name)
    hp = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, step=3,
              weight_decay=0.01)
    lr, c1, c2, lrwd = fo.adam_scalars(1e-4, 0.9, 0.999, 3, 0.01)
    caches = {}

    def kernel(s, skip=False):
        fo.fused_adam_(s[0], gs, s[2], s[3], skip=skip, masters=s[1],
                       cache=caches.setdefault(id(s[0]), {}), **hp)

    def plain(s, _=None):
        plain_over(fo, s[0], gs, s[1], False, lambda w, g: fo._plain_adam_(
            w, g, s[2], s[3], lr, 0.9, 0.999, 1e-8, c1, c2, lrwd, False))

    state = [ps, ws, ms, vs]
    k, _ = k3_compare(torch, counters, f"fused Adam ({dtype_name})",
                      k3_names(["fused_adam"], ws), state, kernel, plain)
    n = sum(p.numel() for p in ps)
    row = k3_row(dtype_name, shapes, n, 28)
    if timing:
        # g (f32 or 2-byte) and the f32 p or master, m, v read once, they
        # and a 2-byte p written once: 28 bytes an element either way
        t_b, by = bound_of(28 * n, 16 * n, F32_FLOPS_PER_S)
        lib = k3_library(torch, ps, gs, ws, lambda p: torch.optim.AdamW(
            p, lr=1e-4, weight_decay=0.01, fused=True))
        row.update({
            "ms": time_ms(torch, lambda: kernel(k)),
            "plain_ms": time_ms(torch, lambda: plain(state), iters=5),
            "library_ms": time_ms(torch, lib),
            "bound_ms": t_b, "bound_by": by,
            "bound_rates": rates(F32_FLOPS_PER_S, "f32")})
    return row


def check_momentum(torch, fo, counters, shapes, timing,
                   dtype_name="float32"):
    """K3-momentum over ResNet-50's parameter list, bit for bit
    (``k3_compare``), without and with Nesterov, from a non-zero
    velocity; with a 2-byte ``dtype_name``, its master form."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)

    def make(scale):
        return [torch.randn(s, generator=gen, device=dev) * scale
                for s in shapes]

    ps, gs, vs = make(0.05), make(1e-3), make(1e-3)
    ps, gs, ws = k3_form(torch, ps, gs, dtype_name)
    lr, mu = 0.1, 0.9
    caches = {}
    state = [ps, ws, vs]
    for nesterov in (False, True):
        def kernel(s, skip=False, nesterov=nesterov):
            fo.fused_momentum_(s[0], gs, s[2], lr=lr, momentum=mu,
                               nesterov=nesterov, skip=skip, masters=s[1],
                               cache=caches.setdefault(id(s[0]), {}))

        def plain(s, _=None, nesterov=nesterov):
            plain_over(fo, s[0], gs, s[1], False, lambda w, g:
                       fo._plain_momentum_(w, g, s[2], np.float32(lr),
                                           np.float32(mu), nesterov, False))

        runs = k3_compare(torch, counters,
                          f"fused Momentum ({dtype_name}, nesterov="
                          f"{nesterov})", k3_names(["fused_momentum"], ws),
                          state, kernel, plain)
        if not nesterov:
            k, kernel0, plain0 = runs[0], kernel, plain
    n = sum(p.numel() for p in ps)
    row = dict(k3_row(dtype_name, shapes, n, 20), nesterov_bitwise=True)
    if timing:
        # g and the f32 p or master, v read once, they and a 2-byte p
        # written once: 20 bytes an element either way; 3 flops
        t_b, by = bound_of(20 * n, 3 * n, F32_FLOPS_PER_S)
        lib = k3_library(torch, ps, gs, ws, lambda p: torch.optim.SGD(
            p, lr=lr, momentum=mu, fused=True))
        row.update({
            "ms": time_ms(torch, lambda: kernel0(k)),
            "plain_ms": time_ms(torch, lambda: plain0(state), iters=5),
            "library_ms": time_ms(torch, lib),
            "bound_ms": t_b, "bound_by": by,
            "bound_rates": rates(F32_FLOPS_PER_S, "f32")})
    return row


def check_flash_short(torch, fa, timing, tc_counts):
    """K1c/K1d (the short-sequence kernels) against the plain version
    and against the streaming K1 on the same inputs and seed: BERT-base
    phase 2's 32 x 512 x 12 x 64 in bf16 with dropout 0.1 (atol 2e-2 +
    rtol 1e-2), 128-long f32 without dropout (atol 1e-4), a causal f32
    case with dropout and a D = 128 bf16 case at L 384; the bf16
    backward (one cluster of L / 64 CTAs a head) also at L 128 and
    causal L 256, so it runs at clusters of 2, 4, 6 and 8; two launches
    of each bf16 kernel give the same bits; the dropout mask read back
    bit for bit. Times the short kernels, the streaming K1 (its
    backward is K1b's pair, ``stream_bwd_ms``) and
    ``F.scaled_dot_product_attention`` at L 128 and L 512. Then the f16
    forms (``short_f16``): BERT phase 2's shape with dropout 0.1 at dO
    scale 1 (a unit gradient: BERT's O1 fp16 path has no loss scaler)
    and 2^15 and with a peaked softmax, causal L 256, D 128 at L 384 and
    L 128, so the backward runs at clusters of 2, 4, 6 and 8, each held
    element by element (the rule above FLASH_UNIT_ROUNDOFF), two
    launches bit for bit, K1c f16's lse bit for bit K1a f16's (the same
    body; K1c f16 takes P into P V as one term, K1a f16 as hi + lo), the
    f16 launches counted apart, and K1c/K1d f16 timed beside SDPA
    over f16 at L 512."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = [("bf16_L512", 32, 512, 12, 64, torch.bfloat16, False, 0.1),
             ("f32_L128", 8, 128, 12, 64, torch.float32, False, 0.0),
             ("bf16_L128", 8, 128, 12, 64, torch.bfloat16, False, 0.0),
             ("f32_causal_L256", 4, 256, 4, 64, torch.float32, True, 0.1),
             ("bf16_causal_L256", 4, 256, 4, 64, torch.bfloat16, True, 0.1),
             ("bf16_D128_L384", 2, 384, 4, 128, torch.bfloat16, False, 0.1)]
    seed = 0x5EED5678
    row = {"cases": {}}
    for name, B, L, H, D, dt, causal, p in cases:
        q, k, v, do = [torch.randn((B, L, H, D), generator=gen,
                                   device=dev).to(dt) for _ in range(4)]
        out, lse = fa._cuda_short_fwd(q, k, v, causal, p, seed)
        rout, rlse = fa._plain_fwd(q, k, v, causal, p, seed)
        sout, slse = fa._cuda_fwd(q, k, v, causal, p, seed)
        grads = fa._cuda_short_bwd(q, k, v, out, lse, do, causal, p, seed)
        rgrads = fa._plain_bwd(q, k, v, rout, rlse, do, causal, p, seed)
        sgrads = fa._cuda_bwd(q, k, v, sout, slse, do, causal, p, seed)
        torch.cuda.synchronize()
        atol, rtol = (2e-2, 1e-2) if dt == torch.bfloat16 else (1e-4, 0.0)
        errs = {"lse": max_err(lse, rlse), "stream_lse": max_err(lse, slse)}
        for gname, got, want, stream in zip(
                ("out", "dq", "dk", "dv"), (out,) + grads, (rout,) + rgrads,
                (sout,) + sgrads):
            errs[gname] = max_err(got, want)
            errs["stream_" + gname] = max_err(got, stream)
            expect(bool(torch.isfinite(got.float()).all()),
                   f"flash short {name}: non-finite {gname}")
            expect(torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol),
                   f"flash short {name}: {gname} disagrees with the plain "
                   f"version, max abs err {errs[gname]}")
            expect(torch.allclose(got.float(), stream.float(), atol=atol,
                                  rtol=rtol),
                   f"flash short {name}: {gname} disagrees with the "
                   f"streaming kernel, max abs err {errs['stream_' + gname]}")
        expect(errs["lse"] <= 1e-4 and errs["stream_lse"] <= 1e-4,
               f"flash short {name}: lse errs {errs['lse']}, "
               f"{errs['stream_lse']}")
        if dt == torch.bfloat16:
            expect(same_bits(torch, (out, lse) + grads, fa._cuda_short_fwd(
                q, k, v, causal, p, seed) + fa._cuda_short_bwd(
                q, k, v, out, lse, do, causal, p, seed)),
                f"flash short {name}: two launches give different bits")
        row["cases"][name] = errs
        del q, k, v, do, out, rout, sout, grads, rgrads, sgrads
    # the dropout mask, bit for bit: q = k = 0 gives P = 1/L, v = I (D = L
    # = 128) reads keep / (L (1 - p)) back out of the kernel's output
    L, p = 128, 0.1
    z = torch.zeros((2, L, 3, L), device=dev)
    eye = torch.eye(L, device=dev).reshape(1, L, 1, L).expand(2, L, 3, L)
    out, _ = fa._cuda_short_fwd(z, z, eye.contiguous(), False, p, seed)
    keep = fa.philox_keep_mask(seed, 6, L, L, p, dev)
    got = (out > 0).permute(0, 2, 1, 3).reshape(6, L, L)
    expect(torch.equal(got, keep), "flash short dropout mask differs from "
                                   "the plain Philox mask")
    row["mask_bitwise"] = True
    # head widths 192 and 256: BERT phase 2 at 4 heads of 192
    # (bert512_d192's shape, its K1c/K1d kernel-line rows), the f32 forms'
    # layouts at L 512 and causal, the 2-byte backward's clusters of 2, 6
    # and 8 at both widths
    row["wide"] = wide_rows(torch, fa, "short", gen, wide_cases(torch, (
        ("bf16_D192_L512", 32, 512, 512, 4, 192, "bfloat16", False, 0.1),
        ("bf16_D256_causal_L512", 4, 512, 512, 3, 256, "bfloat16", True, 0.1),
        ("bf16_D256_L128", 4, 128, 128, 3, 256, "bfloat16", False, 0.0),
        ("bf16_D192_L384", 2, 384, 384, 4, 192, "bfloat16", False, 0.1),
        ("bf16_D256_causal_L384", 2, 384, 384, 3, 256, "bfloat16", True,
         0.1),
        ("f32_D256_L512", 2, 512, 512, 3, 256, "float32", False, 0.1),
        ("f32_D192_causal_L256", 2, 256, 256, 4, 192, "float32", True,
         0.1))), seed, timing)
    main = row["cases"]["bf16_L512"]
    row["fwd_max_abs_err"] = max(c["out"] for c in row["cases"].values())
    row["bwd_max_abs_err"] = max(max(c["dq"], c["dk"], c["dv"])
                                 for c in row["cases"].values())
    row["main_shape_errs"] = main
    # HMMA instructions of the tensor-core backward's instantiations (the
    # build phase fails where one has none)
    row["short_bwd_mma_hmma"] = {"D64" if "ILi64E" in fn else "D128": n
                                 for fn, n in tc_counts.items()
                                 if "short_bwd_mma" in fn}
    row["short_bwd_wg_tensor_core"] = {fn: n for fn, n in tc_counts.items()
                                       if "short_bwd_wg" in fn}
    # clusters of the bf16 backward the card holds at once at the main
    # shape (8 CTAs of 104 KB each, two an SM at most)
    fn = fa._build.entry("flash_short", "flash_short_bwd_max_clusters",
                         [ctypes.c_int, ctypes.c_int])
    clusters = int(fn(512, 64))
    expect(clusters > 0, f"flash short: cudaOccupancyMaxActiveClusters "
                         f"failed ({clusters})")
    row["bwd_resident"] = {
        "clusters": clusters, "ctas": clusters * 8,
        "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    wide = fa._build.entry("flash_short_wide", "flash_short_bwd_max_clusters",
                           [ctypes.c_int, ctypes.c_int])
    for d in (192, 256):     # short_bwd_wg: 8 CTAs, one an SM
        n = int(wide(512, d))
        expect(n > 0, f"flash short D {d}: cudaOccupancyMaxActiveClusters "
                      f"failed ({n})")
        row["bwd_resident"][f"D{d}_clusters"] = n
    if timing:
        row["times"] = {f"L{L}": time_short_vs_stream(torch, fa, gen, B, L)
                        for B, L in ((128, 128), (32, 512))}
        t = row["times"]["L512"]
        row["stream_bwd_ms"] = t["stream_bwd_ms"]
        for part in ("fwd", "bwd"):
            row.update({f"{part}_ms": t[f"short_{part}_ms"],
                        f"{part}_plain_ms": t[f"plain_{part}_ms"],
                        f"{part}_library_ms": t[f"library_{part}_ms"],
                        f"{part}_bound_ms": t[f"{part}_bound_ms"],
                        f"{part}_bound_by": t[f"{part}_bound_by"]})
        row["bound_rates"] = rates(BF16_FLOPS_PER_S, "bf16 tensor-core")
    row["short_f16"] = check_flash_short_f16(torch, fa, gen, timing)
    return row


# the f16 cases of check_flash_short: (name, B, L, H, D, causal, dO's
# multiple of a unit gradient, q's multiplier); dropout 0.1 in each
SHORT_F16_CASES = (
    ("f16_L512_scale1", 32, 512, 12, 64, False, 1.0, 1.0),
    ("f16_L512_scale2^15", 8, 512, 12, 64, False, LOSS_SCALE, 1.0),
    ("f16_L512_peaked_scale1", 8, 512, 12, 64, False, 1.0, 8.0),
    ("f16_causal_L512_scale1", 8, 512, 12, 64, True, 1.0, 1.0),
    ("f16_causal_L256_scale1", 4, 256, 4, 64, True, 1.0, 1.0),
    ("f16_causal_L256_scale2^15", 4, 256, 4, 64, True, LOSS_SCALE, 1.0),
    ("f16_D128_L384_scale1", 2, 384, 4, 128, False, 1.0, 1.0),
    ("f16_D128_L384_scale2^15", 2, 384, 4, 128, False, LOSS_SCALE, 1.0),
    ("f16_L128_scale1", 8, 128, 12, 64, False, 1.0, 1.0),
    ("f16_L128_scale2^15", 8, 128, 12, 64, False, LOSS_SCALE, 1.0))


def check_flash_short_f16(torch, fa, gen, timing):
    """K1c/K1d over f16 (check_flash_short's f16 part)."""
    from paddle_tpu_torch.ops.cuda import counters

    seed, p = 0x5EED2121, 0.1
    row = {"cases": {}}
    before = counters.snapshot()
    n = 0
    for name, B, L, H, D, causal, scale, q_mul in SHORT_F16_CASES:
        q, k, v, do = attention_inputs(torch, gen, B, L, L, H, D,
                                       torch.float16, q_mul, scale)
        used, errs, got = flash_2byte_vs_plain(
            torch, fa, q, k, v, do, causal, p, seed, case=name,
            form="short")
        again = fa._cuda_short_fwd(q, k, v, causal, p, seed)
        again += fa._cuda_short_bwd(q, k, v, got[0], got[1], do, causal, p,
                                    seed)
        n += 2
        expect(same_bits(torch, got, again),
               f"flash short {name}: two launches give different bits")
        stream = fa._cuda_fwd(q, k, v, causal, p, seed)
        expect(same_bits(torch, got[1:2], stream[1:]),
               f"flash short {name}: K1c f16's lse differs from K1a f16's")
        row["cases"][name] = {"tolerance_used": used, "max_abs_err": errs,
                              "clusters": L // 64}
        if name == "f16_L512_scale1":
            main = (q, k, v, do, got[0], got[1])
        del q, k, v, do, got, again, stream
    moved = {c: counters.snapshot().get(c, 0) - before.get(c, 0) for c in (
        "flash_attention_short_fwd_f16", "flash_attention_short_bwd_f16",
        "flash_attention_short_fwd", "flash_attention_short_bwd",
        "flash_attention_fwd_f16")}
    row["launches"] = moved
    expect(moved == {"flash_attention_short_fwd_f16": n,
                     "flash_attention_short_bwd_f16": n,
                     "flash_attention_short_fwd": 0,
                     "flash_attention_short_bwd": 0,
                     "flash_attention_fwd_f16": n // 2},
           f"flash short f16: launch counts {moved}, want {n} f16 pairs")
    # head widths 192 and 256 over f16 (each case counts its own launches)
    row["wide"] = wide_rows(torch, fa, "short", gen, [
        ("f16_D192_L512_scale1", 8, 512, 512, 4, 192, torch.float16, False,
         0.1, 1.0, 1.0),
        ("f16_D256_causal_L512_scale1", 4, 512, 512, 3, 256, torch.float16,
         True, 0.1, 1.0, 1.0),
        ("f16_D256_L256_scale2^15", 4, 256, 256, 3, 256, torch.float16,
         False, 0.1, LOSS_SCALE, 1.0),
        ("f16_D192_L128_peaked_scale1", 4, 128, 128, 4, 192, torch.float16,
         False, 0.1, 1.0, 8.0),
        ("f16_D192_causal_L384_scale2^15", 2, 384, 384, 4, 192,
         torch.float16, True, 0.1, LOSS_SCALE, 1.0),
        ("f16_D256_L384_scale1", 2, 384, 384, 3, 256, torch.float16, False,
         0.1, 1.0, 1.0)], seed, timing, rule=True)
    cases = row["cases"].values()
    row["fwd_max_abs_err"] = max(c["max_abs_err"]["out"] for c in cases)
    row["bwd_max_abs_err"] = max(max(c["max_abs_err"][g]
                                     for g in ("dq", "dk", "dv"))
                                 for c in cases)
    row["max_tolerance_used"] = max(
        max(c["tolerance_used"].values()) for c in cases)
    if timing:
        q, k, v, do, out, lse = main
        t = time_short_vs_stream(torch, fa, gen, *q.shape[:2], inputs=main)
        row["times"] = t
        for part in ("fwd", "bwd"):
            row.update({f"{part}_ms": t[f"short_{part}_ms"],
                        f"{part}_plain_ms": t[f"plain_{part}_ms"],
                        f"{part}_library_ms": t[f"library_{part}_ms"],
                        f"{part}_bound_ms": t[f"{part}_bound_ms"],
                        f"{part}_bound_by": t[f"{part}_bound_by"]})
        row["bound_rates"] = rates(BF16_FLOPS_PER_S, "f16 tensor-core (the "
                                   "bf16 rate)")
    return row


def time_short_vs_stream(torch, fa, gen, B, L, H=12, D=64, p=0.1,
                         inputs=None):
    """Device ms of the short kernels, the streaming K1, the plain
    version and ``F.scaled_dot_product_attention`` (forward, backward
    alone by replaying a retained graph, forward + backward) on one bf16
    input with dropout ``p`` (or on ``inputs``, (q, k, v, dO, ...) of
    another 2-byte type), and the bound of the forward and of the
    backward."""
    dev, seed = "cuda", 99
    q, k, v, do = inputs[:4] if inputs is not None else [
        torch.randn((B, L, H, D), generator=gen,
                    device=dev).to(torch.bfloat16) for _ in range(4)]
    B, L, H, D = q.shape
    out, lse = fa._cuda_short_fwd(q, k, v, False, p, seed)
    sout, slse = fa._cuda_fwd(q, k, v, False, p, seed)
    el = B * L * H * D * 2
    fb, fby = bound_of(4 * el + B * H * L * 4, 4 * B * H * L * L * D,
                       BF16_FLOPS_PER_S)
    bb, bby = bound_of(8 * el + B * H * L * 4, 10 * B * H * L * L * D,
                       BF16_FLOPS_PER_S)
    F = torch.nn.functional
    qh, kh, vh, doh = (x.permute(0, 2, 1, 3).contiguous()
                       for x in (q, k, v, do))
    qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=p)
        return torch.autograd.grad(o, (qg, kg, vg), doh)

    plain_iters = 3 if L >= 512 else 5
    t = {"batch": B, "seq": L,
         "short_fwd_ms": time_ms(torch, lambda: fa._cuda_short_fwd(
             q, k, v, False, p, seed)),
         "short_bwd_ms": time_ms(torch, lambda: fa._cuda_short_bwd(
             q, k, v, out, lse, do, False, p, seed)),
         "stream_fwd_ms": time_ms(torch, lambda: fa._cuda_fwd(
             q, k, v, False, p, seed)),
         "stream_bwd_ms": time_ms(torch, lambda: fa._cuda_bwd(
             q, k, v, sout, slse, do, False, p, seed)),
         "plain_fwd_ms": time_ms(torch, lambda: fa._plain_fwd(
             q, k, v, False, p, seed), iters=plain_iters, warmup=1),
         "plain_bwd_ms": time_ms(torch, lambda: fa._plain_bwd(
             q, k, v, out, lse, do, False, p, seed), iters=plain_iters,
             warmup=1),
         "library_fwd_ms": time_ms(
             torch, lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, dropout_p=p)),
         "library_bwd_ms": time_ms(torch, lambda: torch.autograd.grad(
             lib_out, (qg, kg, vg), doh, retain_graph=True)),
         "library_fwd_bwd_ms": time_ms(torch, lib_fwd_bwd),
         "fwd_bound_ms": fb, "fwd_bound_by": fby,
         "bwd_bound_ms": bb, "bwd_bound_by": bby}
    t["short_fwd_bwd_ms"] = t["short_fwd_ms"] + t["short_bwd_ms"]
    t["stream_fwd_bwd_ms"] = t["stream_fwd_ms"] + t["stream_bwd_ms"]
    return t


SGD_LR, SGD_WD = 0.01, 1e-4   # the main path's (phase 11's) SGD


def check_sgd(torch, fo, counters, shape_lists, timing, dtype_name="float32"):
    """K3-sgd (the table by value, a grid sized to the card, the coupled
    L2 term folded in) over each of ``shape_lists`` (LeNet's and
    BERT-base's parameter lists), bit for bit against the plain version
    with weight decay 0 and 1e-4, a skipped step launching nothing, one
    count a launch; with a 2-byte ``dtype_name``, its master form (the
    decay rounded in the parameters' type, each parameter its master's
    cast). The f32 form also: a list of more tensors than one launch's
    table holds (consecutive launches, every fifth tensor an offset
    view) bit for bit with the decay, and the launch floor (one
    four-element tensor). Timed over each list with the main path's
    decay and without it."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(8)
    lr, cap = SGD_LR, fo.static_capacity(2)
    name = "fused_sgd" + ("" if dtype_name == "float32" else "_master")
    row = {"dtype": dtype_name, "max_abs_err": 0.0, "bitwise": True,
           "capacity": cap}

    def dup(x):
        """a copy as far from 16-byte alignment as x (offset views stay
        offset, on the walker's scalar path)"""
        off = x.data_ptr() % 16 // x.element_size()
        return torch.empty(x.numel() + off, device=dev, dtype=x.dtype)[
            off:].view(x.shape).copy_(x)

    def step(ps, gs, ws, wd, skip=False):
        return fo.fused_sgd_(ps, gs, lr=lr, weight_decay=wd, skip=skip,
                             masters=ws)

    def plain(ps, gs, ws, wd):
        if ws is not None and wd:      # the decay in the parameters' type
            gs = fo._plain_decay_2byte(ps, gs, fo.decay_in(ps[0].dtype, wd))
        plain_over(fo, ps, gs, ws, False, lambda w, g: fo._plain_sgd_(
            w, g, np.float32(lr), np.float32(wd if ws is None else 0.0),
            False))

    def compare(label, ps, gs, ws, wd):
        kp, pp = [dup(x) for x in ps], [dup(x) for x in ps]
        kw, pw = (None, None) if ws is None else ([dup(x) for x in ws],
                                                  [dup(x) for x in ws])
        c0 = counters.get(name)
        skipped = step(kp, gs, kw, wd, skip=True)
        rec = step(kp, gs, kw, wd)
        plain(pp, gs, pw, wd)
        torch.cuda.synchronize()
        got, want = kp + (kw or []), pp + (pw or [])
        differ = sum(int(not torch.equal(a, b)) for a, b in zip(got, want))
        expect(differ == 0, f"fused SGD ({dtype_name}, {label}, wd {wd}) "
                            f"differs bitwise in {differ} tensors")
        if kw is not None:
            expect(same_bits(torch, kp, [w.to(p.dtype)
                                         for p, w in zip(kp, kw)]),
                   f"fused SGD ({label}): a parameter is not its master's "
                   f"cast")
        want = len(fo.table_splits(len(ps), fo.static_capacity(
            2 if ws is None else 3)))
        launched = counters.get(name) - c0
        expect(launched == want, f"fused SGD ({label}): {launched} launches "
                                 f"(a skipped step included), want {want}")
        cover = {"tensors": len(ps), "elements": sum(p.numel() for p in ps)}
        expect(rec == dict(cover, launches=want) and
               skipped == dict(cover, launches=0),
               f"fused SGD ({label}): the launches covered {rec}, the "
               f"skipped step {skipped}")
        return launched

    for label, shapes in shape_lists.items():
        ps = [torch.randn(s, generator=gen, device=dev) * 0.05
              for s in shapes]
        gs = [torch.randn(s, generator=gen, device=dev) * 1e-2
              for s in shapes]
        ps, gs, ws = k3_form(torch, ps, gs, dtype_name)
        for wd in (0.0, SGD_WD):
            compare(label, ps, gs, ws, wd)
        n = sum(p.numel() for p in ps)
        # g, p read once, p written once (f32: 12 bytes an element); the
        # master form reads the 2-byte g and p and the master and writes
        # the master and p (14); 4 flops an element with the decay
        per = 12 if ws is None else 14
        row[label] = {"params": len(shapes), "elements": n,
                      "bytes_per_element": per}
        if timing:
            t_b, by = bound_of(per * n, 4 * n, F32_FLOPS_PER_S)
            lib = k3_library(torch, ps, gs, ws, lambda p: torch.optim.SGD(
                p, lr=lr, weight_decay=SGD_WD, fused=True))
            kp = [x.clone() for x in ps]
            kw = None if ws is None else [x.clone() for x in ws]
            # the wrapper checks and tables up to 206 tensors on the host
            # (past the default spin at BERT-base's list): a long spin
            # keeps that host work out of the device time
            spin = STATIC_SPIN_CYCLES
            pp = [x.clone() for x in ps]
            pw = None if ws is None else [x.clone() for x in ws]
            row[label].update({
                "ms": time_ms(torch, lambda: step(kp, gs, kw, SGD_WD),
                              spin=spin),
                "ms_wd0": time_ms(torch, lambda: step(kp, gs, kw, 0.0),
                                  spin=spin),
                "plain_ms": time_ms(torch, lambda: plain(pp, gs, pw,
                                                         SGD_WD), iters=5),
                "library_ms": time_ms(torch, lib, spin=spin),
                "bound_ms": t_b, "bound_by": by})
    first = next(iter(shape_lists))
    if timing:
        row.update({k: row[first][k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by")})
        row["bound_rates"] = rates(F32_FLOPS_PER_S, "f32")
    if dtype_name != "float32":
        return row
    n = max(1400, cap + 1)
    sizes = [1 + k % 9 for k in range(n)]

    def split_list(scale):
        out = []
        for k, m in enumerate(sizes):
            x = torch.randn(m + 1, generator=gen, device=dev) * scale
            out.append(x[1:] if k % 5 == 0 else x[:m])
        return out

    launched = compare("split", split_list(0.05), split_list(1e-2), None,
                       SGD_WD)
    expect(launched >= 2, f"fused SGD: {n} tensors took {launched} launch")
    row["split"] = {"params": n, "elements": sum(sizes),
                    "launches": launched}
    if timing:
        p4 = [torch.randn(4, generator=gen, device=dev)]
        g4 = [torch.randn(4, generator=gen, device=dev)]
        row["floor_ms"] = time_ms(torch, lambda: fo.fused_sgd_(
            p4, g4, lr=lr, weight_decay=SGD_WD), spin=STATIC_SPIN_CYCLES)
    return row


def check_lamb(torch, fo, counters, shapes, timing, dtype_name="float32"):
    """K3-lamb (phase 1 with the norms folded in, then the apply) over
    BERT-base's parameter list, from non-zero moments, with every
    bias-like tensor (1-D) at zero, as at initialisation (trust 1
    there): p, m, v and the trust-ratio numerator r bit for bit the
    plain version's given the kernels' norms (``k3_compare``); those
    norms within rtol 1e-6 of f64 norms of the same tensors, and the
    same in a second launch. With a 2-byte ``dtype_name``, its master
    form: the norms are the masters'."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(9)

    def make(scale, positive=False, zero_1d=False):
        out = []
        for s in shapes:
            x = torch.randn(s, generator=gen, device=dev) * scale
            if zero_1d and len(s) == 1:
                x.zero_()
            out.append(x.abs() if positive else x)
        return out

    ps, gs = make(0.02, zero_1d=True), make(1e-3)
    ms, vs = make(1e-4), make(1e-6, positive=True)
    ps, gs, ws = k3_form(torch, ps, gs, dtype_name)
    hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              step=3)
    lr, c1, c2, _ = fo.adam_scalars(1e-3, 0.9, 0.999, 3)
    caches, seen = {}, {}

    def kernel(s, skip=False):
        fo.fused_lamb_(s[0], gs, s[2], s[3], s[4], skip=skip, masters=s[1],
                       cache=caches.setdefault(id(s[0]), {}), **hp)

    def plain(s, k):
        def run(w, g):
            fo._plain_lamb_phase1_(w, g, s[2], s[3], s[4], 0.9, 0.999, 1e-6,
                                   0.01, c1, c2)
            seen["want"] = torch.stack(torch._foreach_norm(
                [x.double() for x in w + s[4]])).float()
            fo._plain_lamb_apply_(w, s[4], norms(k), lr)

        plain_over(fo, s[0], gs, s[1], False, run)

    def norms(k):
        return fo.lamb_kernel_norms(caches[id(k[0])])

    weights = ps if ws is None else ws
    state = [ps, ws, ms, vs, [torch.empty_like(w) for w in weights]]
    k, again = k3_compare(torch, counters, f"fused Lamb ({dtype_name})",
                          k3_names(["fused_lamb_phase1", "fused_lamb_apply"],
                                   ws), state, kernel, plain)
    expect(same_bits(torch, [norms(k)], [norms(again)]),
           "fused Lamb: two launches took different norms")
    want = seen["want"]
    norm_err = float(((norms(k) - want).abs()
                      / want.clamp_min(1e-30)).max())
    expect(norm_err <= 1e-6 and bool((norms(k)[want == 0] == 0).all()),
           f"fused Lamb ({dtype_name}): norms off f64 by {norm_err} (rtol "
           f"1e-6)")
    zero = [i for i, s in enumerate(shapes) if len(s) == 1]
    expect(all(bool(torch.isfinite(k[0][i]).all()) for i in zero),
           "fused Lamb: a zero parameter became non-finite")
    n = sum(p.numel() for p in ps)
    pieces, _ = fo.lamb_pieces([p.numel() for p in ps])
    row = dict(k3_row(dtype_name, shapes, n, 40), zero_params=len(zero),
               pieces=int(pieces.shape[0]), norm_max_rel_err=norm_err)
    if timing:
        # the function reads g, p (or the master), m, v once and writes
        # them (and a 2-byte p) once, 28 bytes an element; the kernels
        # also write r in phase 1 and read it and p again in the apply,
        # 40 bytes an element in all; ~20 flops an element
        t_b, by = bound_of(28 * n, 20 * n, F32_FLOPS_PER_S)
        rs = [torch.empty_like(w) for w in weights]
        row.update({
            "ms": time_ms(torch, lambda: kernel(k)),
            "plain_ms": time_ms(torch, lambda: plain_over(
                fo, ps, gs, ws, False, lambda w, g: fo._plain_lamb_(
                    w, g, ms, vs, rs, lr, 0.9, 0.999, 1e-6, 0.01, c1, c2,
                    False)), iters=5),
            "library_ms": None,
            "bound_ms": t_b, "bound_by": by,
            "kernels_bytes_ms": 40 * n / HBM_BYTES_PER_S * 1e3,
            "bound_rates": rates(F32_FLOPS_PER_S, "f32")})
    return row


# ---------------------------------------------------------------------------
# phase 1: K3's 2-byte forms without masters
# ---------------------------------------------------------------------------
# bytes an element each form reads and writes once (2 an array) and its
# f32 operations an element (the rounding steps not counted)
K3_2BYTE = {"adam": (14, 16), "momentum": (10, 5), "sgd": (6, 4),
            "lamb": (14, 20)}


def k3_2byte_state(torch, gen, shapes, dt, scales, positive=()):
    """Tensors of type ``dt`` shaped like ``shapes``, one list a scale,
    made in f32 from ``gen`` and rounded once; the lists at the indices
    in ``positive`` take absolute values."""
    out = []
    for i, scale in enumerate(scales):
        xs = []
        for s in shapes:
            x = torch.randn(s, generator=gen, device="cuda") * scale
            xs.append((x.abs() if i in positive else x).to(dt))
        out.append(xs)
    return out


def k3_2byte_row(torch, name, n, rows, kernel_ms, plain_ms, library_ms):
    per, flops = K3_2BYTE[name]
    t_b, by = bound_of(per * n, flops * n, F32_FLOPS_PER_S)
    return dict(rows, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=t_b, bound_by=by,
                bytes_per_element=per,
                bound_rates=rates(F32_FLOPS_PER_S, "f32"))


def check_k3_2byte(torch, fo, counters, bert_shapes, resnet_shapes, timing):
    """K3's 2-byte forms without masters (state in the parameters' type,
    each operation rounded to it), over bf16 and f16: Adam without and
    with AdamW's decay and Lamb (phase 1 + apply) at BERT-base's 206
    tensors, Momentum without and with Nesterov at ResNet-50's 161, SGD
    without and with its coupled L2 term at BERT-base's; each bit for
    bit against its plain version (Lamb's apply given the kernel's
    sums), two launches bit for bit, one count a call, a skipped step
    launching nothing and changing nothing. Timed beside the bound and
    ``torch.optim.AdamW`` / ``SGD(momentum=0.9)`` / ``SGD`` with
    ``fused=True`` over the same 2-byte tensors (Lamb has none).
    Returns {kernel name: row}."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for dtype_name in ("bfloat16", "float16"):
        dt = getattr(torch, dtype_name)
        tag = fo.TWO_BYTE[dt]
        # f16 state sits near its subnormals at bf16's scales: larger ones
        g_s, m_s, v_s = (1e-3, 1e-4, 1e-6) if tag == "bf16" \
            else (1e-2, 1e-3, 1e-4)
        caches = {}

        def cache(s):
            return caches.setdefault(id(s[0]), {})

        # Adam(W) at BERT-base's list
        ps, gs, ms, vs = k3_2byte_state(torch, gen, bert_shapes, dt,
                                        (0.02, g_s, m_s, v_s), positive=(3,))
        n = sum(p.numel() for p in ps)
        for wd in (0.0, 0.01):
            hp = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, step=3,
                      weight_decay=wd)
            sc = fo.adam_scalars_2byte(dt, **{k: hp[k] for k in (
                "lr", "beta1", "beta2", "eps", "step")}, weight_decay=wd)

            def kernel(s, skip=False, hp=hp):
                fo.fused_adam_(s[0], gs, s[2], s[3], skip=skip,
                               cache=cache(s), **hp)

            def plain(s, _=None, sc=sc):
                fo._plain_adam_2byte_(s[0], gs, s[2], s[3], sc, False)

            runs = k3_compare(torch, counters, f"2-byte Adam ({tag}, wd "
                              f"{wd})", ["fused_adam_" + tag],
                              [ps, None, ms, vs], kernel, plain, skip=True)
        if timing:
            k = runs[0]
            lib = k3_library(torch, ps, gs, None, lambda p: torch.optim.AdamW(
                p, lr=1e-4, weight_decay=0.01, fused=True))
            rows["fused_adam_" + tag] = k3_2byte_row(
                torch, "adam", n, dict(k3_row(dtype_name, bert_shapes, n, 14),
                                       weight_decays=[0.0, 0.01]),
                time_ms(torch, lambda: kernel(k)),
                time_ms(torch, lambda: plain([ps, None, ms, vs]), iters=5),
                time_ms(torch, lib))
        else:
            rows["fused_adam_" + tag] = k3_row(dtype_name, bert_shapes, n, 14)
        # SGD at BERT-base's list, without and with the coupled L2 term
        ps, gs = k3_2byte_state(torch, gen, bert_shapes, dt, (0.05, g_s))
        for wd in (0.0, SGD_WD):
            wd_t = fo.decay_in(dt, wd) if wd else 0.0

            def kernel(s, skip=False, wd=wd):
                fo.fused_sgd_(s[0], gs, lr=SGD_LR, weight_decay=wd,
                              skip=skip)

            def plain(s, _=None, wd_t=wd_t):
                fo._plain_sgd_2byte_(s[0], gs, fo.decay_in(dt, SGD_LR), wd_t,
                                     False)

            runs = k3_compare(torch, counters, f"2-byte SGD ({tag}, wd {wd})",
                              ["fused_sgd_" + tag], [ps, None], kernel, plain,
                              skip=True)
        row = dict(k3_row(dtype_name, bert_shapes, n, 6),
                   weight_decays=[0.0, SGD_WD])
        if timing:
            k = runs[0]
            lib = k3_library(torch, ps, gs, None, lambda p: torch.optim.SGD(
                p, lr=SGD_LR, weight_decay=SGD_WD, fused=True))
            row = k3_2byte_row(torch, "sgd", n, row,
                               time_ms(torch, lambda: kernel(k),
                                       spin=STATIC_SPIN_CYCLES),
                               time_ms(torch, lambda: plain([ps, None]),
                                       iters=5),
                               time_ms(torch, lib, spin=STATIC_SPIN_CYCLES))
        rows["fused_sgd_" + tag] = row
        # Lamb at BERT-base's list, the 1-D tensors at zero (trust 1)
        ps, gs, ms, vs = k3_2byte_state(torch, gen, bert_shapes, dt,
                                        (0.02, g_s, m_s, v_s), positive=(3,))
        for p in ps:
            if p.dim() == 1:
                p.zero_()
        hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6,
                  weight_decay=0.01, step=3)
        sc = fo.adam_scalars_2byte(dt, 1e-3, 0.9, 0.999, 1e-6, 3)
        wd_t = fo.decay_in(dt, 0.01)

        def kernel(s, skip=False):
            fo.fused_lamb_(s[0], gs, s[2], s[3], s[4], skip=skip,
                           cache=cache(s), **hp)

        def plain(s, k):
            fo._plain_lamb_phase1_2byte_(s[0], gs, s[2], s[3], s[4], sc,
                                         wd_t)
            fo._plain_lamb_apply_2byte_(
                s[0], s[4], fo.lamb_kernel_sums(caches[id(k[0])]), sc[0])

        state = [ps, None, ms, vs, [torch.empty_like(p) for p in ps]]
        k, again = k3_compare(torch, counters, f"2-byte Lamb ({tag})",
                              ["fused_lamb_phase1_" + tag,
                               "fused_lamb_apply_" + tag], state, kernel,
                              plain, skip=True)
        sums = fo.lamb_kernel_sums(caches[id(k[0])])
        expect(same_bits(torch, [sums], [fo.lamb_kernel_sums(
            caches[id(again[0])])]), f"2-byte Lamb ({tag}): two launches "
                                     f"took different sums")
        want = fo._lamb_sums_2byte(ps, k[4])
        # an f16 r past 256 squares to inf (r = m/eps where v is 0):
        # those sums are inf in both, the rest within rtol 1e-6 of f64
        fin = torch.isfinite(want)
        sum_err = float(((sums - want).abs()[fin]
                         / want[fin].clamp_min(1e-30)).max())
        expect(sum_err <= 1e-6 and torch.equal(fin, torch.isfinite(sums))
               and torch.equal(sums[~fin], want[~fin]),
               f"2-byte Lamb ({tag}): sums off f64 by {sum_err} (rtol "
               f"1e-6), or their infinities differ")
        zero = [i for i, s in enumerate(bert_shapes) if len(s) == 1]
        expect(all(bool(torch.isfinite(k[0][i]).all()) for i in zero),
               f"2-byte Lamb ({tag}): a zero parameter became non-finite")
        row = dict(k3_row(dtype_name, bert_shapes, n, 14),
                   zero_params=len(zero), sums_max_rel_err=sum_err,
                   infinite_sums=int((~fin).sum()))
        if timing:
            rs = [torch.empty_like(p) for p in ps]
            row = k3_2byte_row(
                torch, "lamb", n, row, time_ms(torch, lambda: kernel(k)),
                time_ms(torch, lambda: fo._plain_lamb_2byte_(
                    ps, gs, ms, vs, rs, sc, wd_t, False), iters=5), None)
            row["kernels_bytes_ms"] = 20 * n / HBM_BYTES_PER_S * 1e3
        rows["fused_lamb_" + tag] = row
        del ps, gs, ms, vs, state, k, again
        # Momentum at ResNet-50's list, without and with Nesterov
        ps, gs, vs = k3_2byte_state(torch, gen, resnet_shapes, dt,
                                    (0.05, g_s, g_s))
        n = sum(p.numel() for p in ps)
        lr_t, mu_t = fo.decay_in(dt, 0.1), fo.decay_in(dt, 0.9)
        for nesterov in (False, True):
            def kernel(s, skip=False, nesterov=nesterov):
                fo.fused_momentum_(s[0], gs, s[2], lr=0.1, momentum=0.9,
                                   nesterov=nesterov, skip=skip,
                                   cache=cache(s))

            def plain(s, _=None, nesterov=nesterov):
                fo._plain_momentum_2byte_(s[0], gs, s[2], lr_t, mu_t,
                                          nesterov, False)

            runs = k3_compare(torch, counters, f"2-byte Momentum ({tag}, "
                              f"nesterov={nesterov})",
                              ["fused_momentum_" + tag], [ps, None, vs],
                              kernel, plain, skip=True)
            if not nesterov:
                k, kernel0, plain0 = runs[0], kernel, plain
        row = dict(k3_row(dtype_name, resnet_shapes, n, 10),
                   nesterov_bitwise=True)
        if timing:
            lib = k3_library(torch, ps, gs, None, lambda p: torch.optim.SGD(
                p, lr=0.1, momentum=0.9, fused=True))
            row = k3_2byte_row(torch, "momentum", n, row,
                               time_ms(torch, lambda: kernel0(k)),
                               time_ms(torch, lambda: plain0([ps, None, vs]),
                                       iters=5),
                               time_ms(torch, lib))
        rows["fused_momentum_" + tag] = row
        del ps, gs, vs, k, runs
        torch.cuda.empty_cache()
    if timing:
        # the bounds worked out from the bytes: AdamW 14 B x 110.2 M at
        # 3.35 TB/s ~ 0.46 ms, Momentum 10 B x 25.5 M ~ 0.076 ms
        rows["bound_check"] = {
            "adam_bf16_bound_ms": rows["fused_adam_bf16"]["bound_ms"],
            "momentum_bf16_bound_ms": rows["fused_momentum_bf16"]["bound_ms"]}
    return rows


# ---------------------------------------------------------------------------
# phases 5-6: the BERT pretraining step
# ---------------------------------------------------------------------------
BERT_BATCH, BERT_SEQ = 128, 128
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                 "fused_xent_fwd", "fused_xent_bwd", "fused_adam")


class swapped:
    """Point each ``module.name`` of ``swaps`` ([(module, name, fn)]) at
    ``fn`` inside the block: the parity runs route the kernels' wrappers
    to their plain versions on the card (the port itself has no such
    switch: a CUDA tensor always launches the kernel)."""

    def __init__(self, swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.swaps]
        for m, n, f in self.swaps:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)
        return False


def plain_over(fo, params, grads, masters, skip, run):
    """``run(weights, grads)``, a plain version; for a master form on the
    masters with the gradients upcast, then each parameter set to its
    master's cast (the wrappers' own plain route)."""
    if masters is None:
        run(params, grads)
    elif not skip:
        run(masters, fo._upcast(grads))
        fo._cast_down_(params, masters)


def bert_plain_swaps(fa, fx, fo, optmod):
    def plain_adam(params, grads, m1, m2, *, lr, beta1, beta2, eps,
                   step, weight_decay=0.0, skip=False, cache=None,
                   masters=None):
        if masters is None and params[0].dtype in fo.TWO_BYTE:
            fo._plain_adam_2byte_(params, grads, m1, m2, fo.adam_scalars_2byte(
                params[0].dtype, lr, beta1, beta2, eps, step, weight_decay),
                skip)
            return
        lr32, c1, c2, lrwd = fo.adam_scalars(lr, beta1, beta2, step,
                                             weight_decay)
        plain_over(fo, params, grads, masters, skip, lambda w, g:
                   fo._plain_adam_(w, g, m1, m2, lr32, beta1, beta2, eps,
                                   c1, c2, lrwd, skip))

    return [(fa, "flash_attention_fwd", fa._plain_fwd),
            (fa, "flash_attention_bwd", fa._plain_bwd),
            (fx, "fused_xent_fwd", fx._plain_fwd),
            (fx, "fused_xent_bwd", fx._plain_bwd),
            (optmod, "fused_adam_", plain_adam)]


def bert_batch(torch, rng, B, S, vocab):
    ids = rng.randint(0, vocab, (B, S)).astype(np.int32)
    tt = np.zeros((B, S), np.int32)
    mlm = rng.randint(0, vocab, (B, S)).astype(np.int32)
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    return [torch.tensor(x, device="cuda") for x in (ids, tt, mlm, nsp)]


def key_padding_mask(torch, lens, L):
    """(B, 1, 1, L) bool key-padding mask: True at positions < lens[b]."""
    lens = torch.tensor(np.asarray(lens), device="cuda")
    return (torch.arange(L, device="cuda") < lens[:, None])[:, None, None, :]


MASKED_KERNELS = ("flash_attention_masked_fwd", "flash_attention_masked_bwd",
                  "fused_xent_fwd", "fused_xent_bwd", "fused_adam")


def phase_bert_parity(torch, counters, fa, fx, fo, masked=False):
    """One TrainStep of a tiny BERT with the kernels and with the plain
    versions, from the same weights, on the card (f32, no dropout);
    ``masked``: a padded batch (lengths below 128, a (B, 1, 1, 128) bool
    key-padding mask, no MLM labels at padding) through the masked flash
    kernels."""
    import copy

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import optimizer as optmod

    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = BertForPretraining(cfg, generator=gen)
    batch = bert_batch(torch, np.random.RandomState(4), 8, 128,
                       cfg.vocab_size)
    batch[2][:, ::3] = -100                        # some ignored positions
    want_kernels, name_ = TRAIN_KERNELS, "bert_parity"
    if masked:
        lens = np.random.RandomState(5).randint(16, 128, 8)
        mask = key_padding_mask(torch, lens, 128)
        batch[2][~mask[:, 0, 0, :]] = -100         # no loss at padding
        batch.append(mask)
        want_kernels, name_ = MASKED_KERNELS, "bert_masked_parity"
    lr = 1e-4
    runs = {}
    for name in ("kernel", "plain"):
        model = copy.deepcopy(base)
        step = TrainStep(model, lambda m, *a: m.loss(*a),
                         AdamW(learning_rate=lr,
                               parameters=model.parameters()))
        counters.reset()
        if name == "plain":
            with swapped(bert_plain_swaps(fa, fx, fo, optmod)):
                loss = step(*batch)
        else:
            loss = step(*batch)
        torch.cuda.synchronize()
        runs[name] = (float(loss), model, counters.snapshot())
    (lk, mk, ck), (lp, mp, cp) = runs["kernel"], runs["plain"]
    expect(all(ck.get(n, 0) > 0 for n in want_kernels),
           f"{name_}: a training kernel did not launch: {ck}")
    expect(not any(cp.get(n, 0) for n in want_kernels),
           f"{name_}: the plain run launched kernels: {cp}")
    if masked:
        expect(not ck.get("flash_attention_fwd", 0)
               and not ck.get("flash_attention_bwd", 0),
               f"{name_}: the unmasked flash kernels ran: {ck}")
    expect(abs(lk - lp) <= 1e-5 * abs(lp),
           f"{name_}: loss {lk} (kernels) against {lp} (plain)")
    worst_g, worst_p = {"err": 0.0}, 0.0
    pp = dict(mp.named_parameters())
    for n, p in mk.named_parameters():
        q = pp[n]
        gerr = max_err(p.grad, q.grad)
        gscale = float(q.grad.abs().max())
        # largest error within 1e-4 of the largest |g|, or 1e-7 where
        # the true gradient is zero (the key projection's bias)
        expect(gerr <= 1e-4 * gscale + 1e-7,
               f"{name_}: grad of {n} differs by {gerr} (max |g| "
               f"{gscale})")
        if gerr > worst_g["err"]:
            worst_g = {"err": gerr, "max_abs": gscale, "param": n}
        # step 1 of Adam moves each element by lr * g / (|g| + eps), so
        # gradients equal to 1e-4 of their scale give updates within
        # 2 lr of each other, and equal wherever |g| >> eps
        perr = max_err(p, q)
        expect(perr <= 2 * lr, f"{name_}: updated {n} differs by {perr}")
        worst_p = max(worst_p, perr)
    return {"phase": name_, "config": "tiny (2 x 128, 2 heads, ffn 256, "
            "vocab 1024), batch 8 x 128, f32, no dropout"
            + (", key-padding mask, lengths 16-127" if masked else ""),
            "loss_kernel": lk, "loss_plain": lp,
            "max_grad_err": worst_g, "max_param_err": worst_p,
            "launches": ck}


def bert_family(name):
    if "flash_fwd_" in name:        # flash_fwd_mma (bf16), _kernel (f32)
        return "flash_fwd"
    if any(t in name for t in ("flash_dq_", "flash_dkv_")):
        return "flash_bwd"
    if any(t in name for t in ("xent_fwd_", "xent_split_fwd")):
        return "xent_fwd"
    if any(t in name for t in ("xent_bwd_", "xent_split_bwd")):
        return "xent_bwd"
    if "adamrule" in name or "adam2rule" in name:
        return "adam"
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "gemm"
    return "other"


BERT_FAMILIES = ("flash_fwd", "flash_bwd", "xent_fwd", "xent_bwd", "adam",
                 "gemm", "other")


def resnet_family(name):
    """cuDNN names its convolution kernels by pass: fprop (forward),
    dgrad (input gradient), wgrad (weight gradient); the layout
    transposes around them are their own family."""
    if "momentumrule" in name:
        return "momentum"
    if any(t in name for t in ("dgrad", "wgrad", "bwd_data", "bwd_filter",
                               "backward_data", "backward_filter")):
        return "conv_bwd"
    if "nchwtonhwc" in name or "nhwctonchw" in name:
        return "conv_layout"
    if any(t in name for t in ("fprop", "convolve", "winograd",
                               "implicit_gemm", "conv2d")):
        return "conv_fwd"
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "gemm"
    return "bn_elementwise"


RESNET_FAMILIES = ("conv_fwd", "conv_bwd", "conv_layout", "bn_elementwise",
                   "gemm", "momentum")


def profile_step(torch, step, batch, family, families, step_ms, spans=()):
    """Device time by family (``family(lowercase kernel name)``) over one
    training step under torch.profiler, the ten longest kernels (and
    the three longest of each family), the number of kernels, and the
    device's busy share of that step's wall time and of ``step_ms`` (the
    median unprofiled step: the profiler slows the host's launches);
    with ``spans``, the host ms and count of each named
    ``record_function`` range (the collectives' ``collectives.<op>``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams = dict.fromkeys(families, 0.0)
    by_name, kernels = {}, 0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA" \
                or getattr(e, "is_user_annotation", False):
            continue        # a record_function range is not device work
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        fam = family(e.name.lower())
        fams[fam] += us / 1e3
        key = (fam, e.name[:120])
        by_name[key] = by_name.get(key, 0.0) + us / 1e3
        kernels += 1
    busy = sum(fams.values())
    if busy <= 0:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = {f: dict([(name, ms) for (g, name), ms in ranked if g == f][:3])
           for f in families}
    host = {}
    for e in prof.events():
        if e.name in spans and str(getattr(e, "device_type", "")) \
                .split(".")[-1] == "CPU":
            ms, n = host.get(e.name, (0.0, 0))
            host[e.name] = (ms + e.cpu_time_total / 1e3, n + 1)
    extra = {"host_spans_ms": {k: v[0] for k, v in host.items()},
             "host_spans_count": {k: v[1] for k, v in host.items()}} \
        if spans else {}
    return {**extra, "wall_ms": wall_ms, "device_ms": fams,
            "device_busy_share": busy / wall_ms,
            "device_share_of_median_step": busy / step_ms, "kernels": kernels,
            "top_kernels_ms": {name: ms for (_, name), ms in ranked[:10]},
            "top_by_family_ms": top}


WARM_STEPS, TIMED_STEPS = 3, 10


def train_steps(torch, counters, step, batch, after=None,
                timed=TIMED_STEPS):
    """WARM_STEPS + ``timed`` training steps, each ending in a device
    synchronise, with the launch counts set to 0 just before: (losses,
    wall ms of each timed step, the launches). ``after`` runs after each
    step (a scheduler's ``step``)."""
    counters.reset()
    losses, step_ms = [], []
    for i in range(WARM_STEPS + timed):
        t0 = time.perf_counter()
        loss = float(step(*batch))
        torch.cuda.synchronize()
        if i >= WARM_STEPS:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if after is not None:
            after()
    return losses, step_ms, counters.snapshot()


def bert_flops_per_step(cfg, B, S):
    """``bench.py:1473-1477``'s closed form: 3 x the forward's matmul
    flops (attention projections 8H^2, ffn 4HI and scores and values
    4SH a layer; the MLM transform 2H^2 and vocabulary 2HV)."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    fwd_per_token = cfg.num_hidden_layers * (8 * H * H + 4 * H * I
                                             + 4 * S * H) \
        + 2 * H * H + 2 * H * V
    return 3 * fwd_per_token * B * S


def phase_bert(torch, counters):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig.base()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = BertForPretraining(cfg, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())

    def loss_fn(m, ids, tt, mlm, nsp):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(ids, tt, mlm, nsp)

    step = TrainStep(model, loss_fn, opt)
    B, S = BERT_BATCH, BERT_SEQ
    batch = bert_batch(torch, np.random.RandomState(0), B, S,
                       cfg.vocab_size)
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    L = cfg.num_hidden_layers
    want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
            "fused_xent_fwd": 1, "fused_xent_bwd": 1, "fused_adam": 1}
    per_step = {k: launches.get(k, 0) / n_steps for k in want}
    expect(all(np.isfinite(losses)), f"bert: non-finite loss {losses}")
    expect(losses[-1] < losses[0],
           f"bert: loss did not fall ({losses[0]} -> {losses[-1]})")
    for k, n in want.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"bert: {k} launched {launches.get(k, 0)} times over "
               f"{n_steps} steps, want {n} a step")
    expect(all(p.grad is not None for p in model.parameters()),
           "bert: a parameter got no gradient, so Adam skipped it")
    expect(len(opt._kernel_cache[(torch.float32, False)]["key"]) == 5 * len(
        list(model.parameters())), "bert: the Adam launch did not cover "
                                   "every parameter")
    flops_per_step = bert_flops_per_step(cfg, B, S)
    med = float(np.median(step_ms))
    breakdown = profile_step(torch, step, batch, bert_family, BERT_FAMILIES,
                             med)
    return {"phase": "bert", "config": "BERT-base (vocab 30592, 12 x 768, "
            "12 x 64 heads, ffn 3072), batch 128 x seq 128, AMP O1 bf16, "
            "dropout 0.1, AdamW lr 1e-4 wd 0.01",
            "params": n_params, "warmup_steps": WARM_STEPS,
            "timed_steps": TIMED_STEPS,
            "tokens_per_s": B * S * TIMED_STEPS / (sum(step_ms) / 1e3),
            "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
            "step_ms": step_ms,
            "flops_per_step": flops_per_step,
            "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "launches": launches,
            "launches_per_step": per_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "breakdown": breakdown}, launches


# ---------------------------------------------------------------------------
# phases 7-8: ResNet training
# ---------------------------------------------------------------------------
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000


def phase_resnet_parity(torch, counters, fo):
    """Two Momentum TrainSteps of a small ResNet (BottleneckBlock
    [1, 1, 1, 1], 10 classes, batch 4 x 64 x 64, f32) with the kernel and
    again with the plain version, from the same weights, on the card,
    with cuDNN deterministic so that both runs get the same gradients:
    losses, parameters, velocities and running statistics bit for bit."""
    import copy

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.optimizer import optimizer as optmod
    from paddle_tpu_torch.vision.models import BottleneckBlock, ResNet

    def plain_momentum(params, grads, velocities, *, lr, momentum,
                       nesterov, skip=False, cache=None, masters=None):
        plain_over(fo, params, grads, masters, skip, lambda w, g:
                   fo._plain_momentum_(w, g, velocities, np.float32(lr),
                                       np.float32(momentum), nesterov,
                                       skip))

    gen = torch.Generator(device="cuda").manual_seed(5)
    base = ResNet(BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                  generator=gen)
    rng = np.random.RandomState(6)
    x = torch.tensor(rng.randn(4, 3, 64, 64).astype(np.float32),
                     device="cuda")
    y = torch.tensor(rng.randint(0, 10, (4,)), device="cuda")
    ce = nn.CrossEntropyLoss()
    runs = {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in ("kernel", "plain"):
            model = copy.deepcopy(base)
            opt = Momentum(learning_rate=0.1, momentum=0.9,
                           parameters=model.parameters())
            step = TrainStep(model, lambda m, a, b: ce(m(a), b), opt)
            counters.reset()
            if name == "plain":
                swap = [(optmod, "fused_momentum_", plain_momentum)]
                with swapped(swap):
                    losses = [float(step(x, y)) for _ in range(2)]
            else:
                losses = [float(step(x, y)) for _ in range(2)]
            torch.cuda.synchronize()
            runs[name] = (losses, model, opt, counters.snapshot())
    finally:
        torch.backends.cudnn.deterministic = prev
    (lk, mk, ok, ck), (lp, mp, op, cp) = runs["kernel"], runs["plain"]
    expect(ck.get("fused_momentum", 0) == 2,
           f"resnet_parity: the Momentum kernel launched {ck} times, want 2")
    expect(not cp.get("fused_momentum", 0),
           f"resnet_parity: the plain run launched the kernel: {cp}")
    expect(lk == lp, f"resnet_parity: losses {lk} (kernel) against {lp} "
                     f"(plain)")
    expect(all(np.isfinite(lk)), f"resnet_parity: non-finite loss {lk}")
    pp = dict(mp.named_parameters())
    pb = dict(mp.named_buffers())
    errs = {"param": 0.0, "velocity": 0.0, "grad": 0.0, "buffer": 0.0}
    for n, p in mk.named_parameters():
        q = pp[n]
        errs["grad"] = max(errs["grad"], max_err(p.grad, q.grad))
        errs["param"] = max(errs["param"], max_err(p, q))
        errs["velocity"] = max(errs["velocity"], max_err(
            ok._slots[id(p)]["velocity"], op._slots[id(q)]["velocity"]))
    for n, b in mk.named_buffers():
        errs["buffer"] = max(errs["buffer"], max_err(b, pb[n]))
    expect(not any(errs.values()),
           f"resnet_parity: kernel and plain runs differ: {errs}")
    expect(bool((mk.layer4[0].bn2._variance != 1.0).any()),
           "resnet_parity: the running variance was not updated")
    return {"phase": "resnet_parity", "config": "ResNet BottleneckBlock "
            "[1, 1, 1, 1], 10 classes, batch 4 x 3 x 64 x 64, f32, "
            "Momentum lr 0.1 mu 0.9, two steps, cudnn.deterministic",
            "losses": lk, "max_abs_err": errs, "bitwise": True,
            "launches": ck}


def phase_resnet50(torch, counters):
    """``bench_resnet``'s configuration at full width and depth."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()                  # earlier phases' garbage off the card
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = resnet50(num_classes=RESNET_CLASSES, generator=gen)
    params = list(model.parameters())
    opt = Momentum(learning_rate=0.1, momentum=0.9, parameters=params)
    ce = nn.CrossEntropyLoss()

    def loss_fn(m, x, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return ce(m(x), y)

    step = TrainStep(model, loss_fn, opt)
    B, S = RESNET_BATCH, RESNET_SIZE
    rng = np.random.RandomState(0)
    batch = (torch.tensor(rng.randn(B, 3, S, S).astype(np.float32),
                          device="cuda"),
             torch.tensor(rng.randint(0, RESNET_CLASSES, (B,)).astype(
                 np.int64), device="cuda"))
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    expect(all(np.isfinite(losses)), f"resnet50: non-finite loss {losses}")
    expect(launches.get("fused_momentum", 0) == n_steps,
           f"resnet50: fused_momentum launched "
           f"{launches.get('fused_momentum', 0)} times over {n_steps} steps, "
           f"want one a step")
    expect(all(p.grad is not None for p in params),
           "resnet50: a parameter got no gradient, so Momentum skipped it")
    expect(len(opt._kernel_cache[(torch.float32, False)]["key"])
           == 4 * len(params),
           "resnet50: the Momentum launch did not cover every parameter")
    bufs = [b for _, b in model.named_buffers()]
    expect(len(bufs) == 2 * 53 and all(bool(torch.isfinite(b).all())
                                       for b in bufs),
           "resnet50: a running statistic is missing or not finite")
    expect(bool((model.bn1._variance != 1.0).any()),
           "resnet50: the running statistics were not updated")
    med = float(np.median(step_ms))
    flops_per_step = 3 * 8.2e9 * B     # bench.py:1622-1623's closed form
    peak = torch.cuda.max_memory_allocated() / 1e9
    breakdown = profile_step(torch, step, batch, resnet_family,
                             RESNET_FAMILIES, med)
    return {"phase": "resnet50", "config": "ResNet-50 (BottleneckBlock "
            "[3, 4, 6, 3], 1000 classes), batch 128 x 3 x 224 x 224, AMP O1 "
            "bf16, Momentum lr 0.1 mu 0.9, the same batch every step",
            "cudnn_benchmark": bool(torch.backends.cudnn.benchmark),
            "params": int(sum(p.numel() for p in params)),
            "param_tensors": len(params), "warmup_steps": WARM_STEPS,
            "timed_steps": TIMED_STEPS,
            "imgs_per_s": B * TIMED_STEPS / (sum(step_ms) / 1e3),
            "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
            "step_ms": step_ms, "flops_per_step": flops_per_step,
            "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "launches": launches,
            "launches_per_step": launches.get("fused_momentum", 0) / n_steps,
            "mem_at_start_gb": mem_start, "peak_mem_gb": peak,
            "breakdown": breakdown}, launches


# ---------------------------------------------------------------------------
# phases 9-11: BERT phase 2 (seq 512) with Lamb, LeNet with SGD
# ---------------------------------------------------------------------------
BERT512_BATCH, BERT512_SEQ = 32, 512
LAMB_KERNELS = ("flash_attention_short_fwd", "flash_attention_short_bwd",
                "fused_xent_fwd", "fused_xent_bwd", "fused_lamb_phase1",
                "fused_lamb_apply")


class short_seq_on:
    """``FLAGS_flash_short_seq`` on inside the block."""

    def __enter__(self):
        from paddle_tpu_torch import get_flags, set_flags

        self.prev = get_flags("flash_short_seq")
        set_flags({"flash_short_seq": True})

    def __exit__(self, *exc):
        from paddle_tpu_torch import set_flags

        set_flags(self.prev)
        return False


def lamb_plain_swaps(fa, fx, fo, optmod):
    def plain_lamb(params, grads, m1, m2, rs, *, lr, beta1, beta2, eps,
                   weight_decay, step, skip=False, cache=None, masters=None):
        lr32, c1, c2, _ = fo.adam_scalars(lr, beta1, beta2, step)
        plain_over(fo, params, grads, masters, skip, lambda w, g:
                   fo._plain_lamb_(w, g, m1, m2, rs, lr32, beta1, beta2,
                                   eps, weight_decay, c1, c2, skip))

    return [(fa, "flash_attention_short_fwd", fa._plain_fwd),
            (fa, "flash_attention_short_bwd", fa._plain_bwd),
            (fx, "fused_xent_fwd", fx._plain_fwd),
            (fx, "fused_xent_bwd", fx._plain_bwd),
            (optmod, "fused_lamb_", plain_lamb)]


def phase_bert_lamb_parity(torch, counters, fa, fx, fo):
    """Two Lamb TrainSteps of a tiny BERT (f32, dropout 0.1, the short
    flash kernels on, global-norm clipping) with the kernels and with the
    plain versions, from the same weights, on the card. The plain
    dropout mask is the kernels' mask, so dropout stays on."""
    import contextlib
    import copy

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Lamb
    from paddle_tpu_torch.optimizer import optimizer as optmod

    cfg = BertConfig.tiny()
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = BertForPretraining(cfg, generator=gen)
    batch = bert_batch(torch, np.random.RandomState(4), 8, 128,
                       cfg.vocab_size)
    batch[2][:, ::3] = -100                        # some ignored positions
    lr, n_steps = 1e-3, 2
    runs = {}
    with short_seq_on():
        for name in ("kernel", "plain"):
            model = copy.deepcopy(base)
            opt = Lamb(learning_rate=lr, lamb_weight_decay=0.01,
                       epsilon=1e-6, parameters=model.parameters(),
                       grad_clip=ClipGradByGlobalNorm(1.0))
            step = TrainStep(model, lambda m, *a: m.loss(*a), opt)
            counters.reset()
            ctx = swapped(lamb_plain_swaps(fa, fx, fo, optmod)) \
                if name == "plain" else contextlib.nullcontext()
            with ctx:
                losses = [float(step(*batch)) for _ in range(n_steps)]
            torch.cuda.synchronize()
            runs[name] = (losses, model, opt, counters.snapshot())
    (lk, mk, ok, ck), (lp, mp, op, cp) = runs["kernel"], runs["plain"]
    expect(all(ck.get(n, 0) > 0 for n in LAMB_KERNELS),
           f"bert_lamb_parity: a kernel did not launch: {ck}")
    expect(not ck.get("flash_attention_fwd", 0),
           f"bert_lamb_parity: the streaming flash kernel ran: {ck}")
    expect(not any(cp.get(n, 0) for n in LAMB_KERNELS),
           f"bert_lamb_parity: the plain run launched kernels: {cp}")
    expect(all(np.isfinite(lk)), f"bert_lamb_parity: non-finite loss {lk}")
    for a, b in zip(lk, lp):
        expect(abs(a - b) <= 1e-5 * abs(b),
               f"bert_lamb_parity: losses {lk} (kernels) against {lp} "
               f"(plain)")
    worst = {"grad": 0.0, "param": 0.0, "moment1": 0.0, "moment2": 0.0}
    pp = dict(mp.named_parameters())
    for n, p in mk.named_parameters():
        q = pp[n]
        # gradients and first moments: the bert_parity bound (1e-4 of the
        # largest value, 1e-7 where the true gradient is zero); second
        # moments square the gradient, so twice that relative bound
        for key, got, want, rel, floor in (
                ("grad", p.grad, q.grad, 1e-4, 1e-7),
                ("moment1", ok._slots[id(p)]["moment1"],
                 op._slots[id(q)]["moment1"], 1e-4, 1e-7),
                ("moment2", ok._slots[id(p)]["moment2"],
                 op._slots[id(q)]["moment2"], 2e-4, 1e-14)):
            err = max_err(got, want)
            scale = float(want.abs().max())
            expect(err <= rel * scale + floor,
                   f"bert_lamb_parity: {key} of {n} differs by {err} "
                   f"(max |value| {scale})")
            worst[key] = max(worst[key], err)
        # each Lamb step moves an element by lr * trust * r with
        # |r| ~ 1 and trust <= ~1 here: the bert_parity bound a step
        perr = max_err(p, q)
        expect(perr <= 2 * lr * n_steps,
               f"bert_lamb_parity: updated {n} differs by {perr}")
        worst["param"] = max(worst["param"], perr)
    return {"phase": "bert_lamb_parity", "config": "tiny (2 x 128, 2 "
            "heads, ffn 256, vocab 1024), batch 8 x 128, f32, dropout 0.1, "
            "flash_short_seq on, Lamb lr 1e-3 wd 0.01, ClipGradByGlobalNorm"
            "(1.0), two steps",
            "losses_kernel": lk, "losses_plain": lp, "max_abs_err": worst,
            "launches": ck}


def bert_short_family(name):
    if "short_fwd_" in name:
        return "flash_short_fwd"
    if "short_bwd_" in name:
        return "flash_short_bwd"
    if "lambphase1rule" in name or "lambapplyrule" in name \
            or "segment_sum" in name:
        return "lamb"
    if "norm" in name and "layer" not in name and "multi_tensor" in name:
        return "lamb_norms"
    fam = bert_family(name)
    return fam if fam in BERT512_FAMILIES else "other"


BERT512_FAMILIES = ("flash_short_fwd", "flash_short_bwd", "xent_fwd",
                    "xent_bwd", "lamb", "lamb_norms", "gemm", "other")


def bert512_family(name):
    if "flash_fwd_" in name:
        return "flash_masked_fwd"
    if any(t in name for t in ("flash_dq_", "flash_dkv_")):
        return "flash_masked_bwd"
    return bert_short_family(name)


BERT512_MASKED_FAMILIES = ("flash_masked_fwd", "flash_masked_bwd") \
    + BERT512_FAMILIES


def phase_bert512_lamb(torch, counters, fa=None, masked=False,
                       dtype="bfloat16", heads=12):
    """BERT-base phase-2 pretraining, ``bench_bert(seq=512)``'s batch 32,
    AMP O1 bf16, dropout 0.1, the short flash kernels on, Lamb with a
    linear warm-up into a polynomial decay and global-norm clipping. The
    first step's loss equals the plain versions' from the same weights,
    batch and dropout bits within rtol 1e-4 (a copy of the model trained
    one step with the short kernels' plain versions). Over 13 steps at
    lr 1e-3 this configuration's loss oscillates between 11.0 and 12.0
    and ends above or below its start by chance, the plain versions'
    run included, so the end points are reported, not compared.
    ``masked``: the same step on a padded batch (lengths from
    ``RandomState(0)`` uniform in 128-512, row 0 full; a (B, 1, 1, 512)
    bool key-padding mask; no MLM labels at padding), so attention runs
    the masked streaming kernels; then one eval forward at dropout 0
    with the kernels and again with the plain versions. ``dtype="float16"``
    (phase ``bert512_fp16``): the same at AMP O1 fp16, so attention runs
    K1c/K1d's f16 forms, 12 + 12 a step and no other K1; no loss scaler
    (``TrainStep`` takes none, as in the JAX package), so dO reaches
    them at scale 1; the first step's loss within an f16 unit roundoff
    (2^-11, relative) of the plain versions', whose copy runs that one
    step only. ``heads=4`` (phase ``bert512_d192``): BERT-base's width
    768 in 4 heads of 192, so K1c/K1d run at head width 192; the first
    loss within rtol 1e-4 of a plain-version copy's one step."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    gc.collect()                  # earlier phases' garbage off the card
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cfg = BertConfig(num_attention_heads=heads)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = BertForPretraining(cfg, generator=gen)
    params = list(model.parameters())
    opt, sched = phase2_optimizer(params)

    def loss_fn(m, ids, tt, mlm, nsp, mask=None):
        with amp.auto_cast(level="O1", dtype=dtype):
            return m.loss(ids, tt, mlm, nsp, mask)

    step = TrainStep(model, loss_fn, opt)
    B, S = BERT512_BATCH, BERT512_SEQ
    batch = bert_batch(torch, np.random.RandomState(0), B, S,
                       cfg.vocab_size)
    name_, family, families = "bert512_lamb", bert_short_family, \
        BERT512_FAMILIES
    if masked:
        lens = masked_lens(B, S)
        mask = key_padding_mask(torch, lens, S)
        batch[2][~mask[:, 0, 0, :]] = -100         # no loss at padding
        batch.append(mask)
        name_, family, families = "bert512_masked", bert512_family, \
            BERT512_MASKED_FAMILIES
    f16 = dtype == "float16"
    if f16:
        name_ = "bert512_fp16"
    if heads != 12:
        name_ = f"bert512_d{cfg.hidden_size // heads}"
    n_steps = WARM_STEPS + TIMED_STEPS
    lrs_used = [opt.get_lr()]
    plain = None if masked else plain_losses(
        torch, model, loss_fn, batch, 1 if f16 or heads != 12 else n_steps)
    torch.cuda.reset_peak_memory_stats()      # the copy's steps off the peak

    def next_lr():
        sched.step()
        lrs_used.append(opt.get_lr())

    with short_seq_on():
        losses, step_ms, launches = train_steps(torch, counters, step, batch,
                                                after=next_lr)
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = float(np.median(step_ms))
        breakdown = profile_step(torch, step, batch, family, families, med)
    L = cfg.num_hidden_layers
    want = {"flash_attention_short_fwd": L, "flash_attention_short_bwd": L,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "flash_attention_masked_fwd": 0, "flash_attention_masked_bwd": 0,
            "fused_xent_fwd": 1, "fused_xent_bwd": 1, "fused_lamb_phase1": 1,
            "fused_lamb_apply": 1, "fused_adam": 0, "attention_plain": 0}
    if masked:
        want.update({"flash_attention_short_fwd": 0,
                     "flash_attention_short_bwd": 0,
                     "flash_attention_masked_fwd": L,
                     "flash_attention_masked_bwd": L})
    if f16:
        want.update({"flash_attention_short_fwd": 0,
                     "flash_attention_short_bwd": 0,
                     "flash_attention_short_fwd_f16": L,
                     "flash_attention_short_bwd_f16": L,
                     "flash_attention_fwd_f16": 0,
                     "flash_attention_bwd_f16": 0,
                     "flash_attention_masked_fwd_f16": 0,
                     "flash_attention_masked_bwd_f16": 0})
    per_step = {k: launches.get(k, 0) / n_steps for k in want}
    expect(all(np.isfinite(losses)), f"{name_}: non-finite loss {losses}")
    if not masked:
        rtol = FLASH_UNIT_ROUNDOFF["float16"] if f16 else 1e-4
        expect(all(np.isfinite(plain)), f"{name_}: non-finite plain loss")
        expect(abs(losses[0] - plain[0]) <= rtol * abs(plain[0]),
               f"{name_}: the first loss {losses[0]} is not the plain "
               f"versions' {plain[0]}")
    for k, n in want.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"{name_}: {k} launched {launches.get(k, 0)} times over "
               f"{n_steps} steps, want {n} a step")
    expect(all(p.grad is not None for p in params),
           f"{name_}: a parameter got no gradient, so Lamb skipped it")
    expect(len(opt._kernel_cache[(torch.float32, False)]["phase1"]["key"])
           == 6 * len(params),
           f"{name_}: the Lamb launch did not cover every parameter")
    flops_per_step = bert_flops_per_step(cfg, B, S)
    row = {"phase": name_, "config": "BERT-base (vocab 30592, 12 "
           f"x 768, {heads} x {cfg.hidden_size // heads} heads, ffn 3072), "
           "batch 32 x seq 512, AMP O1 "
           + ("fp16 (no loss scaler)" if f16 else "bf16") + ", dropout "
           "0.1, flash_short_seq on, Lamb wd 0.01 eps 1e-6, "
           "LinearWarmup(3 steps, 0 -> 1e-3) into PolynomialDecay(1e-3, "
           "1000 steps, end 0), ClipGradByGlobalNorm(1.0)"
           + (", key-padding mask (lengths 128-512)" if masked else ""),
           "params": int(sum(p.numel() for p in params)),
           "param_tensors": len(params), "warmup_steps": WARM_STEPS,
           "timed_steps": TIMED_STEPS,
           "tokens_per_s": B * S * TIMED_STEPS / (sum(step_ms) / 1e3),
           "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
           "step_ms": step_ms, "flops_per_step": flops_per_step,
           "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses_plain": plain, "first_loss_rel_diff": None if masked
           else abs(losses[0] - plain[0]) / abs(plain[0]),
           "losses": losses, "lr": lrs_used[:n_steps], "launches": launches,
           "launches_per_step": per_step, "mem_at_start_gb": mem_start,
           "peak_mem_gb": peak, "breakdown": breakdown}
    if masked:
        valid = int(lens.sum())
        row.update({
            "lengths": lens.tolist(), "valid_tokens_per_step": valid,
            "valid_tokens_per_s": valid * TIMED_STEPS / (sum(step_ms) / 1e3),
            "mfu_upper": row.pop("mfu"),
            "mfu_note": "bench.py's closed form at full length 512: an "
                        "upper figure, the padded keys' attention work "
                        "included",
            "eval_vs_plain": bert512_eval_check(torch, fa, model, batch)})
    return row, launches


def phase2_optimizer(params):
    """Phase 2's optimizer: Lamb on a linear warm-up into a polynomial
    decay, global-norm clipping. (optimizer, schedule)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Lamb
    from paddle_tpu_torch.optimizer import lr as lrs

    sched = lrs.LinearWarmup(
        lrs.PolynomialDecay(1e-3, decay_steps=1000, end_lr=0.0),
        warmup_steps=3, start_lr=0.0, end_lr=1e-3)
    return Lamb(learning_rate=sched, lamb_weight_decay=0.01, epsilon=1e-6,
                parameters=params, grad_clip=ClipGradByGlobalNorm(1.0)), \
        sched


def plain_losses(torch, model, loss_fn, batch, n_steps):
    """``n_steps`` TrainStep losses of a copy of ``model`` with the short
    flash kernels' plain versions: the same weights, batch, recipe and
    dropout bits (TrainStep's seed) as the kernel run."""
    import copy

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    twin = copy.deepcopy(model)
    opt, sched = phase2_optimizer(list(twin.parameters()))
    step = TrainStep(twin, loss_fn, opt)
    swaps = [(fa, "flash_attention_short_fwd", fa._plain_fwd),
             (fa, "flash_attention_short_bwd", fa._plain_bwd)]
    losses = []
    with short_seq_on(), swapped(swaps):
        for _ in range(n_steps):
            losses.append(float(step(*batch)))
            sched.step()
    del twin, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def masked_lens(B, L, seed=0):
    """Phase-2 lengths: ``RandomState(seed)`` uniform in [L/4, L], row 0
    full, so partial and fully masked kv tiles both occur."""
    lens = np.random.RandomState(seed).randint(L // 4, L + 1, B)
    lens[0] = L
    return lens


def bert512_eval_check(torch, fa, model, batch):
    """One eval forward (dropout 0: the route the JAX package sends to its
    masked Pallas kernel) of the padded batch with the masked kernels and
    again with their plain version; sequence and pooled outputs at the
    valid positions within atol 2e-2 + rtol 1e-2 (bf16)."""
    from paddle_tpu_torch import amp

    ids, tt, _, _, mask = batch
    model.eval()
    outs = {}
    try:
        for name in ("kernel", "plain"):
            swaps = [(fa, "flash_attention_fwd", fa._plain_fwd)] \
                if name == "plain" else []
            with torch.no_grad(), swapped(swaps), \
                    amp.auto_cast(level="O1", dtype="bfloat16"):
                seq, pooled = model.bert(ids, tt, mask)
            torch.cuda.synchronize()
            outs[name] = (seq.float(), pooled.float())
    finally:
        model.train()
    valid = mask[:, 0, 0, :]
    (sk, pk), (sp, pp) = outs["kernel"], outs["plain"]
    errs = {"seq": max_err(sk[valid], sp[valid]), "pooled": max_err(pk, pp)}
    for name, a, b in (("seq", sk[valid], sp[valid]), ("pooled", pk, pp)):
        expect(bool(torch.isfinite(a).all()),
               f"bert512_masked eval: non-finite {name}")
        expect(torch.allclose(a, b, atol=2e-2, rtol=1e-2),
               f"bert512_masked eval: {name} differs from the plain "
               f"version by {errs[name]}")
    return errs


def lenet_sgd_step(torch, weight_decay):
    """LeNet at ``bench_mnist``'s batch 128 x 1 x 28 x 28, f32, SGD lr
    0.01 with coupled L2 ``weight_decay``, the same batch every step:
    (the TrainStep, the batch, the parameters)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.vision.models import LeNet

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LeNet(num_classes=10, generator=gen)
    params = list(model.parameters())
    opt = SGD(learning_rate=SGD_LR, weight_decay=weight_decay,
              parameters=params)
    ce = nn.CrossEntropyLoss()
    step = TrainStep(model, lambda m, x, y: ce(m(x), y), opt)
    B = 128
    rng = np.random.RandomState(0)
    batch = (torch.tensor(rng.randn(B, 1, 28, 28).astype(np.float32),
                          device="cuda"),
             torch.tensor(rng.randint(0, 10, (B,)).astype(np.int64),
                          device="cuda"))
    return step, batch, params


LEAD_SPINS = 10   # spin kernels ahead of a profiled step


def step_device_events(torch, step, batch):
    """One profiled step's device work: its kernels, memory copies and
    fills (torch.profiler's CUDA events), and each kernel name's count.
    The tracer starts recording some time after the window opens, so
    ``LEAD_SPINS`` spin kernels, each finished before the next is
    launched, lead the window (~2 ms each); ``lead_spins`` is how many
    of them the trace holds: one proves it was recording before the
    step began. They are counted nowhere else."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            torch.cuda.synchronize()
        step(*batch)
        torch.cuda.synchronize()
    out = {"kernels": 0, "copies": 0, "fills": 0, "lead_spins": 0}
    names = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA" \
                or getattr(e, "is_user_annotation", False):
            continue
        if "spin_kernel" in e.name:
            out["lead_spins"] += 1
            continue
        kind = "copies" if e.name.startswith("Memcpy") else \
            "fills" if e.name.startswith("Memset") else "kernels"
        out[kind] += 1
        if kind == "kernels":
            names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    out["kernel_names"] = names
    return out


def lenet_profiled_pairs():
    """In a process of its own (``spawn``): a LeNet step with the decay
    and one without, ``WARM_STEPS`` each, then the two profiled in turn
    until a pair's windows both hold a lead spin and the same kernels
    with the SGD kernel among them, 5 pairs at most: (the last pair's
    two windows, the pairs profiled, what each pair profiled again
    recorded). Late in a full run, the main process's torch.profiler
    sessions dropped a window's first kernels (LeNet's forward) and
    held none of some windows' lead spins; a process where no session
    ran before records whole windows."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step, batch, _ = lenet_sgd_step(torch, SGD_WD)
    step0, batch0, _ = lenet_sgd_step(torch, 0.0)
    for _ in range(WARM_STEPS):
        step(*batch)
        step0(*batch0)
    retried = []
    for pairs in range(1, 6):
        events = step_device_events(torch, step, batch)
        events0 = step_device_events(torch, step0, batch0)
        names, names0 = events["kernel_names"], events0["kernel_names"]
        if names == names0 and events["lead_spins"] > 0 \
                and events0["lead_spins"] > 0 \
                and any("multi_tensor_arg_kernel" in k for k in names):
            break
        retried.append({
            "kernels": [events["kernels"], events0["kernels"]],
            "lead_spins": [events["lead_spins"], events0["lead_spins"]],
            "differ_by": {k[:60]: names.get(k, 0) - names0.get(k, 0)
                          for k in set(names) | set(names0)
                          if names.get(k, 0) != names0.get(k, 0)}})
    return events, events0, pairs, retried


def phase_lenet_sgd(torch, counters):
    """LeNet at ``bench_mnist``'s batch with SGD lr 0.01 and coupled L2
    1e-4 (the kernel's decay): the loss falls, one SGD launch a step
    over every parameter; a profiled step runs, name for name, the
    kernels of a step of the same net without the decay."""
    from paddle_tpu_torch.distributed import spawn

    step, batch, params = lenet_sgd_step(torch, SGD_WD)
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    expect(all(np.isfinite(losses)), f"lenet_sgd: non-finite loss {losses}")
    expect(losses[-1] < losses[0],
           f"lenet_sgd: loss did not fall ({losses[0]} -> {losses[-1]})")
    expect(launches.get("fused_sgd", 0) == n_steps,
           f"lenet_sgd: fused_sgd launched {launches.get('fused_sgd', 0)} "
           f"times over {n_steps} steps, want one a step")
    n_params = int(sum(p.numel() for p in params))
    rec = step.optimizer._last_launch
    expect(rec == {"tensors": len(params), "elements": n_params,
                   "launches": 1},
           f"lenet_sgd: the SGD launch covered {rec}, not the "
           f"{len(params)} parameters ({n_params} elements)")
    # the decay is in the SGD kernel: a decayed step runs the kernels of
    # an undecayed one, no g + wd*p launches beside them
    events, events0, pairs, retried = spawn(lenet_profiled_pairs,
                                            timeout=300)[0]
    names, names0 = events["kernel_names"], events0["kernel_names"]
    expect(events["lead_spins"] > 0 and events0["lead_spins"] > 0,
           f"lenet_sgd: a profiled window holds none of its lead spin "
           f"kernels (pairs profiled again: {retried})")
    expect(any("multi_tensor_arg_kernel" in k for k in names),
           f"lenet_sgd: no SGD kernel in a profiled step: {names}")
    extra = {k: names.get(k, 0) - names0.get(k, 0)
             for k in set(names) | set(names0)
             if names.get(k, 0) != names0.get(k, 0)}
    expect(not extra, f"lenet_sgd: the decayed step's kernels differ from "
                      f"the undecayed step's by {extra}")
    return {"phase": "lenet_sgd", "config": "LeNet, batch 128 x 1 x 28 x "
            "28, f32, SGD lr 0.01, coupled L2 1e-4, the same batch every "
            "step", "params": n_params,
            "param_tensors": len(params), "warmup_steps": WARM_STEPS,
            "timed_steps": TIMED_STEPS,
            "steps_per_s": TIMED_STEPS / (sum(step_ms) / 1e3),
            "step_ms_median": float(np.median(step_ms)),
            "step_ms_max": float(np.max(step_ms)),
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "launches": launches,
            "launches_per_step": launches.get("fused_sgd", 0) / n_steps,
            "last_sgd_launch": rec, "profiled_step": events,
            "profiled_step_without_l2": events0,
            "profiled_pairs": pairs, "pairs_retried": retried}, launches


# ---------------------------------------------------------------------------
# phase 1, K3's static forms; phases 12-16: the static graph
# ---------------------------------------------------------------------------
STATIC_FORMS = ("sgd", "momentum", "adam", "lamb")
# bytes an element each form must move (p, g and the state read once,
# p and the state written once) and its f32 operations an element
STATIC_BYTES = {"sgd": 12, "momentum": 20, "adam": 28, "lamb": 28}
STATIC_FLOPS = {"sgd": 2, "momentum": 3, "adam": 12, "lamb": 16}
# the static forms' timed calls dispatch a run of 25 or 206 tensors (a
# launch or a few, Lamb with a norm between two): a ~50 ms spin ahead of
# the start event hides that host work, so their times are device time
STATIC_SPIN_CYCLES = 100_000_000
STATIC_COUNTERS = {"sgd": ("static_sgd",), "momentum": ("static_momentum",),
                   "adam": ("static_adam",),
                   "lamb": ("static_lamb_phase1", "static_lamb_apply")}
# table roles of each static launch (its pointer table's rows)
STATIC_ROLES = {"static_sgd": 4, "static_momentum": 5, "static_adam": 10,
                "static_lamb_phase1": 10, "static_lamb_apply": 6}


def static_launches(fo, counter, n_tensors):
    """Launches of ``counter``'s kernel for one run of ``n_tensors``
    update ops: one, or one per split where the run outgrows the table
    a launch carries by value."""
    cap = fo.static_capacity(STATIC_ROLES[counter])
    return -(-n_tensors // cap)


def static_state(torch, form, shapes, found, gen):
    """One parameter's inputs a shape, on the card: non-zero state, the
    (1,) lr and beta-pows, the FoundInfinite flag (None: absent)."""
    out = []
    for s in shapes:
        t = {"p": torch.randn(s, generator=gen, device="cuda") * 0.05,
             "g": torch.randn(s, generator=gen, device="cuda") * 1e-2,
             "lr": torch.tensor([0.05], device="cuda")}
        if form == "momentum":
            t["v"] = torch.randn(s, generator=gen, device="cuda") * 1e-2
        if form in ("adam", "lamb"):
            t["m"] = torch.randn(s, generator=gen, device="cuda") * 1e-3
            t["v"] = (torch.randn(s, generator=gen, device="cuda")
                      * 1e-4).abs()
            t["b1p"] = torch.tensor([0.9 ** 3], device="cuda")
            t["b2p"] = torch.tensor([0.999 ** 3], device="cuda")
        t["found"] = None if found is None else torch.tensor(
            [found], device="cuda")
        out.append(t)
    return out


def static_update(fo, form, ts, plain):
    """The static form over a run of parameters' inputs ``ts`` (in
    place), as the executor hands a run of update ops to it: the list
    form, or the loop of per-op plain versions; each op's beta-pow
    outputs (Adam, Lamb) or ()."""
    def col(k):
        return [t[k] for t in ts]

    p, g, lr, found = col("p"), col("g"), col("lr"), col("found")
    if form == "sgd":
        (fo._plain_static_sgd_list_ if plain else fo.static_sgd_list_)(
            p, g, lr, found)
        return [()] * len(ts)
    if form == "momentum":
        if plain:
            fo._plain_static_momentum_list_(p, g, col("v"), lr, 0.9, False,
                                            found)
        else:
            fo.static_momentum_list_(p, g, col("v"), lr, mu=0.9,
                                     founds=found)
        return [()] * len(ts)
    args = (p, g, col("m"), col("v"), col("b1p"), col("b2p"), lr)
    if form == "adam":
        if plain:
            return fo._plain_static_adam_list_(*args, 0.9, 0.999, 1e-8,
                                               found)
        return fo.static_adam_list_(*args, beta1=0.9, beta2=0.999, eps=1e-8,
                                    founds=found)
    if plain:
        return fo._plain_static_lamb_list_(*args, 0.9, 0.999, 1e-6, 0.01,
                                           found)
    return fo.static_lamb_list_(*args, beta1=0.9, beta2=0.999, eps=1e-6,
                                weight_decay=0.01, founds=found)


def static_library(torch, form, state):
    """The one PyTorch call computing the same update over the list
    (timed only): SGD/Adam with ``fused=True``; Lamb has none."""
    if form == "lamb":
        return None
    params = [torch.nn.Parameter(t["p"].clone()) for t in state]
    for p, t in zip(params, state):
        p.grad = t["g"].clone()
    if form == "adam":
        return torch.optim.Adam(params, lr=0.05, fused=True).step
    mu = 0.9 if form == "momentum" else 0.0
    return torch.optim.SGD(params, lr=0.05, momentum=mu, fused=True).step


def host_dispatch_ms(torch, fn, iters: int = 20) -> float:
    """Median host time to issue ``fn``'s launches (no synchronise
    inside the timed span; one before each)."""
    times = []
    for _ in range(iters + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times[3:]))


def check_static_optim(torch, fo, counters, shape_lists, timing):
    """K3's static forms against their plain versions, bit for bit, over
    a run of the static example's 25 trainable tensors and one of
    BERT-base's 206, with FoundInfinite absent, false and true: p, the
    moments or velocity and the beta-pow outputs; the flag keeps all of
    them; the pows advance without it. A run is one launch, or one per
    split where it outgrows the table a launch carries by value
    (``static_capacity``, set by the build's kernel parameter space).
    Timed over each list (the example's is the main path's: one step's
    updates), device time behind a long spin, and the host time to
    dispatch the list."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = {}
    for form in STATIC_FORMS:
        row = {"max_abs_err": 0.0, "bitwise": True, "launches_checked": 0}
        for label, shapes in shape_lists.items():
            for found in (None, False, True):
                kern = static_state(torch, form, shapes, found, gen)
                plain = [{k: None if x is None else x.clone()
                          for k, x in t.items()} for t in kern]
                before = [{k: None if x is None else x.clone()
                           for k, x in t.items()} for t in kern]
                c0 = sum(counters.get(c) for c in STATIC_COUNTERS[form])
                kp = static_update(fo, form, kern, False)
                pp = static_update(fo, form, plain, True)
                torch.cuda.synchronize()
                n_launch = sum(counters.get(c)
                               for c in STATIC_COUNTERS[form]) - c0
                want = sum(static_launches(fo, c, len(shapes))
                           for c in STATIC_COUNTERS[form])
                expect(n_launch == want,
                       f"static {form}: {n_launch} launches for a run of "
                       f"{len(shapes)} tensors, want {want}")
                row["launches_checked"] += n_launch
                for t, u, b, ko, po in zip(kern, plain, before, kp, pp):
                    for k, x in t.items():
                        if x is None or k in ("g", "lr", "found"):
                            continue
                        expect(torch.equal(x, u[k]),
                               f"static {form} ({label}, found={found}): "
                               f"{k} differs from the plain version by "
                               f"{max_err(x, u[k])}")
                        if found:
                            expect(torch.equal(x, b[k]),
                                   f"static {form}: the set flag changed "
                                   f"{k}")
                    for a, c, old, beta in zip(ko, po, (b.get("b1p"),
                                                        b.get("b2p")),
                                               (0.9, 0.999)):
                        expect(a.shape == (1,) and torch.equal(a, c),
                               f"static {form}: beta-pow output differs")
                        want = old if found else old * beta
                        expect(torch.equal(a, want),
                               f"static {form} (found={found}): beta-pow "
                               f"{float(a)} against {float(want)}")
            n = sum(int(np.prod(s)) for s in shapes)
            sub = {"params": len(shapes), "elements": n,
                   "launches_per_run": {c: static_launches(fo, c, len(shapes))
                                        for c in STATIC_COUNTERS[form]}}
            if timing:
                state = static_state(torch, form, shapes, None, gen)
                pstate = [dict(t) for t in state]
                t_b, by = bound_of(STATIC_BYTES[form] * n,
                                   STATIC_FLOPS[form] * n, F32_FLOPS_PER_S)
                lib = static_library(torch, form, state)
                spin = STATIC_SPIN_CYCLES
                sub.update({
                    "ms": time_ms(torch, lambda: static_update(
                        fo, form, state, False), spin=spin),
                    "plain_ms": time_ms(torch, lambda: static_update(
                        fo, form, pstate, True), iters=5, spin=spin),
                    "library_ms": None if lib is None else time_ms(
                        torch, lib, spin=spin),
                    "host_dispatch_ms": host_dispatch_ms(
                        torch, lambda: static_update(fo, form, state,
                                                     False)),
                    "bound_ms": t_b, "bound_by": by})
            row[label] = sub
        if timing:
            row.update({k: row["static_resnet"][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "host_dispatch_ms")})
            row["bound_rates"] = rates(F32_FLOPS_PER_S, "f32")
        rows[form] = row
    rows["param_bytes"] = fo.static_param_bytes()
    rows["capacity"] = {c: fo.static_capacity(r)
                        for c, r in STATIC_ROLES.items()}
    return rows


STATIC_STEPS = 24   # the example's loop: 3 epochs of 8 batches of 64


def static_param_shapes():
    """The shapes of the static example's 25 trainable tensors."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main = static_network(static, static.SGD(0.1))[0]
    return [tuple(v.shape) for v in main.global_block.vars.values()
            if getattr(v, "trainable", False)]


def static_network(static, opt):
    """``examples/train_resnet_static.py``'s program, as written there,
    with the optimizer ``opt`` (a static optimizer instance):
    (main, startup, loss, acc, logits)."""
    def conv_bn(x, ch, stride=1, act="relu"):
        h = static.nn.conv2d(x, ch, 3, stride=stride, padding=1,
                             bias_attr=False)
        return static.nn.batch_norm(h, act=act)

    def basic_block(x, ch, stride=1):
        h = conv_bn(x, ch, stride)
        h = conv_bn(h, ch, act=None)
        short = x if stride == 1 and x.shape[1] == ch else \
            static.nn.conv2d(x, ch, 1, stride=stride, bias_attr=False)
        return static.relu(static.elementwise_add(h, short))

    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        img = static.data("img", [-1, 3, 32, 32])
        label = static.data("label", [-1, 1], dtype="int64")
        h = conv_bn(img, 16)
        h = basic_block(h, 16)
        h = basic_block(h, 32, stride=2)
        h = basic_block(h, 64, stride=2)
        h = static.nn.pool2d(h, 8, pool_type="avg")
        logits = static.nn.fc(h, 10)
        loss = static.mean(static.softmax_with_cross_entropy(logits, label))
        acc = static.accuracy(static.softmax(logits), label)
        opt.minimize(loss)
    return main, startup, loss, acc, logits


STATIC_OPT_DESC = {"momentum": "Momentum lr 0.05 mu 0.9",
                   "adam": "Adam lr 2e-3", "lamb": "Lamb lr 1e-3",
                   "sgd": "SGD lr 0.05 with L2Decay 1e-4"}


def static_optimizer(static, form):
    """The optimizer of each static phase: the example's Momentum,
    ``test_book.py``'s Adam, Lamb, and SGD with L2 decay."""
    from paddle_tpu_torch.regularizer import L2Decay

    return {"momentum": lambda: static.Momentum(learning_rate=0.05,
                                                momentum=0.9),
            "adam": lambda: static.Adam(2e-3),
            "lamb": lambda: static.Lamb(1e-3),
            "sgd": lambda: static.SGD(0.05, regularization=L2Decay(1e-4))
            }[form]()


def cifar_synthetic(n=512):
    """``paddle_tpu.vision.datasets.Cifar10(mode="train",
    synthetic_size=1024)``'s first ``n`` samples, made the same way (a
    class pattern from RandomState(7) plus noise from RandomState(0)),
    as the example loads them: (images (n, 3, 32, 32) f32 in [0, 1],
    labels (n, 1) int64)."""
    base = np.random.RandomState(7).rand(10, 3072).astype(np.float32)
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 10, 1024).astype(np.int64)
    noise = rng.rand(1024, 3072).astype(np.float32) * 0.4
    data = (base[labels % 10] * 255 * 0.6 + noise * 255).astype(np.uint8)
    imgs = data[:n].reshape(n, 3, 32, 32).astype(np.float32) / 255.0
    return imgs, labels[:n].reshape(-1, 1)


def example_batches(imgs, labels, steps):
    """The example's loop: 3 epochs, a RandomState(epoch) permutation
    each, batches of 64 at ``range(0, len - 63, 64)``; the first
    ``steps``."""
    out = []
    for epoch in range(3):
        perm = np.random.RandomState(epoch).permutation(len(imgs))
        for i in range(0, len(imgs) - 63, 64):
            sl = perm[i:i + 64]
            out.append((imgs[sl], labels[sl]))
    return out[:steps]


def static_family(name):
    """The static update kernels, Lamb's norms, else ResNet's families."""
    if "static" in name and "rule" in name:
        return "static_update"
    if "norm" in name and "batch" not in name and "foreach" in name:
        return "lamb_norms"
    return resnet_family(name)


STATIC_FAMILIES = RESNET_FAMILIES + ("static_update", "lamb_norms")


def host_profile(torch, step, batch):
    """Host time of one static step by part, under cProfile (which
    inflates Python-heavy parts): cumulative ms of the executor's run,
    the backward op (autograd), the update ops, the feeds, the batch
    norms and convolutions of the forward."""
    import cProfile
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    step(*batch)
    torch.cuda.synchronize()
    prof.disable()
    parts = {"run": ("executor.py", "run"),
             "backward_op": ("backward.py", "run_backward_op"),
             "updates": ("kernels.py", "_momentum"),
             "feeds": ("executor.py", "_feed_tensor"),
             "batch_norm_fwd": ("kernels.py", "_batch_norm"),
             "conv2d_fwd": ("kernels.py", "_conv2d")}
    out = dict.fromkeys(parts, 0.0)
    for (path, _, func), (_, _, _, cum, _) in \
            pstats.Stats(prof).stats.items():
        for part, (base, name) in parts.items():
            if func == name and os.path.basename(path) == base:
                out[part] += cum * 1e3
    return out


def phase_static_parity(torch, counters, fo):
    """The example's network at batch 8, two steps with each static
    optimizer, with the kernels and again with their plain versions
    swapped in, from the same weights, cuDNN deterministic: losses and
    every persistable bit for bit."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.utils import unique_name

    def nones(founds, n):
        return [None] * n if founds is None else founds

    swaps = [
        (fo, "static_sgd_list_", lambda p, g, lr, founds=None:
         fo._plain_static_sgd_list_(p, g, lr, nones(founds, len(p)))),
        (fo, "static_momentum_list_",
         lambda p, g, v, lr, *, mu, nesterov=False, founds=None:
         fo._plain_static_momentum_list_(p, g, v, lr, mu, nesterov,
                                         nones(founds, len(p)))),
        (fo, "static_adam_list_",
         lambda p, g, m, v, b1, b2, lr, *, beta1, beta2, eps, founds=None:
         fo._plain_static_adam_list_(p, g, m, v, b1, b2, lr, beta1, beta2,
                                     eps, nones(founds, len(p)))),
        (fo, "static_lamb_list_",
         lambda p, g, m, v, b1, b2, lr, *, beta1, beta2, eps, weight_decay,
         founds=None: fo._plain_static_lamb_list_(
             p, g, m, v, b1, b2, lr, beta1, beta2, eps, weight_decay,
             nones(founds, len(p))))]
    imgs, labels = cifar_synthetic()
    x, y = imgs[:8], labels[:8]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for form in STATIC_FORMS:
            with unique_name.guard():
                main, startup, loss, acc, _ = static_network(
                    static, static_optimizer(static, form))
            startup.random_seed = 11
            exe = static.Executor()
            init = static.Scope()
            with static.scope_guard(init):
                exe.run(startup)
            runs = {}
            for name in ("kernel", "plain"):
                scope = static.Scope()
                for k, v in init.items():
                    scope.set(k, v.clone())
                counters.reset()
                with static.scope_guard(scope):
                    if name == "plain":
                        with swapped(swaps):
                            ls = [exe.run(main, feed={"img": x, "label": y},
                                          fetch_list=[loss])[0]
                                  for _ in range(2)]
                    else:
                        ls = [exe.run(main, feed={"img": x, "label": y},
                                      fetch_list=[loss])[0]
                              for _ in range(2)]
                torch.cuda.synchronize()
                runs[name] = ([float(v) for v in ls], dict(scope.items()),
                              counters.snapshot())
            (lk, sk, ck), (lp, sp, cp) = runs["kernel"], runs["plain"]
            # the 25 update ops are one run: one launch a step (or one
            # per split of the run)
            want = {c: 2 * static_launches(fo, c, 25)
                    for c in STATIC_COUNTERS[form]}
            expect({c: ck.get(c, 0) for c in want} == want,
                   f"static_parity {form}: kernel launches {ck}, want {want}")
            expect(not any(k.startswith("static_") for k in cp),
                   f"static_parity {form}: the plain run launched {cp}")
            expect(lk == lp, f"static_parity {form}: losses {lk} (kernel) "
                             f"against {lp} (plain)")
            expect(all(np.isfinite(lk)), f"static_parity {form}: {lk}")
            differ = sorted(k for k in sk if not torch.equal(sk[k], sp[k]))
            expect(set(sk) == set(sp) and not differ,
                   f"static_parity {form}: persistables differ: {differ[:5]}")
            moved = sum(int(not torch.equal(sk[k], init.find_var(k)))
                        for k in sk)
            expect(moved > 25, f"static_parity {form}: only {moved} "
                               "persistables changed in two steps")
            out[form] = {"losses": lk, "persistables": len(sk),
                         "changed": moved, "launches": ck}
    finally:
        torch.backends.cudnn.deterministic = prev
    return {"phase": "static_parity", "config": "examples/train_resnet_"
            "static.py's network, batch 8 x 3 x 32 x 32, two steps each with "
            "Momentum(0.05, 0.9), Adam(2e-3), Lamb(1e-3), SGD(0.05) + "
            "L2Decay(1e-4), cudnn.deterministic", "bitwise": True,
            "forms": out}


def phase_static_resnet(torch, counters, form, steps, inference=False,
                        save_to=None):
    """``examples/train_resnet_static.py`` through the port's static
    graph on the card: its program, batch 64, the example's batches of
    the synthetic CIFAR sample; with ``inference`` the saved and loaded
    inference model's logits against the test-mode clone's (the model
    saved into ``save_to`` when given, else a temporary directory)."""
    import contextlib
    import tempfile

    from paddle_tpu_torch import static
    from paddle_tpu_torch.utils import unique_name

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with unique_name.guard():
        main, startup, loss, acc, logits = static_network(
            static, static_optimizer(static, form))
    startup.random_seed = 1
    imgs, labels = cifar_synthetic()
    batches = example_batches(imgs, labels, steps)
    exe = static.Executor()
    scope = static.Scope()
    with static.scope_guard(scope):
        exe.run(startup)
        counters.reset()
        losses, accs, step_ms = [], [], []
        for x, y in batches:
            t0 = time.perf_counter()
            lo, ac = exe.run(main, feed={"img": x, "label": y},
                             fetch_list=[loss, acc])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lo))
            accs.append(float(ac))
        launches = counters.snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        med = float(np.median(step_ms))
        breakdown = profile_step(
            torch, lambda a, b: exe.run(main, feed={"img": a, "label": b},
                                        fetch_list=[loss, acc]),
            batches[0], static_family, STATIC_FAMILIES, med)
        host = host_profile(torch, lambda a, b: exe.run(
            main, feed={"img": a, "label": b}, fetch_list=[loss, acc]),
            batches[0]) if form == "momentum" else None
        infer = None
        if inference:
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                x = batches[0][0]
                want = exe.run(main.clone(for_test=True),
                               feed={"img": x, "label": batches[0][1]},
                               fetch_list=[logits])[0]
                with (contextlib.nullcontext(save_to) if save_to
                      else tempfile.TemporaryDirectory()) as d:
                    static.save_inference_model(d, ["img"], [logits], exe,
                                                main)
                    with static.scope_guard(static.Scope()):
                        prog, feeds, fetches = static.load_inference_model(
                            d, exe)
                        got = exe.run(prog, feed={"img": x},
                                      fetch_list=fetches)[0]
            finally:
                torch.backends.cudnn.deterministic = prev
            expect(feeds == ["img"] and got.shape == (64, 10),
                   f"static_resnet: loaded model feeds {feeds}, logits "
                   f"{got.shape}")
            expect(np.array_equal(got, want),
                   "static_resnet: the loaded inference model's logits "
                   f"differ from the test-mode clone's by "
                   f"{float(np.abs(got - want).max())}")
            infer = {"ops": len(prog.global_block.ops), "logits_equal": True,
                     "logits_shape": list(got.shape)}
    n = len(batches)
    per_step = {c: launches.get(c, 0) / n for c in launches}
    expect(all(np.isfinite(losses)), f"static {form}: non-finite {losses}")
    expect(losses[-1] < losses[0],
           f"static {form}: loss did not fall ({losses[0]} -> {losses[-1]})")
    # the 25 update ops of a step are one run: one launch a step (or one
    # per split of the run), not one an op
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    want = {c: static_launches(fo, c, 25) * n for c in STATIC_COUNTERS[form]}
    expect({c: launches.get(c, 0) for c in want} == want,
           f"static {form}: launches {launches}, want {want}")
    others = {k: v for k, v in launches.items() if k not in want}
    expect(not others, f"static {form}: other kernels launched: {others}")
    params = [v for v in main.global_block.vars.values()
              if getattr(v, "trainable", False)]
    name = "static_resnet" if form == "momentum" else f"static_resnet_{form}"
    return {"phase": name, "config": "examples/train_resnet_static.py's "
            "network (3 basic blocks 16/32/64, batch norm, avg pool, fc 10), "
            f"batch 64 x 3 x 32 x 32 f32, {STATIC_OPT_DESC[form]}, the "
            "example's batches of the synthetic CIFAR-10 sample",
            "param_tensors": len(params),
            "params": int(sum(int(np.prod(v.shape)) for v in params)),
            "steps": n, "steps_per_s": n / (sum(step_ms) / 1e3),
            "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
            "step_ms": step_ms, "loss_first": losses[0],
            "loss_last": losses[-1], "losses": losses, "accs": accs,
            "launches": launches, "launches_per_step": per_step,
            "peak_mem_gb": peak, "breakdown": breakdown,
            "host_profile_ms": host, "inference": infer}, launches


SERVE_BUCKETS = (1, 2, 4, 8, 16)
SERVE_REQUESTS = 64
SERVE_THREADS = 4


def serve_requests(imgs, n, seed):
    """``n`` requests of 1-4 rows each, slices of the synthetic CIFAR
    sample."""
    sizes = np.random.RandomState(seed).randint(1, 5, size=n)
    starts = np.cumsum([0] + sizes.tolist())
    return [{"img": imgs[(a % 448):(a % 448) + k]}
            for a, k in zip(starts, sizes)]


def submit_from_threads(eng, feeds, n_threads):
    """Submit ``feeds`` round-robin from ``n_threads`` threads at once;
    the handles in feed order."""
    import threading

    handles = [None] * len(feeds)

    def run(t):
        for i in range(t, len(feeds), n_threads):
            handles[i] = eng.submit(feeds[i])

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return handles


def phase_serving(torch, blob):
    """The port's AnalysisPredictor over the static ResNet inference
    model phase 13 saved (buckets 1-16, warmed) behind a ServingEngine
    on its scheduler thread: 64 requests of 1-4 rows from 4 threads,
    each response equal to that request run alone through
    ``run_batch`` within atol 1e-4 (cuDNN may choose another algorithm
    at another bucket); packing (fewer batches than requests) and no
    degraded request; then ``serve.dispatch`` armed twice: the retry
    and the row-by-row leg on the card serve every request within atol
    1e-4; ServingHealthServer's /readyz 200, then 503 after drain.
    Requests/s, e2e p50/p99 ms (the engine's buckets) and batch fill."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.fault import injector as fault
    from paddle_tpu_torch.inference import (AnalysisPredictor,
                                            ServingEngine,
                                            ServingHealthServer)

    t0 = time.perf_counter()
    pred = AnalysisPredictor(blob, batch_buckets=SERVE_BUCKETS)
    expect(pred.device.type == "cuda", "the predictor is not on the card")
    pred.warm()
    warm_s = time.perf_counter() - t0
    imgs, _ = cifar_synthetic()
    feeds = serve_requests(imgs, SERVE_REQUESTS, 3)
    alone = [pred.run_batch(f)[0] for f in feeds]
    eng = ServingEngine(pred, max_queue=2 * SERVE_REQUESTS).start()
    hs = ServingHealthServer(eng).start()
    try:
        t0 = time.perf_counter()
        handles = submit_from_threads(eng, feeds, SERVE_THREADS)
        got = [h.result(timeout=300)[0] for h in handles]
        wall = time.perf_counter() - t0
        c = dict(eng.counters)
        lat = eng.engine_latency_stats()
        err = max(float(np.abs(g - a).max()) for g, a in zip(got, alone))
        expect(all(g.shape == (len(f["img"]), 10) and np.isfinite(g).all()
                   for g, f in zip(got, feeds)), "malformed responses")
        expect(err <= 1e-4, f"a packed response differs from its request "
                            f"run alone by {err}")
        expect(c["serve_batches"] < SERVE_REQUESTS,
               f"no packing: {c['serve_batches']} batches")
        expect(c.get("serve_degraded", 0) == 0, "a clean request degraded")
        clean = {"requests": SERVE_REQUESTS,
                 "rows": int(sum(len(f["img"]) for f in feeds)),
                 "requests_per_s": SERVE_REQUESTS / wall, "wall_s": wall,
                 "e2e_p50_ms": lat["e2e_p50_ms"],
                 "e2e_p99_ms": lat["e2e_p99_ms"],
                 "queue_wait_p99_ms": lat["queue_wait_p99_ms"],
                 "batches": c["serve_batches"],
                 "batch_fill_pct": c["serve_batch_fill_pct"],
                 "max_abs_err_vs_alone": err, "degraded": 0}

        before = profiler.counters_snapshot()
        fault.arm("serve.dispatch", times=2)
        try:
            fe = feeds[:4]
            handles = submit_from_threads(eng, fe, 1)
            got = [h.result(timeout=300)[0] for h in handles]
        finally:
            fault.disarm_all()
        delta = profiler.counters_delta(before)
        err_f = max(float(np.abs(g - a).max())
                    for g, a in zip(got, alone[:4]))
        expect(err_f <= 1e-4, f"the degraded leg differs by {err_f}")
        expect(delta.get("faults_injected", 0) == 2
               and delta.get("serve_degraded", 0) >= 1
               and delta.get("serve_failed", 0) == 0,
               f"the fault leg did not retry and degrade: {delta}")
        fault_leg = {"requests": len(fe), "faults_injected": 2,
                     "retry_attempts": delta.get("retry_attempts", 0),
                     "degraded": delta["serve_degraded"],
                     "max_abs_err_vs_alone": err_f}

        ready = http_get(f"127.0.0.1:{hs.port}", "/readyz")[0]
        expect(ready == 200, f"/readyz answered {ready} while serving")
        expect(eng.drain(timeout=60), "the drain did not flush")
        drained = http_get(f"127.0.0.1:{hs.port}", "/readyz")[0]
        expect(drained == 503, f"/readyz answered {drained} after drain")
    finally:
        hs.stop()
        eng.stop()
    return {"phase": "serving", "model": "phase 13's static ResNet "
            "inference model (3 x 32 x 32 -> 10 logits, f32)",
            "buckets": list(SERVE_BUCKETS), "threads": SERVE_THREADS,
            "warm_s": warm_s, "clean": clean, "fault": fault_leg,
            "readyz": [ready, drained],
            "memory": pred.memory_stats()}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 1's K6 and masked-K1 rows; phases 17-20: the embedding bag and
# padded BERT batches
# ---------------------------------------------------------------------------
BAG_V, BAG_D, BAG_B, BAG_S = 100000, 256, 4096, 64   # tools/op_bench.py:163
BAG_PAD = 0.2                 # share of ids equal to padding_idx 0


def bag_ids(rng, B, S, V):
    """(B, S) int64 ids in [0, V) with about BAG_PAD of them set to the
    padding index 0."""
    ids = rng.randint(0, V, (B, S)).astype(np.int64)
    ids[rng.rand(B, S) < BAG_PAD] = 0
    return ids


def bf16_ulp(torch, x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.full_like(x, 2.0 ** -133),
                       torch.ldexp(torch.ones_like(x), e - 8))


def check_embedding_bag(torch, fe, timing):
    """K6 against the plain version at ``tools/op_bench.py:163``'s shapes
    (table 100000 x 256, ids 4096 x 64 int64, ~20% padding given to the
    kernel as incubate's fused path gives it, -V - 1): sum, mean and
    sqrtn over an f32 and a bf16 table, with two bags that are all
    padding, one of only ids >= V and some ids >= V elsewhere (read as
    row V - 1), and over a 24,000-row f32 table that fits in L2 (the
    f32 table takes the kernel's row-order sweep, the other two its
    per-bag form). f32 within atol 1e-5 + rtol 1e-5 (the kernel adds a
    bag's rows in another order than the plain version), bf16
    within one bf16 ulp (both sum in f32 and round once); all-padding
    bags exactly 0; two launches bit for bit. Times the sum over the f32
    table (the main path's call) against its bound, the plain version
    and ``F.embedding_bag`` (sum and mean, padding_idx 0), and the
    24,000-row table against its own bound."""
    dev = "cuda"
    V, D, B, S = BAG_V, BAG_D, BAG_B, BAG_S
    gen = torch.Generator(device=dev).manual_seed(11)
    table = torch.randn((V, D), generator=gen, device=dev)
    raw = bag_ids(np.random.RandomState(11), B, S, V)
    ids = torch.tensor(np.where(raw == 0, -V - 1, raw), device=dev)
    edge = ids.clone()
    edge[5] = -1
    edge[77] = -V - 1
    edge[3, :5] = torch.arange(V, V + 5, device=dev)
    edge[9] = V + 3
    # a table that fits in L2, the same ids drawn in its range
    V1 = BAG_L2_ROWS
    table1 = torch.randn((V1, D), generator=gen, device=dev)
    edge1 = torch.where(edge >= V, edge - V + V1, torch.where(
        edge >= 0, edge % V1, edge))
    row = {"cases": {}, "l2_rows": V1}
    table16 = table.to(torch.bfloat16)
    for tname, t, x in (("f32", table, edge), ("bf16", table16, edge),
                        ("f32_l2", table1, edge1)):
        for combiner in ("sum", "mean", "sqrtn"):
            got = fe._cuda_bag(t, x, combiner)
            again = fe._cuda_bag(t, x, combiner)
            want = fe._plain_bag(t, x, combiner)
            torch.cuda.synchronize()
            expect(same_bits(torch, [got], [again]),
                   f"embedding bag {tname} {combiner}: two launches differ")
            err = max_err(got, want)
            expect(bool(torch.isfinite(got.float()).all()),
                   f"embedding bag {tname} {combiner}: non-finite output")
            expect(bool((got[[5, 77]] == 0).all()),
                   f"embedding bag {tname} {combiner}: a padding-only bag "
                   f"is not 0")
            if t.dtype == torch.float32:   # f32 sums in another order
                ok = torch.allclose(got, want, atol=1e-5, rtol=1e-5)
            else:
                ok = bool(((got.float() - want.float()).abs()
                           <= bf16_ulp(torch, want.float())).all())
            expect(ok, f"embedding bag {tname} {combiner}: disagrees with "
                       f"the plain version, max abs err {err}")
            row["cases"][f"{tname}_{combiner}"] = err
    row["max_abs_err"] = max(row["cases"].values())
    if timing:
        F = torch.nn.functional
        raw_t = torch.tensor(raw, device=dev)
        distinct = int(torch.unique(ids[ids >= 0]).numel())
        bytes_ = distinct * D * 4 + ids.numel() * 8 + B * D * 4
        bound, by = bound_of(bytes_, B * S * D, F32_FLOPS_PER_S)
        row.update({
            "ms": time_ms(torch, lambda: fe._cuda_bag(table, ids, "sum")),
            "mean_ms": time_ms(torch, lambda: fe._cuda_bag(table, ids,
                                                           "mean")),
            "bf16_ms": time_ms(torch, lambda: fe._cuda_bag(
                table16, ids, "sum")),
            "plain_ms": time_ms(torch, lambda: fe._plain_bag(
                table, ids, "sum"), iters=5),
            "library_ms": time_ms(torch, lambda: F.embedding_bag(
                raw_t, table, mode="sum", padding_idx=0)),
            "library_mean_ms": time_ms(torch, lambda: F.embedding_bag(
                raw_t, table, mode="mean", padding_idx=0)),
            "bound_ms": bound, "bound_by": by,
            "bound_bytes": bytes_, "distinct_rows": distinct,
            "op_bench_bound_ms": B * S * D * 4 / HBM_BYTES_PER_S * 1e3,
            "host_ms": host_dispatch_ms(torch, lambda: fe._cuda_bag(
                table, ids, "sum")),
            "l2_table": bag_shapes(torch, fe, (f"rows{V1}",))[
                f"rows{V1}"],
            "bound_rates": rates(F32_FLOPS_PER_S, "f32")})
    return row


BAG_L2_ROWS = 24000   # a 24.6 MB f32 table at D 256: fits in the 50 MB L2
# name -> (rows, D, bags, ids a bag, table type): the main path's ids over
# tables from 6,000 rows to twice the main one, bf16 tables of 1, 2 and 4
# times its rows and one of 1 KB rows (D 512), an f32 D that is a multiple of 4 and not of 8, bags of
# 1500 ids (256 and 2048 of them) and a 65,536-bag batch (more CTAs than
# the card holds at once)
BAG_SHAPES = {
    **{f"rows{v}": (v, BAG_D, BAG_B, BAG_S, "f32") for v in (
        6000, 12000, BAG_L2_ROWS, 36000, 50000, BAG_V, 200000)},
    "bf16": (BAG_V, BAG_D, BAG_B, BAG_S, "bf16"),
    "bf16_rows200000": (200000, BAG_D, BAG_B, BAG_S, "bf16"),
    "bf16_rows400000": (400000, BAG_D, BAG_B, BAG_S, "bf16"),
    "bf16_d512": (BAG_V, 512, BAG_B, BAG_S, "bf16"),
    "d100": (BAG_V, 100, BAG_B, BAG_S, "f32"),
    "long_bags": (BAG_V, BAG_D, 256, 1500, "f32"),
    "long_bags_bf16": (BAG_V, BAG_D, 256, 1500, "bf16"),
    "long_bags_b2048": (BAG_V, BAG_D, 2048, 1500, "f32"),
    "bags65536": (BAG_V, BAG_D, 65536, BAG_S, "f32"),
}


def bag_shapes(torch, fe, names=tuple(BAG_SHAPES)):
    """K6's sum at each named shape of BAG_SHAPES, ids drawn as the main
    path's (~20% padding, given as -V - 1): the kernel's ms beside the
    bound of the distinct rows those ids read once."""
    dev = "cuda"
    out = {}
    for name in names:
        V, D, B, S, dt = BAG_SHAPES[name]
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        size = 4 if dt == "f32" else 2
        gen = torch.Generator(device=dev).manual_seed(11)
        table = torch.randn((V, D), generator=gen, device=dev).to(dtype)
        raw = bag_ids(np.random.RandomState(11), B, S, V)
        ids = torch.tensor(np.where(raw == 0, -V - 1, raw), device=dev)
        distinct = int(torch.unique(ids[ids >= 0]).numel())
        bytes_ = distinct * D * size + ids.numel() * 8 + B * D * size
        bound, _ = bound_of(bytes_, B * S * D, F32_FLOPS_PER_S)
        out[name] = {
            "rows": V, "D": D, "bags": B, "ids_a_bag": S, "dtype": dt,
            "table_mb": V * D * size / 1e6, "distinct_rows": distinct,
            "ms": time_ms(torch, lambda: fe._cuda_bag(table, ids, "sum")),
            "bound_ms": bound}
        del table, ids
    return out


def len_mask(torch, lens, L):
    """(B, L) bool key mask: True at positions < lens[b]."""
    return key_padding_mask(torch, lens, L)[:, 0, 0, :].contiguous()


def check_flash_masked(torch, fa, timing):
    """K1a/K1b's masked form against the plain version: phase 2's padded
    32 x 512 x 12 x 64 in bf16 with dropout 0.1 (atol 2e-2 + rtol 1e-2),
    BERT phase 1's 128 x 128 in f32 with dropout (atol 1e-4), an f32
    causal case, a batch with fully masked rows (the mean of V) and one
    whose first kv tile is all masked; in bf16 a batch with entries of
    no live key (the mean of V) and a causal left-padded batch (a row
    whose allowed keys are all masked), with the kv tiles the bf16
    forward skipped (``kv_tile_visits``); the dropout keep mask read
    back bit for bit through a mask; two launches of the bf16 kernels
    give the same bits. Times the bf16 case against its bound,
    the plain version and SDPA with the float bias as ``attn_mask``."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(17)
    bf, f32 = torch.bfloat16, torch.float32
    first_tile = torch.arange(256, device=dev).expand(4, 256) >= 64
    left_padded = torch.arange(256, device=dev)[None, :] >= torch.tensor(
        [[0], [100], [3], [200]], device=dev)
    cases = [("bf16_L512", 32, 512, 12, 64, bf, False, 0.1,
              masked_lens(32, 512)),
             ("f32_L128", 128, 128, 12, 64, f32, False, 0.1,
              masked_lens(128, 128, seed=1)),
             ("f32_causal", 8, 256, 12, 64, f32, True, 0.1,
              masked_lens(8, 256, seed=2)),
             ("f32_all_masked", 4, 256, 4, 64, f32, False, 0.0,
              np.array([256, 0, 100, 0])),
             ("f32_first_tile", 4, 256, 4, 64, f32, False, 0.1, first_tile),
             ("bf16_all_masked", 4, 256, 4, 64, bf, False, 0.0,
              np.array([256, 0, 100, 0])),
             ("bf16_causal_left_padded", 4, 256, 4, 64, bf, True, 0.1,
              left_padded)]
    seed = 0x5EED9ABC
    row = {"cases": {}}
    main = None
    for name, B, L, H, D, dt, causal, p, lens in cases:
        keys = lens if torch.is_tensor(lens) else len_mask(torch, lens, L)
        bias = fa.kv_mask_bias(keys, B, L)
        q, k, v, do = [torch.randn((B, L, H, D), generator=gen,
                                   device=dev).to(dt) for _ in range(4)]
        out, lse = fa._cuda_fwd(q, k, v, causal, p, seed, bias)
        rout, rlse = fa._plain_fwd(q, k, v, causal, p, seed, bias)
        grads = fa._cuda_bwd(q, k, v, out, lse, do, causal, p, seed, bias)
        rgrads = fa._plain_bwd(q, k, v, rout, rlse, do, causal, p, seed,
                               bias)
        torch.cuda.synchronize()
        atol, rtol = (2e-2, 1e-2) if dt == bf else (1e-4, 0.0)
        errs = {"out": max_err(out, rout), "lse": max_err(lse, rlse)}
        for gname, got, want in zip(("out", "dq", "dk", "dv"),
                                    (out,) + grads, (rout,) + rgrads):
            errs[gname] = max_err(got, want)
            expect(bool(torch.isfinite(got.float()).all()),
                   f"flash masked {name}: non-finite {gname}")
            expect(torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol),
                   f"flash masked {name}: {gname} disagrees, max abs err "
                   f"{errs[gname]}")
        expect(errs["lse"] <= 1e-4, f"flash masked {name}: lse err "
                                    f"{errs['lse']}")
        if dt == bf:
            expect(same_bits(torch, (out, lse) + grads, fa._cuda_fwd(
                q, k, v, causal, p, seed, bias) + fa._cuda_bwd(
                q, k, v, out, lse, do, causal, p, seed, bias)),
                f"flash masked {name}: two launches give different bits")
        if name.endswith("_all_masked"):
            for b in (1, 3):
                mean_v = v[b].float().mean(0, keepdim=True).expand(L, H, D)
                errs[f"mean_v_{b}"] = max_err(out[b], mean_v)
                expect(torch.allclose(out[b].float(), mean_v, atol=atol,
                                      rtol=rtol) if dt == bf
                       else errs[f"mean_v_{b}"] <= 1e-5,
                       f"flash masked {name}: a fully masked row is not the "
                       f"mean of V ({errs[f'mean_v_{b}']})")
        if dt == bf:    # the bf16 forward's dead kv tiles (kv_tile_visits)
            full = fa.kv_tile_visits(B, L, L, causal)
            visits = fa.kv_tile_visits(B, L, L, causal, bias)
            errs["kv_tiles"] = int(full.sum())
            errs["kv_tiles_skipped"] = int((full & ~visits).sum())
        row["cases"][name] = errs
        if name == "bf16_L512":
            main = (q, k, v, do, out, lse, p, bias, lens)
        else:
            del q, k, v, do, out, rout, grads, rgrads
    # the dropout mask through a key mask, bit for bit: q = k = 0 gives
    # P = 1/n at the n live keys, v = I reads keep & live back out
    L, p, lens = 64, 0.1, np.array([64, 40, 1])
    z = torch.zeros((3, L, 2, 64), device=dev)
    eye = torch.eye(L, device=dev).reshape(1, L, 1, 64).expand(3, L, 2, 64)
    live = len_mask(torch, lens, L)
    out, _ = fa._cuda_fwd(z, z, eye.contiguous(), False, p, seed,
                          fa.kv_mask_bias(live, 3, L))
    keep = fa.philox_keep_mask(seed, 6, L, L, p, dev).view(3, 2, L, L)
    got = (out > 0).permute(0, 2, 1, 3)
    expect(torch.equal(got, keep & live[:, None, None, :]),
           "flash masked dropout mask differs from the plain Philox mask")
    row["mask_bitwise"] = True
    # head widths 192 and 256: a padded batch in bf16 and in f32, entries
    # with no live key (the mean of V) in bf16; f16 by the 2-byte rule
    # a padded batch in bf16 and in f32, entries with no live key (the mean
    # of V) in bf16, and a batch at L 320 whose shorter entries end 1 to 4
    # kv tiles early (the dead-tile skip; kv_tiles_skipped > 0)
    dead_lens = np.array([320, 100, 190, 64])
    row["wide"] = wide_rows(
        torch, fa, "stream", gen, wide_cases(torch, (
            ("bf16_D192_L512", 8, 512, 512, 4, 192, "bfloat16", False, 0.1),
            ("f32_D256", 2, 256, 256, 3, 256, "float32", False, 0.1),
            ("bf16_D256_all_masked", 4, 256, 256, 3, 256, "bfloat16", False,
             0.0),
            ("bf16_D192_dead_tiles", 4, 320, 320, 4, 192, "bfloat16", False,
             0.1))), seed, timing,
        masks={"bf16_D192_L512": masked_lens(8, 512, seed=3),
               "f32_D256": masked_lens(2, 256, seed=4),
               "bf16_D256_all_masked": np.array([256, 0, 100, 0]),
               "bf16_D192_dead_tiles": dead_lens})
    dead_bias = fa.kv_mask_bias(len_mask(torch, dead_lens, 320), 4, 320)
    skipped = int((fa.kv_tile_visits(4, 320, 320, False)
                   & ~fa.kv_tile_visits(4, 320, 320, False, dead_bias)).sum())
    expect(skipped > 0, "flash masked bf16_D192_dead_tiles: no kv tile "
                        "skipped")
    row["wide"]["bf16_D192_dead_tiles"]["kv_tiles_skipped"] = skipped
    row["wide"].update(wide_rows(
        torch, fa, "stream", gen, [("f16_D256_L256", 4, 256, 256, 3, 256,
                                    torch.float16, False, 0.1, LOSS_SCALE,
                                    1.0)], seed, timing, rule=True,
        masks={"f16_D256_L256": masked_lens(4, 256, seed=5)}))
    row["fwd_max_abs_err"] = max(c["out"] for c in row["cases"].values())
    row["bwd_max_abs_err"] = max(max(c["dq"], c["dk"], c["dv"])
                                 for c in row["cases"].values())
    if timing:
        q, k, v, do, out, lse, p, bias, lens = main
        B, L, H, D = q.shape
        el = B * L * H * D * 2                      # one bf16 tensor
        keys = int(lens.sum())                      # live keys over the batch
        # forward: q, k, v, the bias in; out and lse out; QK^T and PV over
        # the live keys at bf16 rate
        fb, fby = bound_of(4 * el + B * H * L * 4 + B * L * 4,
                           4 * H * L * D * keys, BF16_FLOPS_PER_S)
        # backward: q, k, v, out, dout, lse, bias in; dq, dk, dv out
        bb, bby = bound_of(8 * el + B * H * L * 4 + B * L * 4,
                           10 * H * L * D * keys, BF16_FLOPS_PER_S)
        F = torch.nn.functional
        qh, kh, vh, doh = (x.permute(0, 2, 1, 3).contiguous()
                           for x in (q, k, v, do))
        amask = bias.to(q.dtype)[:, None, None, :]
        qg, kg, vg = (x.clone().requires_grad_() for x in (qh, kh, vh))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask,
                                                 dropout_p=p)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=amask,
                                               dropout_p=p)
            return torch.autograd.grad(o, (qg, kg, vg), doh)

        row.update({
            "fwd_ms": time_ms(torch, lambda: fa._cuda_fwd(
                q, k, v, False, p, seed, bias)),
            "fwd_plain_ms": time_ms(torch, lambda: fa._plain_fwd(
                q, k, v, False, p, seed, bias), iters=3, warmup=1),
            "fwd_library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=amask, dropout_p=p)),
            "fwd_bound_ms": fb, "fwd_bound_by": fby,
            "bwd_ms": time_ms(torch, lambda: fa._cuda_bwd(
                q, k, v, out, lse, do, False, p, seed, bias)),
            "bwd_plain_ms": time_ms(torch, lambda: fa._plain_bwd(
                q, k, v, out, lse, do, False, p, seed, bias), iters=3,
                warmup=1),
            "bwd_library_ms": time_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qg, kg, vg), doh, retain_graph=True)),
            "fwd_bwd_library_ms": time_ms(torch, lib_fwd_bwd),
            "bwd_bound_ms": bb, "bwd_bound_by": bby,
            "unmasked_fwd_ms": time_ms(torch, lambda: fa._cuda_fwd(
                q, k, v, False, p, seed)),
            "unmasked_bwd_ms": time_ms(torch, lambda: fa._cuda_bwd(
                q, k, v, out, lse, do, False, p, seed)),
            "live_keys": keys,
            "bound_rates": rates(BF16_FLOPS_PER_S, "bf16 tensor-core")})
    return row


def bag_model(torch, ids, V, D, gen):
    """The bag path as a user builds it: ``incubate.layers.
    fused_embedding_seq_pool(ids, size=(V, D), padding_idx=0)`` creates
    the table, then ``nn.Linear(D, 2)``."""
    from paddle_tpu_torch import incubate, nn

    class BagModel(nn.Layer):
        def __init__(self):
            super().__init__()
            _, self.table = incubate.layers.fused_embedding_seq_pool(
                ids, size=(V, D), padding_idx=0, generator=gen)
            self.fc = nn.Linear(D, 2, generator=gen)

        def forward(self, x):
            return self.fc(incubate.layers.fused_embedding_seq_pool(
                x, size=(V, D), padding_idx=0, weight=self.table))

    return BagModel()


def bag_batch(torch, rng, B, S, V):
    return (torch.tensor(bag_ids(rng, B, S, V), device="cuda"),
            torch.tensor(rng.randint(0, 2, (B,)).astype(np.int64),
                         device="cuda"))


def bag_step(torch, model, lr):
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD

    opt = SGD(learning_rate=lr, parameters=model.parameters())
    return TrainStep(model, lambda m, x, y: F.cross_entropy(m(x), y), opt)


def phase_bag_parity(torch, counters, fe):
    """Two SGD TrainSteps of the bag model at a small size (table 1000 x
    64, ids 64 x 16) with the K6 kernel and again with its plain
    version, from the same weights, on the card: losses, the table's and
    the Linear's gradients and the updated parameters agree."""
    import copy

    V, D, B, S, lr = 1000, 64, 64, 16, 0.5
    gen = torch.Generator(device="cuda").manual_seed(12)
    batch = bag_batch(torch, np.random.RandomState(12), B, S, V)
    base = bag_model(torch, batch[0], V, D, gen)
    runs = {}
    for name in ("kernel", "plain"):
        model = copy.deepcopy(base)
        step = bag_step(torch, model, lr)
        counters.reset()
        swaps = [(fe, "bag_forward", fe._plain_bag)] if name == "plain" \
            else []
        with swapped(swaps):
            losses = [float(step(*batch)) for _ in range(2)]
        torch.cuda.synchronize()
        runs[name] = (losses, model, counters.snapshot())
    (lk, mk, ck), (lp, mp, cp) = runs["kernel"], runs["plain"]
    expect(ck.get("fused_embedding_bag", 0) == 2,
           f"bag_parity: the bag kernel did not launch once a step: {ck}")
    expect(not cp.get("fused_embedding_bag", 0),
           f"bag_parity: the plain run launched the bag kernel: {cp}")
    for a, b in zip(lk, lp):
        expect(abs(a - b) <= 1e-5 * abs(b),
               f"bag_parity: losses {lk} (kernel) against {lp} (plain)")
    worst = {"grad": 0.0, "param": 0.0}
    pp = dict(mp.named_parameters())
    for n, p in mk.named_parameters():
        q = pp[n]
        for key, got, want in (("grad", p.grad, q.grad), ("param", p, q)):
            err = max_err(got, want)
            scale = float(want.detach().abs().max())
            expect(err <= 1e-5 * scale + 1e-7,
                   f"bag_parity: {key} of {n} differs by {err} (max "
                   f"|value| {scale})")
            worst[key] = max(worst[key], err)
    return {"phase": "bag_parity", "config": "table 1000 x 64 (created by "
            "incubate.layers.fused_embedding_seq_pool, padding_idx 0), ids "
            "64 x 16, Linear(64, 2), cross-entropy, SGD lr 0.5, two steps",
            "losses_kernel": lk, "losses_plain": lp, "max_abs_err": worst,
            "launches": ck}


def bag_family(name):
    if "bag_sweep_kernel" in name or "bag_kernel" in name:
        return "bag_fwd"
    if "index" in name and ("add" in name or "func" in name):
        return "bag_bwd_index_add"
    if "sgdrule" in name:
        return "sgd"
    if any(t in name for t in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "gemm"
    return "other"


BAG_FAMILIES = ("bag_fwd", "bag_bwd_index_add", "sgd", "gemm", "other")


def phase_embedding_bag(torch, counters):
    """The bag path at ``tools/op_bench.py:163``'s K6 configuration: ids
    4096 x 64 from ``RandomState`` (~20% equal to padding_idx 0) into
    ``incubate.layers.fused_embedding_seq_pool(ids, size=(100000, 256),
    padding_idx=0)``, which creates the table, then ``nn.Linear(256,
    2)`` and ``F.cross_entropy`` under ``optimizer.SGD`` (lr 0.01), the
    same batch every step: 3 warm-up and 10 timed steps."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    V, D, B, S = BAG_V, BAG_D, BAG_B, BAG_S
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = bag_batch(torch, np.random.RandomState(0), B, S, V)
    model = bag_model(torch, batch[0], V, D, gen)
    params = list(model.parameters())
    step = bag_step(torch, model, 0.01)
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    med = float(np.median(step_ms))
    breakdown = profile_step(torch, step, batch, bag_family, BAG_FAMILIES,
                             med)
    n_steps = WARM_STEPS + TIMED_STEPS
    expect(all(np.isfinite(losses)), f"embedding_bag: non-finite loss "
                                     f"{losses}")
    expect(losses[-1] < losses[0],
           f"embedding_bag: loss did not fall ({losses[0]} -> "
           f"{losses[-1]})")
    for k in ("fused_embedding_bag", "fused_sgd"):
        expect(launches.get(k, 0) == n_steps,
               f"embedding_bag: {k} launched {launches.get(k, 0)} times "
               f"over {n_steps} steps, want one a step")
    return {"phase": "embedding_bag", "config": "ids 4096 x 64 (~20% "
            "padding_idx 0) -> incubate.layers.fused_embedding_seq_pool("
            "size=(100000, 256), padding_idx=0, f32, created) -> Linear(256,"
            " 2) -> cross-entropy, SGD lr 0.01, the same batch every step",
            "params": int(sum(p.numel() for p in params)),
            "param_tensors": len(params), "warmup_steps": WARM_STEPS,
            "timed_steps": TIMED_STEPS,
            "steps_per_s": TIMED_STEPS / (sum(step_ms) / 1e3),
            "bags_per_s": B * TIMED_STEPS / (sum(step_ms) / 1e3),
            "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
            "step_ms": step_ms, "loss_first": losses[0],
            "loss_last": losses[-1], "losses": losses, "launches": launches,
            "launches_per_step": {k: launches.get(k, 0) / n_steps
                                  for k in ("fused_embedding_bag",
                                            "fused_sgd")},
            "peak_mem_gb": peak, "breakdown": breakdown}, launches


# ---------------------------------------------------------------------------
# phase 1's external-lse K1b row; phases 21-23: GPT-2 small, one process
# and sequence parallel over two ranks on the card
# ---------------------------------------------------------------------------
GPT_BATCH, GPT_SEQ, SP = 8, 1024, 2
GPT_FAMILIES = ("flash_fwd", "flash_bwd", "adam", "gemm", "copy", "other")
SP_SPANS = ("collectives.ppermute", "collectives.all_reduce",
            "collectives.all_gather")


def gpt_family(name):
    """``bert_family``, with the host-staging copies of the SP exchange
    (pinned memory to and from the card) as their own family."""
    return "copy" if name.startswith("memcpy") else bert_family(name)


def check_flash_ring(torch, fa, ring, timing):
    """K1's external-lse form through the ring's arithmetic in one
    process (``ring_attention_chunks``: per-chunk K1a, the logsumexp
    merge, one external-lse K1b per live block with the global lse and
    delta) at GPT-2 small's attention shape, 8 x 1024 x 12 x 64 bf16,
    kv in 2 and in 4 chunks: causal, full and key-padded (lengths
    128-699, so the last of 4 chunks is dead on every row and skipped);
    held against the one-launch K1a/K1b over the whole sequence and
    against the plain versions (bf16 atol 2e-2 + rtol 1e-2; one f32 case
    at atol 1e-4). Then the kernel alone against its plain version at
    the SP path's block, 8 x 512 x 12 x 64 bf16 (a full block and the
    causal diagonal; two launches give the same bits), and its time
    there. Then the f16 forms (``f16``, ``check_flash_ring_f16``)."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(23)
    bf, f32 = torch.bfloat16, torch.float32
    B, L, H, D = GPT_BATCH, GPT_SEQ, 12, 64
    lens = np.random.RandomState(5).randint(128, 700, B)
    cases = [("bf16_causal_2", bf, True, 2, None),
             ("bf16_causal_4", bf, True, 4, None),
             ("bf16_full_2", bf, False, 2, None),
             ("bf16_full_4", bf, False, 4, None),
             ("bf16_padded_causal_4", bf, True, 4, lens),
             ("f32_causal_2", f32, True, 2, None)]
    row = {"cases": {}}
    for name, dt, causal, n, ln in cases:
        q, k, v, do = [torch.randn((B, L, H, D), generator=gen,
                                   device=dev).to(dt) for _ in range(4)]
        bias = None if ln is None else fa.kv_mask_bias(
            len_mask(torch, ln, L), B, L)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = ring.ring_attention_chunks(qg, kg, vg, n, causal, bias=bias)
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        one, lse1 = fa._cuda_fwd(q, k, v, causal, 0.0, 0, bias)
        g1 = fa._cuda_bwd(q, k, v, one, lse1, do, causal, 0.0, 0, bias)
        ref, lse2 = fa._plain_fwd(q, k, v, causal, 0.0, 0, bias)
        g2 = fa._plain_bwd(q, k, v, ref, lse2, do, causal, 0.0, 0, bias)
        torch.cuda.synchronize()
        atol, rtol = (2e-2, 1e-2) if dt == bf else (1e-4, 0.0)
        errs = {}
        for what, got, kern, plain in zip(("out", "dq", "dk", "dv"),
                                          (out,) + grads, (one,) + g1,
                                          (ref,) + g2):
            expect(bool(torch.isfinite(got.float()).all()),
                   f"flash ring {name}: non-finite {what}")
            for vs, want in (("one_launch", kern), ("plain", plain)):
                errs[f"{what}_vs_{vs}"] = max_err(got, want)
                expect(torch.allclose(got.float(), want.float(), atol=atol,
                                      rtol=rtol),
                       f"flash ring {name}: {what} disagrees with the "
                       f"{vs} version, max abs err {errs[f'{what}_vs_{vs}']}")
        row["cases"][name] = errs
        del q, k, v, do, out, grads, one, g1, ref, g2, qg, kg, vg
    # the kernel alone at the SP path's block: lse and delta of the whole
    # (two-block) sequence, the second block as k/v
    Lb = L // SP
    q, k, v, do, k0, v0 = [torch.randn((B, Lb, H, D), generator=gen,
                                       device=dev).to(bf) for _ in range(6)]
    out, lse = fa._plain_fwd(q, torch.cat([k0, k], 1),
                             torch.cat([v0, v], 1), False, 0.0, 0)
    delta = ext_delta(do, out, lse)
    errs = {}
    for part, causal in (("full", False), ("diagonal", True)):
        got = fa._cuda_bwd_ext(q, k, v, do, lse, delta, causal)
        want = fa._plain_bwd_ext(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        expect(same_bits(torch, got, fa._cuda_bwd_ext(q, k, v, do, lse,
                                                      delta, causal)),
               f"flash ext bwd {part}: two launches give different bits")
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            errs[f"{part}_{gname}"] = max_err(a, b)
            expect(torch.allclose(a.float(), b.float(), atol=2e-2,
                                  rtol=1e-2),
                   f"flash ext bwd {part}: {gname} disagrees, max abs err "
                   f"{errs[f'{part}_{gname}']}")
    row["block_errs"] = errs
    # the same block in f32 (atol 1e-4): the kernel's f32 arithmetic
    # against the plain version's, without bf16's rounding of the outputs
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    delta32 = ext_delta(do32, out, lse)
    for gname, a, b in zip(("dq", "dk", "dv"), fa._cuda_bwd_ext(
            q32, k32, v32, do32, lse, delta32, False), fa._plain_bwd_ext(
            q32, k32, v32, do32, lse, delta32, False)):
        errs[f"f32_full_{gname}"] = max_err(a, b)
        expect(errs[f"f32_full_{gname}"] <= 1e-4,
               f"flash ext bwd f32: {gname} err {errs[f'f32_full_{gname}']}")
    row["max_abs_err"] = max(errs.values())
    library = flash_ring_library(torch, q, k, v, do, out, lse)
    # the library call computes the same function: its grads agree
    lib_errs = row["library_errs"] = {}
    for gname, a, b in zip(("dq", "dk", "dv"), library(), fa._cuda_bwd_ext(
            q, k, v, do, lse, delta, False)):
        lib_errs[gname] = max_err(a.transpose(1, 2), b)
        expect(torch.allclose(a.transpose(1, 2).float(), b.float(),
                              atol=2e-2, rtol=1e-2),
               f"flash ext bwd: the library call's {gname} disagrees, max "
               f"abs err {lib_errs[gname]}")
    if timing:
        el = B * Lb * H * D * 2                    # one bf16 block tensor
        # q, k, v, dout, lse, delta in; dq, dk, dv out; S, dP, dV, dQ, dK
        # products over the block (half of them on the diagonal)
        nbytes = 7 * el + 2 * B * H * Lb * 4
        bound, by = bound_of(nbytes, 10 * B * H * Lb * Lb * D,
                             BF16_FLOPS_PER_S)
        dbound, dby = bound_of(nbytes, 5 * B * H * Lb * Lb * D,
                               BF16_FLOPS_PER_S)
        row.update({
            "ms": time_ms(torch, lambda: fa._cuda_bwd_ext(
                q, k, v, do, lse, delta, False)),
            "plain_ms": time_ms(torch, lambda: fa._plain_bwd_ext(
                q, k, v, do, lse, delta, False), iters=5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(torch, library),
            "diagonal_ms": time_ms(torch, lambda: fa._cuda_bwd_ext(
                q, k, v, do, lse, delta, True)),
            "diagonal_bound_ms": dbound, "diagonal_bound_by": dby,
            "saved_form_ms": time_ms(torch, lambda: fa._cuda_bwd(
                q, k, v, out, lse, do, False, 0.0, 0)),
            "shape": [B, Lb, H, D], "dtype": "bf16",
            "bound_rates": rates(BF16_FLOPS_PER_S, "bf16 tensor-core")})
    row["wide"] = wide_ext_rows(torch, fa, gen, timing)
    row["f16"] = check_flash_ring_f16(torch, fa, gen, timing)
    return row


def wide_ext_rows(torch, fa, gen, timing):
    """The external-lse K1b at head widths 192 and 256, alone at the SP
    block of GPT-2 small at 3 heads of 256 (8 x 512 x 3 x 256: full and
    the diagonal in bf16; f32 full at 4 heads of 192) and over f16 by the
    2-byte rule (a block holding little of each row's mass at dO scale
    1, 4 x 192 full at 2^15): lse and out of the whole (two-block)
    sequence from the plain version; dO N(0, 1) in the atol cases."""
    cases = (("bf16_D256_full", 8, 3, 256, torch.bfloat16, False, 1.0, None),
             ("bf16_D256_diagonal", 8, 3, 256, torch.bfloat16, True, 1.0,
              None),
             ("f32_D192_full", 2, 4, 192, torch.float32, False, 1.0, None),
             ("f16_D256_little_mass_scale1", 4, 3, 256, torch.float16, False,
              4.0, 1.0),
             ("f16_D192_full_scale2^15", 4, 4, 192, torch.float16, False, 1.0,
              LOSS_SCALE))
    Lb = GPT_SEQ // SP
    out_rows = {}
    for name, B, H, D, dt, causal, k0_mul, scale in cases:
        q, k, v, do = attention_inputs(
            torch, gen, B, Lb, Lb, H, D, dt,
            do_scale=B * Lb if scale is None else scale)
        k0, v0 = (torch.randn((B, Lb, H, D), generator=gen, device="cuda")
                  * m for m in (k0_mul, 1.0))
        out, lse = fa._plain_fwd(q.float(), torch.cat([k0, k.float()], 1),
                                 torch.cat([v0, v.float()], 1), False, 0.0,
                                 0)
        out_rows[name] = wide_case(
            torch, fa, "ext", name, q, k, v, do, causal, 0.0, 0,
            glob=(out.to(dt), lse), rule=dt == torch.float16, timing=timing)
        del q, k, v, do, k0, v0, out, lse
    return out_rows


def check_flash_ring_f16(torch, fa, gen, timing):
    """The external-lse K1b over f16 (GPT-2 over {"sp": 2} at O1 fp16),
    each case element by element (the rule above FLASH_UNIT_ROUNDOFF):
    the chunked ring (``ring_attention_chunks``, K1a f16 and the
    external-lse K1b f16 a block) at GPT-2 small's 8 x 1024 x 12 x 64,
    causal in 2 and 4 chunks and full in 2, dO at scale 1 (a unit
    gradient: the SP path has no loss scaler) and 2^15, against the
    plain version over the whole sequence, each block's rounding to f16
    allowed as ``flash_2byte_vs_plain`` says; then the kernel alone at
    the SP block 8 x 512 x 12 x 64 (lse and delta of two blocks): full,
    diagonal, and a block whose keys hold little of each row's mass (the
    other block's keys x 4), at scale 1 and 2^15, two launches bit for
    bit, and its time beside aten's flash backward over f16."""
    from paddle_tpu_torch.ops.cuda import counters

    f16 = torch.float16
    B, L, H, D = GPT_BATCH, GPT_SEQ, 12, 64
    row = {"cases": {}}
    before = counters.snapshot()
    for name, causal, n, scale in (("ring_causal_2_scale1", True, 2, 1.0),
                                   ("ring_causal_2_scale2^15", True, 2,
                                    LOSS_SCALE),
                                   ("ring_causal_4_scale1", True, 4, 1.0),
                                   ("ring_full_2_scale1", False, 2, 1.0)):
        q, k, v, do = attention_inputs(torch, gen, B, L, L, H, D, f16,
                                       do_scale=scale)
        used, errs, _ = flash_2byte_vs_plain(
            torch, fa, q, k, v, do, causal, 0.0, 0, case=name, form="ring",
            glob=n)
        row["cases"][name] = {"tolerance_used": used, "max_abs_err": errs}
        del q, k, v, do
    Lb = L // SP
    n_ext = 0
    for name, causal, k0_mul, scale in (
            ("block_full_scale1", False, 1.0, 1.0),
            ("block_full_scale2^15", False, 1.0, LOSS_SCALE),
            ("block_diagonal_scale1", True, 1.0, 1.0),
            ("block_little_mass_scale1", False, 4.0, 1.0),
            ("block_little_mass_scale2^15", False, 4.0, LOSS_SCALE)):
        q, k, v, do = attention_inputs(torch, gen, B, Lb, Lb, H, D, f16,
                                       do_scale=scale)
        k0, v0 = (torch.randn((B, Lb, H, D), generator=gen, device="cuda")
                  * m for m in (k0_mul, 1.0))
        # the whole (two-block) sequence's output and lse, in f32; the
        # kernel's block is the second one
        out, lse = fa._plain_fwd(q.float(), torch.cat([k0, k.float()], 1),
                                 torch.cat([v0, v.float()], 1), False, 0.0,
                                 0)
        out = out.to(f16)
        used, errs, got = flash_2byte_vs_plain(
            torch, fa, q, k, v, do, causal, 0.0, 0, case=name, form="ext",
            glob=(out, lse))
        delta = ext_delta(do, out, lse)
        expect(same_bits(torch, got, fa._cuda_bwd_ext(q, k, v, do, lse,
                                                      delta, causal)),
               f"flash ext bwd f16 {name}: two launches give different "
               f"bits")
        n_ext += 2
        row["cases"][name] = {"tolerance_used": used, "max_abs_err": errs}
        if name == "block_full_scale1":
            main = (q, k, v, do, out, lse, delta)
        del k0, v0, got
    moved = {c: counters.snapshot().get(c, 0) - before.get(c, 0) for c in (
        "flash_attention_ext_bwd_f16", "flash_attention_ext_bwd",
        "flash_attention_fwd_f16")}
    row["launches"] = moved
    # the ring's live blocks: causal in 2 chunks 3, in 4 chunks 10; full
    # in 2 chunks 4
    ring_blocks = 3 + 3 + 10 + 4
    expect(moved == {"flash_attention_ext_bwd_f16": n_ext + ring_blocks,
                     "flash_attention_ext_bwd": 0,
                     "flash_attention_fwd_f16": ring_blocks},
           f"flash ext bwd f16: launch counts {moved}")
    row["max_abs_err"] = max(max(c["max_abs_err"][g] for g in ("dq", "dk",
                                                              "dv"))
                             for c in row["cases"].values())
    row["max_tolerance_used"] = max(
        max(c["tolerance_used"].values()) for c in row["cases"].values())
    if timing:
        q, k, v, do, out, lse, delta = main
        el = B * Lb * H * D * 2
        bound, by = bound_of(7 * el + 2 * B * H * Lb * 4,
                             10 * B * H * Lb * Lb * D, BF16_FLOPS_PER_S)
        library = flash_ring_library(torch, q, k, v, do, out, lse)
        kern = fa._cuda_bwd_ext(q, k, v, do, lse, delta, False)
        row["library_vs_kernel_max_abs_err"] = {
            g: max_err(a.transpose(1, 2), b)
            for g, a, b in zip(("dq", "dk", "dv"), library(), kern)}
        qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
        row.update({
            "ms": time_ms(torch, lambda: fa._cuda_bwd_ext(
                q, k, v, do, lse, delta, False)),
            "plain_ms": time_ms(torch, lambda: fa._plain_bwd_ext(
                q, k, v, do, lse, delta, False), iters=5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(torch, library),
            "diagonal_ms": time_ms(torch, lambda: fa._cuda_bwd_ext(
                q, k, v, do, lse, delta, True)),
            "bf16_ms": time_ms(torch, lambda: fa._cuda_bwd_ext(
                qb, kb, vb, dob, lse, delta, False)),
            "shape": [B, Lb, H, D], "dtype": "f16",
            "bound_rates": rates(BF16_FLOPS_PER_S, "f16 tensor-core (the "
                                 "bf16 rate)")})
    return row


def flash_ring_library(torch, q, k, v, do, out, lse):
    """The one PyTorch call that computes the external-lse backward of a
    full (non-causal) block: aten's flash-attention backward, given this
    block's q and dO, the kv block, the merged output of the whole
    sequence and its lse (it computes delta = rowsum(dO * O) itself).
    The auxiliary arguments (cumulative lengths, rng state) are those
    its forward returns for the same block. Timed only; the port never
    calls it. Returns a callable giving (dq, dk, dv) as (B, H, L, D)."""
    aten = torch.ops.aten
    B, Lb, H, _ = q.shape
    qt, kt, vt, dot, ot = (x.transpose(1, 2) for x in (q, k, v, do, out))
    lse_t = lse.view(B, H, Lb).contiguous()
    fwd = aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, False)
    _, _, cum_q, cum_k, max_q, max_k, seed, offset, _ = fwd
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, ot, lse_t, cum_q, cum_k, max_q, max_k, 0.0, False,
        seed, offset)[:3]


def gpt_config(small, heads=12):
    """GPT-2 small (``GPTConfig.base()``) with attention dropout 0 (the
    ring runs at dropout 0) and hidden dropout 0.1, its width 768 in
    ``heads`` heads (3: head width 256); or the parity phases' small GPT,
    f32 without dropout."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    if small:
        return GPTConfig(vocab_size=1024, hidden_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=256, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)
    return GPTConfig(num_attention_heads=heads,
                     attention_probs_dropout_prob=0.0)


def gpt_ids(B, L, vocab):
    return np.random.RandomState(0).randint(0, vocab, (B, L)).astype(np.int64)


def gpt_step(torch, small, lr, mesh=None, dtype="bfloat16", heads=12):
    """(model, TrainStep) of a GPT (``gpt_config(small, heads)``) from
    seed 0 on the card: AdamW wd 0.01; full width under AMP O1 in
    ``dtype`` (fp16 with no loss scaler, as ``TrainStep`` takes none).
    With a mesh: ``data_spec=(None, "sp")``, ``sequence_parallel="sp"``."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PartitionSpec

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = GPTForCausalLM(gpt_config(small, heads), generator=gen)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01)

    def loss_fn(m, ids):
        if small:
            return m.loss(ids)
        with amp.auto_cast(level="O1", dtype=dtype):
            return m.loss(ids)

    kw = {} if mesh is None else dict(
        mesh=mesh, data_spec=PartitionSpec(None, "sp"),
        sequence_parallel="sp")
    return model, TrainStep(model, loss_fn, opt, **kw)


def sp_rank_setup():
    """A rank of the SP phases: the card, gloo, the ``{"sp": 2}`` mesh;
    the kernels are loaded from the parent's build."""
    import torch

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.parallel import create_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_parallel_env("gloo")
    return torch, create_mesh({"sp": SP})


def gpt_parity_rank(steps, lr):
    """A rank of ``gpt_sp_parity``: ``steps`` steps of the small GPT over
    the ``{"sp": 2}`` mesh; losses, the step-1 all-reduced gradients,
    the parameters after the steps and the launches."""
    torch, mesh = sp_rank_setup()
    from paddle_tpu_torch.ops.cuda import counters

    cfg = gpt_config(True)
    model, step = gpt_step(torch, True, lr, mesh)
    batch = torch.tensor(gpt_ids(4, 256, cfg.vocab_size), device="cuda")
    counters.reset()
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(batch)))
        if i == 0:
            grads = {n: p.grad.cpu().numpy()
                     for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    return {"losses": losses, "grads": grads, "launches": counters.snapshot(),
            "params": {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}}


def phase_gpt_sp_parity(torch, counters):
    """The small GPT (2 layers, hidden 128, 2 x 64 heads, vocab 1024,
    batch 4 x 256, f32, no dropout) two AdamW lr 1e-3 steps through
    ``TrainStep`` over ``{"sp": 2}`` (two ranks on the card over gloo)
    and in one process without a mesh: losses, the all-reduced step-1
    gradients and the parameters agree within atol 1e-4 + rtol 1e-4 (the
    key bias, whose true gradient is 0, within its bound 2 lr: Adam turns
    its last-bit noise into steps of up to lr); the SP ranks launch one
    K1a and one external-lse K1b per live block (rank 0 the diagonal,
    rank 1 its full block and the diagonal) and no saved-form K1b."""
    from paddle_tpu_torch.distributed import spawn

    steps, lr = 2, 1e-3
    t0 = time.perf_counter()
    ranks = spawn(gpt_parity_rank, args=(steps, lr), nprocs=SP, timeout=300)
    sp_s = time.perf_counter() - t0
    model, step = gpt_step(torch, True, lr)
    cfg = gpt_config(True)
    batch = torch.tensor(gpt_ids(4, 256, cfg.vocab_size), device="cuda")
    counters.reset()
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(batch)))
        if i == 0:
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()}
    single = counters.snapshot()
    n_layers = cfg.num_hidden_layers
    errs = {"loss": 0.0, "grad": 0.0, "param": 0.0, "key_bias": 0.0}

    def close(a, b):
        return bool(torch.allclose(a, b, atol=ATOL, rtol=RTOL))

    for r, got in enumerate(ranks):
        for a, b in zip(got["losses"], losses):
            errs["loss"] = max(errs["loss"], abs(a - b))
            expect(abs(a - b) <= ATOL + RTOL * abs(b),
                   f"gpt_sp_parity: rank {r} loss {a} vs {b}")
        for n, p in model.named_parameters():
            g = torch.from_numpy(got["grads"][n]).cuda()
            errs["grad"] = max(errs["grad"], max_err(g, grads[n]))
            expect(close(g, grads[n]), f"gpt_sp_parity: rank {r} gradient "
                                       f"{n} err {max_err(g, grads[n])}")
            w = torch.from_numpy(got["params"][n]).cuda()
            if n.endswith("k_proj.bias"):
                errs["key_bias"] = max(errs["key_bias"], max_err(w, p))
                expect(max_err(w, p) <= steps * lr,
                       f"gpt_sp_parity: rank {r} {n} err {max_err(w, p)}")
            else:
                errs["param"] = max(errs["param"], max_err(w, p))
                expect(close(w, p.detach()), f"gpt_sp_parity: rank {r} "
                                             f"parameter {n} err "
                                             f"{max_err(w, p)}")
        want = {"flash_attention_fwd": (r + 1) * n_layers * steps,
                "flash_attention_ext_bwd": (r + 1) * n_layers * steps,
                "flash_attention_bwd": 0}
        for k, n in want.items():
            expect(got["launches"].get(k, 0) == n,
                   f"gpt_sp_parity: rank {r} launched {k} "
                   f"{got['launches'].get(k, 0)} times, want {n}")
    expect(single.get("flash_attention_ext_bwd", 0) == 0
           and single.get("flash_attention_bwd", 0) == n_layers * steps,
           f"gpt_sp_parity: the one-process run launched {single}")
    return {"phase": "gpt_sp_parity", "steps": steps, "losses": losses,
            "sp_losses": [r["losses"] for r in ranks],
            "max_abs_err": errs, "sp_launches": [r["launches"]
                                                 for r in ranks],
            "single_launches": single, "sp_seconds": sp_s}


def gpt_flops_per_step(cfg, B, S):
    """``bert_flops_per_step``'s closed form for the GPT: 3 x the
    forward's matmul flops (8H^2 + 4HI + 4SH a layer and token, the
    tied vocabulary 2HV)."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    return 3 * B * S * (cfg.num_hidden_layers * (8 * H * H + 4 * H * I
                                                 + 4 * S * H) + 2 * H * V)


def gpt_row(torch, cfg, losses, step_ms, launches, tokens):
    med = float(np.median(step_ms))
    flops = gpt_flops_per_step(cfg, GPT_BATCH, GPT_SEQ)
    return {"warmup_steps": WARM_STEPS, "timed_steps": len(step_ms),
            "tokens_per_s": tokens * len(step_ms) / (sum(step_ms) / 1e3),
            "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
            "step_ms": step_ms, "flops_per_step": flops,
            "mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_gpt_losses(name, losses):
    expect(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    expect(losses[-1] < losses[0],
           f"{name}: loss did not fall ({losses[0]} -> {losses[-1]})")


GPT_CONFIG_DESC = ("GPT-2 small (vocab 50257, 12 x 768, 12 x 64 heads, ffn "
                   "3072, 1024 positions), batch 8 x 1024, AMP O1 bf16, "
                   "attention dropout 0, hidden dropout 0.1, AdamW lr 1e-4 "
                   "wd 0.01, the same batch every step")


def phase_gpt(torch, counters, heads=12):
    """GPT-2 small in one process: 3 warm-up and 10 timed steps, exactly
    12 K1a + 12 K1b and one Adam launch a step, a profiled step.
    ``heads=3`` (phase ``gpt_d256``): the same width in 3 heads of 256,
    so K1a and K1b run at head width 256; the same parameters and
    closed-form FLOPs."""
    cfg = gpt_config(False, heads)
    name = "gpt" if heads == 12 else f"gpt_d{cfg.hidden_size // heads}"
    torch.cuda.reset_peak_memory_stats()
    model, step = gpt_step(torch, False, 1e-4, heads=heads)
    batch = [torch.tensor(gpt_ids(GPT_BATCH, GPT_SEQ, cfg.vocab_size),
                          device="cuda")]
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    check_gpt_losses(name, losses)
    n_steps, L = WARM_STEPS + TIMED_STEPS, cfg.num_hidden_layers
    want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
            "fused_adam": 1, "flash_attention_ext_bwd": 0,
            "attention_plain": 0}
    for k, n in want.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"{name}: {k} launched {launches.get(k, 0)} times over "
               f"{n_steps} steps, want {n} a step")
    row = gpt_row(torch, cfg, losses, step_ms, launches,
                  GPT_BATCH * GPT_SEQ)
    row["breakdown"] = profile_step(torch, step, batch, gpt_family,
                                    GPT_FAMILIES, row["step_ms_median"])
    return {"phase": name, "config": GPT_CONFIG_DESC.replace(
                "12 x 64 heads", f"{heads} x {cfg.hidden_size // heads} "
                                 f"heads"),
            "params": sum(p.numel() for p in model.parameters()),
            **row}, launches


def gpt_sp_rank(dtype="bfloat16", timed=TIMED_STEPS):
    """A rank of ``gpt_sp`` (``gpt_sp_fp16``: ``dtype="float16"``): GPT-2
    small over ``{"sp": 2}``, each rank its half of every sequence; 3
    warm-up and ``timed`` timed steps, then one profiled step (rank 0
    records it, rank 1 runs its half)."""
    torch, mesh = sp_rank_setup()
    from paddle_tpu_torch.ops.cuda import counters
    from paddle_tpu_torch.parallel.collectives import STAGED_BYTES

    cfg = gpt_config(False)
    torch.cuda.reset_peak_memory_stats()
    model, step = gpt_step(torch, False, 1e-4, mesh, dtype)
    batch = [torch.tensor(gpt_ids(GPT_BATCH, GPT_SEQ, cfg.vocab_size),
                          device="cuda")]
    losses, step_ms, launches = train_steps(torch, counters, step, batch,
                                            timed=timed)
    row = gpt_row(torch, cfg, losses, step_ms, launches,
                  GPT_BATCH * GPT_SEQ)
    row["staged_bytes_per_step"] = launches.get(STAGED_BYTES, 0) / (
        WARM_STEPS + timed)
    if mesh.rank == 0:
        row["breakdown"] = profile_step(torch, step, batch, gpt_family,
                                        GPT_FAMILIES, row["step_ms_median"],
                                        spans=SP_SPANS)
    else:
        step(*batch)
        torch.cuda.synchronize()
    return row


GPT_SP_FP16_TIMED = 5    # gpt_sp_fp16's timed steps (after 3 warm-up)


def phase_gpt_sp(torch, counters, dtype="bfloat16"):
    """GPT-2 small and the same global batch over ``{"sp": 2}``: two
    processes on the card over gloo, rank 0 reporting; exact launches a
    step (rank 0: 12 K1a and 12 external-lse K1b, the diagonal; rank 1:
    24 and 24, its full block and the diagonal; no saved-form K1b). At
    ``dtype="float16"`` (phase ``gpt_sp_fp16``, AMP O1 fp16 with no loss
    scaler, 3 warm-up and GPT_SP_FP16_TIMED timed steps) those launches
    are K1a's and the external-lse K1b's f16 forms, and no bf16 or f32
    K1 runs."""
    from paddle_tpu_torch.distributed import spawn

    f16 = dtype == "float16"
    name = "gpt_sp_fp16" if f16 else "gpt_sp"
    timed = GPT_SP_FP16_TIMED if f16 else TIMED_STEPS
    cfg = gpt_config(False)
    t0 = time.perf_counter()
    ranks = spawn(gpt_sp_rank, args=(dtype, timed), nprocs=SP, timeout=600)
    seconds = time.perf_counter() - t0
    n_steps, L = WARM_STEPS + timed, cfg.num_hidden_layers
    sfx = "_f16" if f16 else ""
    total = {}
    for r, row in enumerate(ranks):
        check_gpt_losses(f"{name} rank {r}", row["losses"])
        want = {"flash_attention_fwd" + sfx: (r + 1) * L,
                "flash_attention_ext_bwd" + sfx: (r + 1) * L,
                "flash_attention_bwd": 0, "flash_attention_bwd_f16": 0,
                "fused_adam": 1}
        if f16:
            want.update({"flash_attention_fwd": 0,
                         "flash_attention_ext_bwd": 0})
        for k, n in want.items():
            got = row["launches"].get(k, 0)
            expect(got == n * n_steps,
                   f"{name}: rank {r} launched {k} {got} times over "
                   f"{n_steps} steps, want {n} a step")
        for k, n in row["launches"].items():
            total[k] = total.get(k, 0) + n
    expect(ranks[0]["losses"] == ranks[1]["losses"],
           f"{name}: the ranks report different global losses")
    config = GPT_CONFIG_DESC.replace(
        "AMP O1 bf16", "AMP O1 fp16 (no loss scaler)") if f16 \
        else GPT_CONFIG_DESC
    return {"phase": name, "config": config + ", sequence "
            "parallel over {'sp': 2}: two processes on one card over gloo, "
            "ring exchange staged through pinned host buffers",
            "seconds": seconds, **ranks[0],
            "rank1": {k: ranks[1][k] for k in (
                "step_ms_median", "peak_mem_gb", "staged_bytes_per_step",
                "launches")}}, total

# ---------------------------------------------------------------------------
# phase 1's chunk_lamb row; phases 24-25: the data-parallel static step
# (CompiledProgram over {"dp": 2}, ZeRO) on the book's conv net
# ---------------------------------------------------------------------------
ZERO_G = 2
BOOK_BATCH = 64
CHUNK_BYTES, CHUNK_FLOPS = 28, 20   # an element: p, g, m, v read; p, m, v
                                    # written; phase 1 and the update
ZERO_OPTS = {"momentum": lambda s: s.Momentum(0.05, momentum=0.9),
             "adam": lambda s: s.Adam(2e-3),
             "lamb": lambda s: s.Lamb(1e-3)}
ZERO_SPANS = ("collectives.ring_reduce_scatter",
              "collectives.ring_all_gather", "collectives.ppermute",
              "collectives.all_reduce", "collectives.all_gather")
ZERO_FAMILIES = ("conv_fwd", "conv_bwd", "conv_layout", "gemm",
                 "chunk_lamb", "static_update", "copy", "other")


def book_network(static, opt):
    """The PaddlePaddle book's recognize_digits conv network
    (``tests/test_book.py:62-81``): conv 5x5x16 + relu, pool 2, conv
    5x5x32 + relu, pool 2, fc 10; softmax cross-entropy, mean, accuracy;
    18,378 f32 parameters. (main, startup, loss, acc)."""
    main, startup = static.Program(), static.Program()
    with static.program_guard(main, startup):
        img = static.data("img", [-1, 1, 28, 28])
        label = static.data("label", [-1, 1], dtype="int64")
        h = static.nn.conv2d(img, 16, 5, act="relu")
        h = static.nn.pool2d(h, 2, pool_stride=2)
        h = static.nn.conv2d(h, 32, 5, act="relu")
        h = static.nn.pool2d(h, 2, pool_stride=2)
        logits = static.nn.fc(h, 10)
        loss = static.mean(static.softmax_with_cross_entropy(logits, label))
        acc = static.accuracy(static.softmax(logits), label)
        opt.minimize(loss)
    return main, startup, loss, acc


def book_bucket_layout():
    """The book net's one gradient bucket over ``{"dp": 2}``: its
    parameters' sizes in bucket order and the rank chunk's length."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.parallel.collectives import padded_len
    from paddle_tpu_torch.static.passes import comm_bucket_plan
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main = book_network(static, static.Lamb(1e-3))[0]
    (b,) = comm_bucket_plan(main.global_block, ("int8", 4 << 20, False),
                            ZERO_G)
    sizes = tuple(int(np.prod(main.global_block.vars[g].shape))
                  for g in b["grads"])
    return sizes, padded_len(b["elems"], ZERO_G) // ZERO_G


def book_batch(n=BOOK_BATCH, seed=0):
    """A fixed MNIST-shaped batch from a seed: images in [0, 1), labels
    0-9, each class with its own mean image (so the loss can fall)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, (n, 1)).astype(np.int64)
    base = np.random.RandomState(7).rand(10, 1, 28, 28).astype(np.float32)
    imgs = 0.6 * base[labels[:, 0]] + 0.4 * rng.rand(n, 1, 28, 28).astype(
        np.float32)
    return imgs.astype(np.float32), labels


def chunk_state(torch, elems, c, pos, found, gen):
    """One chunk's Lamb inputs on the card, the bucket's padding tail
    zero in p, g, m and v as the ZeRO step's concatenation makes it."""
    t = {"p": torch.randn(c, generator=gen, device="cuda") * 0.05,
         "g": torch.randn(c, generator=gen, device="cuda") * 1e-2,
         "m": torch.randn(c, generator=gen, device="cuda") * 1e-3,
         "v": (torch.randn(c, generator=gen, device="cuda") * 1e-4).abs()}
    tail = min(c, max(0, pos + c - sum(elems)))
    if tail:
        for x in t.values():
            x[c - tail:] = 0.0
    t["b1p"] = torch.tensor([0.9 ** 3], device="cuda")
    t["b2p"] = torch.tensor([0.999 ** 3], device="cuda")
    t["lr"] = torch.tensor([1e-3], device="cuda")
    t["found"] = None if found is None else torch.tensor([found],
                                                          device="cuda")
    return t


def chunk_call(fo, t, elems, pos, plain, seg=None, cache=None):
    """The chunk Lamb on ``t`` (in place, no cross-rank sum): the
    beta-pow outputs."""
    args = (t["p"], t["g"], t["m"], t["v"], t["b1p"], t["b2p"], t["lr"])
    if plain:
        return fo._plain_chunk_lamb_(*args, 0.9, 0.999, 1e-6, 0.01,
                                     t["found"], seg, len(elems) + 1,
                                     lambda s: None)
    return fo.chunk_lamb_(*args, beta1=0.9, beta2=0.999, eps=1e-6,
                          weight_decay=0.01, param_elems=elems, position=pos,
                          found=t["found"], cache=cache)


def chunk_split_ms(torch, fo, t, elems, pos, cache, iters=20, warmup=3):
    """Median device ms of the chunk Lamb's two launches apart, timed as
    ``time_ms`` times a call (L2 flushed, a spin kernel ahead): phase 1
    from the start event to an event recorded between the launches
    (where the cross-rank sum runs), the apply from there to the end."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    ev = {}

    def call():
        fo._cuda_chunk_lamb_(
            t["p"], t["g"], t["m"], t["v"], t["b1p"], t["b2p"], t["lr"],
            0.9, 0.999, 1e-6, 0.01, t["found"], elems, pos,
            lambda sums: ev["mid"].record(), cache)

    ev["mid"] = torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        call()
    p1, ap = [], []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        e0, ev["mid"], e1 = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        e0.record()
        call()
        e1.record()
        torch.cuda.synchronize()
        p1.append(e0.elapsed_time(ev["mid"]))
        ap.append(ev["mid"].elapsed_time(e1))
    return {"chunk_lamb_phase1": float(np.median(p1)),
            "chunk_lamb_apply": float(np.median(ap))}


def check_chunk_lamb(torch, fo, counters, timing):
    """K3's ZeRO chunk entry (chunk Lamb) against its plain version on
    the card, ``axis=None``: the book net's chunk over {"dp": 2} at both
    ranks' positions (the main path's: 6 segments and the padding), the
    chunk of BERT-base's largest bucket (the word embedding 30522 x 768
    alone at g = 2: 11,720,704 elements, one segment plus the padding)
    and a 524,288-element chunk over 64 segments; FoundInfinite absent,
    false and true. m, v and the beta-pow outputs bit for bit, p within
    1e-6 of the chunk's largest |p| (the norms sum by pieces, the plain
    version by index_add_), two kernel runs bit for bit, a set flag
    keeps everything; one launch of each kernel a call."""
    book_elems, book_c = book_bucket_layout()
    cases = {"book_rank0": (book_elems, book_c, book_c),
             "book_rank1": (book_elems, book_c, 0),
             "bert_word_emb": ((30522 * 768,), 11720704, 11720704),
             "segments64": ((8192,) * 64, 524288, 0)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    row = {"max_abs_err": 0.0, "max_rel_err": 0.0, "bitwise_m_v": True}
    for name, (elems, c, pos) in cases.items():
        seg = torch.from_numpy(fo.chunk_segments(elems, pos, c)).cuda()
        sub = {"elements": c, "segments": len(elems) + 1, "position": pos,
               "piece": fo.chunk_piece(c),
               "pieces": int(fo.chunk_pieces(elems, pos, c)[0].shape[0])}
        for found in (None, False, True):
            kern = chunk_state(torch, elems, c, pos, found, gen)
            again = {k: None if x is None else x.clone()
                     for k, x in kern.items()}
            plain = {k: None if x is None else x.clone()
                     for k, x in kern.items()}
            before = {k: None if x is None else x.clone()
                      for k, x in kern.items()}
            n0 = counters.get("chunk_lamb_phase1"), counters.get(
                "chunk_lamb_apply")
            kp = chunk_call(fo, kern, elems, pos, False)
            chunk_call(fo, again, elems, pos, False)
            pp = chunk_call(fo, plain, elems, pos, True, seg=seg)
            torch.cuda.synchronize()
            n1 = counters.get("chunk_lamb_phase1"), counters.get(
                "chunk_lamb_apply")
            expect(n1 == (n0[0] + 2, n0[1] + 2),
                   f"chunk_lamb {name}: launches {n0} -> {n1}")
            for k in ("m", "v"):
                expect(torch.equal(kern[k], plain[k]),
                       f"chunk_lamb {name} (found={found}): {k} differs "
                       f"from the plain version by "
                       f"{max_err(kern[k], plain[k])}")
            expect(torch.equal(kern["p"], again["p"]),
                   f"chunk_lamb {name}: two runs differ")
            for a, b in zip(kp, pp):
                expect(a.shape == (1,) and torch.equal(a, b.reshape(1)),
                       f"chunk_lamb {name}: beta-pow output differs")
            err = max_err(kern["p"], plain["p"])
            rel = err / max(float(plain["p"].abs().max()), 1e-30)
            expect(rel <= 1e-6, f"chunk_lamb {name} (found={found}): p "
                                f"err {err} ({rel} of max |p|)")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["max_rel_err"] = max(row["max_rel_err"], rel)
            if found:
                for k in ("p", "m", "v"):
                    expect(torch.equal(kern[k], before[k]),
                           f"chunk_lamb {name}: the set flag changed {k}")
        if timing:
            t = chunk_state(torch, elems, c, pos, None, gen)
            tp = {k: None if x is None else x.clone() for k, x in t.items()}
            cache = {}
            t_b, by = bound_of(CHUNK_BYTES * c, CHUNK_FLOPS * c,
                               F32_FLOPS_PER_S)
            sub.update({
                "ms": time_ms(torch, lambda: chunk_call(
                    fo, t, elems, pos, False, cache=cache)),
                "plain_ms": time_ms(torch, lambda: chunk_call(
                    fo, tp, elems, pos, True, seg=seg), iters=5),
                "library_ms": None, "bound_ms": t_b, "bound_by": by,
                "kernels_ms": chunk_split_ms(torch, fo, t, elems, pos,
                                             cache)})
            expect(int(cache["ticket"].item()) == 0,
                   f"chunk_lamb {name}: the ticket was left at "
                   f"{int(cache['ticket'].item())}")
        row[name] = sub
    if timing:
        row.update({k: row["book_rank0"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        row["bound_rates"] = rates(F32_FLOPS_PER_S, "f32")
    return row


def zero_family(name):
    if "chunk_lamb" in name or "segment_sum" in name:
        return "chunk_lamb"
    if "static" in name and "rule" in name:
        return "static_update"
    if "memcpy" in name or "memset" in name:
        return "copy"
    fam = resnet_family(name)
    return fam if fam in ZERO_FAMILIES else "other"


def zero_rank_setup(deterministic):
    """A rank of the data-parallel phases: the card, gloo, the
    ``{"dp": 2}`` mesh; the kernels are loaded from the parent's build."""
    import torch

    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.parallel import create_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = deterministic
    init_parallel_env("gloo")
    return torch, create_mesh({"dp": ZERO_G})


def zero_strategy(static, leg):
    bs = static.BuildStrategy()
    bs.mesh_shape = {"dp": ZERO_G}
    for k, v in leg.items():
        setattr(bs, k, v)
    return bs


def book_program(static, opt, init):
    """The book net with ``opt`` in a fresh scope holding ``init``:
    (main, loss, acc, scope)."""
    from paddle_tpu_torch.utils import unique_name

    with unique_name.guard():
        main, _startup, loss, acc = book_network(static, ZERO_OPTS[opt](
            static))
    scope = static.Scope()
    static.load_numpy_state(scope, init)
    return main, loss, acc, scope


KERNEL_PREFIXES = ("static_", "chunk_lamb_")


def zero_parity_rank(cases, inits, feed):
    """A rank of ``static_zero_parity``: each case's legs, 2 steps a leg:
    losses, accuracies, each step's kernel launches, the plan verdicts
    and the executor's counters."""
    torch, mesh = zero_rank_setup(True)
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.cuda import counters

    out = {"coords": mesh.coords}
    for name, (opt, legs) in cases.items():
        main, loss, acc, scope = book_program(static, opt, inits[opt])
        exe = static.Executor()
        counters.reset()
        losses, accs, steps = [], [], []
        for leg in legs:
            target = static.CompiledProgram(
                main, build_strategy=zero_strategy(static, leg))
            for _ in range(2):
                c0 = counters.snapshot()
                lo, ac = exe.run(target, feed=feed, fetch_list=[loss, acc],
                                 scope=scope)
                torch.cuda.synchronize()
                c1 = counters.snapshot()
                steps.append({k: v - c0.get(k, 0) for k, v in c1.items()
                              if k.startswith(KERNEL_PREFIXES)
                              and v != c0.get(k, 0)})
                losses.append(float(np.ravel(lo)[0]))
                accs.append(float(np.ravel(ac)[0]))
        snap = counters.snapshot()
        out[name] = {"losses": losses, "accs": accs, "steps": steps,
                     "verdicts": {k: v for k, v in snap.items()
                                  if k.startswith(("zero.",
                                                   "quant_allreduce."))},
                     "counters": dict(exe.counters)}
    return out


def zero_step_launches(opt, leg):
    """The kernel launches one step of ``leg`` makes on a rank: one
    static launch for the run of the 6 parameters' update ops (6 a step
    before the executor grouped runs), or one chunk update for the one
    bucket under ZeRO."""
    zero = bool(leg.get("zero_stage")) and bool(leg.get("comm_quant"))
    if opt == "lamb":
        return ({"chunk_lamb_phase1": 1, "chunk_lamb_apply": 1} if zero
                else {"static_lamb_phase1": 1, "static_lamb_apply": 1})
    return {f"static_{opt}": 1}


def book_inits(torch, opts):
    """The book net's startup state for each optimizer, made once on the
    card from a seed, as numpy."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.utils import unique_name

    out = {}
    for opt in opts:
        with unique_name.guard():
            _main, startup, _l, _a = book_network(static, ZERO_OPTS[opt](
                static))
        startup.random_seed = 1
        scope = static.Scope()
        with static.scope_guard(scope):
            static.Executor().run(startup)
        out[opt] = {k: v.cpu().numpy() for k, v in scope.items()}
    return out


def phase_static_zero_parity(torch, counters):
    """The book net over ``{"dp": 2}``, two ranks on the card over gloo,
    global batch 64, 2 steps a leg, cuDNN deterministic: comm(f32) x 2
    -> zero2(f32) x 2 -> comm(f32) x 2 equals six comm(f32) steps bit for
    bit (Momentum, through the absorb and the flip-back); zero3(f32) is
    comm(f32) bit for bit; zero2(f32) Lamb within rtol 1e-5 + atol 1e-6 of
    comm(f32) Lamb; zero2(int8) Adam within 1e-2 of comm(int8) Adam; the
    replicated dp step within 1e-5 of the one-rank Program on the same
    global batch in this process; both ranks the same values; each
    step's launches exact (a static form per tensor, or one chunk update
    per bucket); zero.zero counted and zero.xla not on the ZeRO cases."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed import spawn

    f32, z2 = {"comm_quant": "f32"}, {"comm_quant": "f32", "zero_stage": 2}
    z3 = {"comm_quant": "f32", "zero_stage": 3}
    i8, z2i8 = {"comm_quant": "int8"}, {"comm_quant": "int8",
                                         "zero_stage": 2}
    cases = {"momentum_comm": ("momentum", [f32] * 3),
             "momentum_mix": ("momentum", [f32, z2, f32]),
             "momentum_zero3": ("momentum", [z3] * 3),
             "momentum_dp": ("momentum", [{}] * 3),
             "lamb_comm": ("lamb", [f32] * 3),
             "lamb_zero2": ("lamb", [z2] * 3),
             "adam_comm_int8": ("adam", [i8] * 3),
             "adam_zero2_int8": ("adam", [z2i8] * 3)}
    inits = book_inits(torch, ("momentum", "lamb", "adam"))
    imgs, labels = book_batch()
    feed = {"img": imgs, "label": labels}
    t0 = time.perf_counter()
    ranks = spawn(zero_parity_rank, args=(cases, inits, feed),
                  nprocs=ZERO_G, timeout=300)
    seconds = time.perf_counter() - t0
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        main, loss, acc, scope = book_program(static, "momentum",
                                              inits["momentum"])
        exe = static.Executor()
        one = [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)[0])[0])
               for _ in range(6)]
    finally:
        torch.backends.cudnn.deterministic = prev
    expect([r["coords"] for r in ranks] == [{"dp": 0}, {"dp": 1}],
           f"static_zero_parity: coords {[r['coords'] for r in ranks]}")
    errs = {}
    for r, got in enumerate(ranks):
        expect(got["momentum_mix"]["losses"]
               == got["momentum_comm"]["losses"],
               f"static_zero_parity: rank {r} comm/zero2/comm f32 "
               f"{got['momentum_mix']['losses']} vs comm f32 "
               f"{got['momentum_comm']['losses']}")
        expect(got["momentum_zero3"]["losses"]
               == got["momentum_comm"]["losses"],
               f"static_zero_parity: rank {r} zero3 f32 differs from comm")
        a = np.asarray(got["lamb_zero2"]["losses"])
        b = np.asarray(got["lamb_comm"]["losses"])
        expect(np.allclose(a, b, rtol=1e-5, atol=1e-6),
               f"static_zero_parity: rank {r} Lamb zero2 {a} vs comm {b}")
        errs["lamb_zero2_vs_comm"] = float(np.abs(a - b).max())
        a = np.asarray(got["adam_zero2_int8"]["losses"])
        b = np.asarray(got["adam_comm_int8"]["losses"])
        expect(np.abs(a - b).max() <= 1e-2,
               f"static_zero_parity: rank {r} Adam int8 zero2 {a} vs {b}")
        errs["adam_int8_zero2_vs_comm"] = float(np.abs(a - b).max())
        a = np.asarray(got["momentum_dp"]["losses"])
        expect(np.abs(a - np.asarray(one)).max() <= 1e-5,
               f"static_zero_parity: rank {r} dp {a} vs one rank {one}")
        errs["dp_vs_one_rank"] = float(np.abs(a - np.asarray(one)).max())
        for name, (opt, legs) in cases.items():
            want = [zero_step_launches(opt, leg) for leg in legs
                    for _ in range(2)]
            expect(got[name]["steps"] == want,
                   f"static_zero_parity: rank {r} {name} launches "
                   f"{got[name]['steps']}, want {want}")
            v = got[name]["verdicts"]
            if any(leg.get("zero_stage") for leg in legs) and name != \
                    "momentum_dp":
                expect(v.get("zero.zero", 0) >= 1 and not v.get("zero.xla"),
                       f"static_zero_parity: {name} verdicts {v}")
            expect(all(np.isfinite(got[name]["losses"])),
                   f"static_zero_parity: {name} non-finite")
        for name in cases:
            expect(got[name]["losses"] == ranks[0][name]["losses"],
                   f"static_zero_parity: ranks differ in {name}")
    return {"phase": "static_zero_parity", "config": "the book's "
            "recognize_digits conv net, batch 64 x 1 x 28 x 28 over "
            "{'dp': 2}: two processes on one card over gloo",
            "seconds": seconds, "one_rank_losses": one,
            "losses": {n: ranks[0][n]["losses"] for n in cases},
            "counters": {n: ranks[0][n]["counters"] for n in cases},
            "max_abs_err": errs}


def zero_train_rank(init, imgs, labels):
    """A rank of ``static_zero``: the book net, ZeRO-2, int8 ring, Lamb
    lr 1e-3 over ``{"dp": 2}``; 3 warm-up and 10 timed steps, then one
    profiled step (rank 0 records it, rank 1 runs its half)."""
    torch, mesh = zero_rank_setup(False)
    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops.cuda import counters
    from paddle_tpu_torch.parallel.collectives import STAGED_BYTES

    torch.cuda.reset_peak_memory_stats()
    main, loss, acc, scope = book_program(static, "lamb", init)
    target = static.CompiledProgram(main, build_strategy=zero_strategy(
        static, {"comm_quant": "int8", "zero_stage": 2}))
    exe = static.Executor()

    def step(x, y):
        lo, _ac = exe.run(target, feed={"img": x, "label": y},
                          fetch_list=[loss, acc], scope=scope)
        return float(np.ravel(lo)[0])

    batch = (imgs, labels)
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n = WARM_STEPS + TIMED_STEPS
    med = float(np.median(step_ms))
    row = {"losses": losses, "loss_first": losses[0],
           "loss_last": losses[-1], "step_ms": step_ms,
           "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
           "steps_per_s": len(step_ms) / (sum(step_ms) / 1e3),
           "launches": launches,
           "staged_bytes_per_step": launches.get(STAGED_BYTES, 0) / n,
           "counters": dict(exe.counters),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if mesh.rank == 0:
        row["breakdown"] = profile_step(torch, step, batch, zero_family,
                                        ZERO_FAMILIES, med, spans=ZERO_SPANS)
    else:
        step(*batch)
        torch.cuda.synchronize()
    return row


def phase_static_zero(torch, counters):
    """The book net, ``zero_stage=2``, ``comm_quant="int8"``, Lamb lr
    1e-3 over ``{"dp": 2}`` (two processes on the card over gloo, global
    batch 64, the same batch every step): step ms, steps/s, the busy
    share and the host ms in the ``collectives.*`` spans of rank 0's
    profiled step, staged bytes a step, the ZeRO counters, the loss
    (finite, falling); exactly one chunk_lamb_phase1 and one
    chunk_lamb_apply a step on each rank, no static Lamb launch,
    zero.zero counted and zero.xla not."""
    from paddle_tpu_torch.distributed import spawn

    init = book_inits(torch, ("lamb",))["lamb"]
    imgs, labels = book_batch()
    t0 = time.perf_counter()
    ranks = spawn(zero_train_rank, args=(init, imgs, labels), nprocs=ZERO_G,
                  timeout=300)
    seconds = time.perf_counter() - t0
    n = WARM_STEPS + TIMED_STEPS
    total = {}
    for r, row in enumerate(ranks):
        lo = row["losses"]
        expect(all(np.isfinite(lo)) and lo[-1] < lo[0],
               f"static_zero: rank {r} losses {lo}")
        la = row["launches"]
        want = {"chunk_lamb_phase1": n, "chunk_lamb_apply": n,
                "zero.zero": 1, "quant_allreduce.quant": 1}
        expect({k: la.get(k, 0) for k in want} == want,
               f"static_zero: rank {r} launches {la}, want {want}")
        expect(not la.get("zero.xla") and not any(
            k.startswith("static_") for k in la),
            f"static_zero: rank {r} launched {la}")
        for k, v in la.items():
            total[k] = total.get(k, 0) + v
    expect(ranks[0]["losses"] == ranks[1]["losses"],
           "static_zero: the ranks report different losses")
    c = ranks[0]["counters"]
    return {"phase": "static_zero", "config": "the book's recognize_digits "
            "conv net (18,378 f32 parameters, one bucket padded to 18,432, "
            "a 9,216-element chunk a rank), batch 64 x 1 x 28 x 28, Lamb lr "
            "1e-3, zero_stage 2, comm_quant int8, over {'dp': 2}: two "
            "processes on one card over gloo, the ring staged through "
            "pinned host buffers", "seconds": seconds,
            **{k: v for k, v in ranks[0].items() if k != "counters"},
            "zero_counters": {k: v for k, v in c.items()
                              if k.startswith(("zero_", "comm_"))},
            "rank1": {k: ranks[1][k] for k in (
                "step_ms_median", "staged_bytes_per_step", "launches")}
            }, total


# ---------------------------------------------------------------------------
# slice 2b: the AMP O2 phases
# ---------------------------------------------------------------------------
def unit_at_max(torch, x):
    """One unit of x's type at its largest magnitude (the gap to the next
    value up)."""
    m = x.detach().abs().max().reshape(1)
    return float((torch.nextafter(m, torch.full_like(m, float("inf")))
                  - m).float())


# the O2 step's gradients, kernels against plain versions: bf16
# activations round in other places in the two runs, and a gradient that
# sums 1024 positions' bf16 terms (the embeddings') carries that
# rounding; measured on an H100: 3.2e-2 of the largest |g| at worst (the
# token-type table), 1.8e-2 elsewhere (two bf16 units)
GRAD_O2_RTOL = 5e-2
# the key projections' biases have an exactly-zero true gradient; their
# bf16 gradients are rounding noise, bounded here (measured on an H100:
# 5.3e-5, against ~0.1 for the largest |g| elsewhere)
ZERO_GRAD_O2 = 1e-3
O2_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
              "fused_xent_fwd_bf16", "fused_xent_bwd_bf16",
              "fused_adam_master")
F32_TRAIN_FORMS = ("fused_xent_fwd", "fused_xent_bwd", "fused_adam")


def o2_bert_loss(m, *a):
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return m.loss(*a)


def o2_bert(torch, model):
    """``model`` (an f32 BERT) decorated to O2 bf16 with an AdamW of f32
    masters, and its TrainStep."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return model, opt, TrainStep(model, o2_bert_loss, opt)


def masters_hold(torch, model, opt):
    """Whether every parameter is bf16/f16 and its f32 master's cast, bit
    for bit."""
    for p in model.parameters():
        w = opt._slots[id(p)].get("__master__")
        if w is None or w.dtype != torch.float32 or \
                not torch.equal(p, w.to(p.dtype)):
            return False
    return True


def phase_bert_o2_parity(torch, counters, fa, fx, fo):
    """One O2 bf16 TrainStep of a tiny BERT (f32 masters, dropout 0) with
    the kernels and with the plain versions, from the same weights, on
    the card: the kernels on the step's path (K1a, K1b, K2's bf16 form,
    K3-adam's master form) launch in one run and not in the other; the
    bf16 losses within 2 units of bf16, every gradient within
    ``GRAD_O2_RTOL`` of its largest value, the masters within twice one
    step's reach (2 lr (1 + wd |w|)) after the step, each parameter its
    master's cast."""
    import copy

    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import optimizer as optmod

    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    gen = torch.Generator(device="cuda").manual_seed(3)
    base = BertForPretraining(cfg, generator=gen)
    batch = bert_batch(torch, np.random.RandomState(4), 8, 128,
                       cfg.vocab_size)
    batch[2][:, ::3] = -100
    runs = {}
    for name in ("kernel", "plain"):
        m, o, step = o2_bert(torch, copy.deepcopy(base))
        counters.reset()
        if name == "plain":
            with swapped(bert_plain_swaps(fa, fx, fo, optmod)):
                loss = step(*batch)
        else:
            loss = step(*batch)
        torch.cuda.synchronize()
        runs[name] = (loss, m, o, counters.snapshot())
    (lk, mk, ok, ck), (lp, mp, op, cp) = runs["kernel"], runs["plain"]
    expect(all(ck.get(n, 0) == 1 or n.startswith("flash")
               and ck.get(n, 0) == cfg.num_hidden_layers
               for n in O2_KERNELS),
           f"bert_o2_parity: the O2 kernels did not launch: {ck}")
    expect(not any(ck.get(n, 0) for n in F32_TRAIN_FORMS),
           f"bert_o2_parity: an f32 K2/K3 form launched: {ck}")
    expect(not any(cp.get(n, 0) for n in O2_KERNELS),
           f"bert_o2_parity: the plain run launched kernels: {cp}")
    expect(lk.dtype == lp.dtype == torch.bfloat16,
           f"bert_o2_parity: loss types {lk.dtype}, {lp.dtype}")
    loss_tol = 2 * unit_at_max(torch, lp)
    expect(abs(float(lk) - float(lp)) <= loss_tol,
           f"bert_o2_parity: loss {float(lk)} (kernels) against "
           f"{float(lp)} (plain)")
    worst_g, worst_w, rels, zero_g = {"rel": 0.0}, 0.0, {}, 0.0
    pp = dict(mp.named_parameters())
    lr = 1e-4
    for n, p in mk.named_parameters():
        q = pp[n]
        expect(p.grad.dtype == torch.bfloat16, f"bert_o2_parity: grad of "
                                               f"{n} is {p.grad.dtype}")
        gerr = max_err(p.grad, q.grad)
        gscale = float(q.grad.float().abs().max())
        if n.endswith("k_proj.bias"):
            # an exactly-zero true gradient (a constant added to a row of
            # scores): both runs give rounding noise there, bounded apart
            zero_g = max(zero_g, gscale, float(p.grad.float().abs().max()))
            continue
        rel = gerr / max(gscale, 1e-30)
        rels[n] = rel
        if rel > worst_g["rel"]:
            worst_g = {"rel": rel, "err": gerr, "max_abs": gscale,
                       "param": n}
        wk = ok._slots[id(p)]["__master__"]
        werr = max_err(wk, op._slots[id(q)]["__master__"])
        # one AdamW step moves an element by at most lr (the Adam term)
        # plus lr*wd*|w| (the decay): two runs whose gradients differ in
        # sign stay within twice that, plus f32 rounding
        wmax = float(wk.abs().max())
        worst_w = max(worst_w, werr / (2 * lr * (1 + 0.01 * wmax)
                                       + 1e-6 * wmax))
    top = dict(sorted(rels.items(), key=lambda kv: -kv[1])[:5])
    expect(worst_g["rel"] <= GRAD_O2_RTOL,
           f"bert_o2_parity: a gradient differs past {GRAD_O2_RTOL} of its "
           f"largest value: {worst_g}; worst five {top}")
    expect(zero_g <= ZERO_GRAD_O2,
           f"bert_o2_parity: the key biases' zero gradient reads {zero_g}")
    expect(worst_w <= 1.0,
           f"bert_o2_parity: a master differs past two steps' reach "
           f"(ratio {worst_w})")
    expect(masters_hold(torch, mk, ok) and masters_hold(torch, mp, op),
           "bert_o2_parity: a parameter is not its master's cast")
    return {"phase": "bert_o2_parity", "config": "tiny (2 x 128, 2 heads, "
            "ffn 256, vocab 1024), batch 8 x 128, AMP O2 bf16 with f32 "
            "masters (amp.decorate), AdamW lr 1e-4 wd 0.01, no dropout",
            "loss_kernel": float(lk), "loss_plain": float(lp),
            "loss_tol": loss_tol,
            "grad_rtol_of_max": GRAD_O2_RTOL,
            "max_grad_err": worst_g, "worst_grad_rel": top,
            "key_bias_grad_max": zero_g,
            "master_err_over_two_steps": worst_w,
            "launches": ck}


def phase_bert_o2(torch, counters, o1_row):
    """``bench_bert``'s configuration at AMP O2: BERT-base with bf16
    weights and f32 masters (``amp.decorate``), 128 x 128, dropout 0.1,
    AdamW; 12 K1a, 12 K1b, one K2a and one K2b bf16 form and one
    K3-adam master form a step, no f32 K2/K3 launch."""
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    gc.collect()
    torch.cuda.empty_cache()
    cfg = BertConfig.base()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model, opt, step = o2_bert(torch, BertForPretraining(cfg,
                                                          generator=gen))
    n_params = sum(p.numel() for p in model.parameters())
    B, S = BERT_BATCH, BERT_SEQ
    batch = bert_batch(torch, np.random.RandomState(0), B, S,
                       cfg.vocab_size)
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    L = cfg.num_hidden_layers
    want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
            "fused_xent_fwd_bf16": 1, "fused_xent_bwd_bf16": 1,
            "fused_adam_master": 1}
    per_step = {k: launches.get(k, 0) / n_steps for k in want}
    expect(all(np.isfinite(losses)), f"bert_o2: non-finite loss {losses}")
    expect(losses[-1] < losses[0],
           f"bert_o2: loss did not fall ({losses[0]} -> {losses[-1]})")
    for k, n in want.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"bert_o2: {k} launched {launches.get(k, 0)} times over "
               f"{n_steps} steps, want {n} a step")
    expect(not any(launches.get(k, 0) for k in F32_TRAIN_FORMS),
           f"bert_o2: an f32 K2/K3 form launched: {launches}")
    expect(masters_hold(torch, model, opt),
           "bert_o2: after the last step a parameter is not bf16 or not "
           "its master's cast")
    expect(len(opt._kernel_cache[(torch.bfloat16, True)]["key"])
           == 6 * len(list(model.parameters())),
           "bert_o2: the Adam master launch did not cover every parameter")
    flops_per_step = bert_flops_per_step(cfg, B, S)
    med = float(np.median(step_ms))
    breakdown = profile_step(torch, step, batch, bert_family, BERT_FAMILIES,
                             med)
    row = {"phase": "bert_o2", "config": "BERT-base (vocab 30592, 12 x "
           "768, 12 x 64 heads, ffn 3072), batch 128 x seq 128, AMP O2 "
           "bf16 with f32 masters (amp.decorate), dropout 0.1, AdamW lr "
           "1e-4 wd 0.01",
           "params": n_params, "warmup_steps": WARM_STEPS,
           "timed_steps": TIMED_STEPS,
           "tokens_per_s": B * S * TIMED_STEPS / (sum(step_ms) / 1e3),
           "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
           "step_ms": step_ms, "flops_per_step": flops_per_step,
           "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": launches,
           "launches_per_step": per_step, "masters_hold": True,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "breakdown": breakdown}
    row["o1"] = {k: o1_row.get(k) for k in (
        "tokens_per_s", "step_ms_median", "step_ms_max", "mfu",
        "peak_mem_gb")}
    row["o1"]["device_busy_share"] = o1_row["breakdown"].get(
        "device_busy_share")
    return row, launches


# ---------------------------------------------------------------------------
# slice 1b: pure-bf16 BERT (K3-adam's 2-byte form), LARS ResNet-50, the
# eight XLA-only rules and the meta-optimizers, BERT under recompute
# ---------------------------------------------------------------------------
O2_PURE_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                   "fused_xent_fwd_bf16", "fused_xent_bwd_bf16",
                   "fused_adam_bf16")
K3_OTHER_FORMS = ("fused_adam", "fused_adam_master", "fused_adam_f16",
                  "fused_momentum", "fused_momentum_master",
                  "fused_momentum_bf16", "fused_momentum_f16", "fused_sgd",
                  "fused_sgd_master", "fused_sgd_bf16", "fused_sgd_f16",
                  "fused_lamb_phase1", "fused_lamb_apply",
                  "fused_lamb_phase1_master", "fused_lamb_apply_master",
                  "fused_lamb_phase1_bf16", "fused_lamb_apply_bf16",
                  "fused_lamb_phase1_f16", "fused_lamb_apply_f16")
FIRST_LOSS_RTOL = 1e-4


def o2_bert_loss_f32(m, ids, tt, mlm, nsp):
    """The O2 BERT loss with its two terms added in f32 (``m.loss`` adds
    them in bf16): the first-loss comparison's yardstick."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import functional as F

    with amp.auto_cast(level="O2", dtype="bfloat16"):
        seq, pooled = m.bert(ids, tt)
        h = m._mlm_hidden(seq)
        lm = F.fused_linear_cross_entropy(
            h, m.bert.embeddings.word_embeddings.weight, m.mlm_bias, mlm)
        ln = F.cross_entropy(m.nsp(pooled), nsp)
    return lm.float() + ln.float()


def o2_pure_bert(torch, model):
    """``model`` (an f32 BERT) decorated to O2 bf16 WITHOUT masters
    (``master_weight=False``: every parameter and AdamW's moments bf16),
    its AdamW and TrainStep."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    amp.decorate(model, opt, level="O2", dtype="bfloat16",
                 master_weight=False)
    return model, opt, TrainStep(model, o2_bert_loss, opt)


def phase_bert_o2_pure(torch, counters, fa, fx, fo, o2_row):
    """``bench_bert``'s model at ``decorate(level="O2", master_weight=
    False)``: BERT-base 128 x 128, dropout 0.1, AdamW 1e-4 through
    TrainStep, bf16 weights and moments, no master. First, from the same
    weights, one step with the kernels and one with the plain versions,
    their first losses (the terms added in f32) within 1e-4 relative;
    then 3 + 10 steps: exactly 12 + 12 K1 bf16, one K2a + K2b bf16 and
    one K3-adam 2-byte launch a step, no f32, master or other K3 form;
    tokens/s, step ms and peak memory beside ``bert_o2``'s. The loss is
    not required to fall: bf16 updates without masters lose the small
    steps."""
    import copy

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import optimizer as optmod

    gc.collect()
    torch.cuda.empty_cache()
    cfg = BertConfig.base()
    B, S = BERT_BATCH, BERT_SEQ
    batch = bert_batch(torch, np.random.RandomState(0), B, S,
                       cfg.vocab_size)
    first = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = BertForPretraining(cfg, generator=gen)
    for name in ("kernel", "plain"):
        model, opt = o2_pure_bert(torch, copy.deepcopy(base))[:2]
        step = TrainStep(model, o2_bert_loss_f32, opt)
        counters.reset()
        if name == "plain":
            with swapped(bert_plain_swaps(fa, fx, fo, optmod)):
                first[name] = float(step(*batch))
        else:
            first[name] = float(step(*batch))
        torch.cuda.synchronize()
        first[name + "_launches"] = counters.snapshot()
        del model, opt, step
    del base
    rel = abs(first["kernel"] - first["plain"]) / abs(first["plain"])
    expect(rel <= FIRST_LOSS_RTOL,
           f"bert_o2_pure: first loss {first['kernel']} (kernels) against "
           f"{first['plain']} (plain), {rel} relative")
    expect(first["kernel_launches"].get("fused_adam_bf16", 0) == 1
           and not any(first["plain_launches"].get(k, 0)
                       for k in O2_PURE_KERNELS),
           f"bert_o2_pure: the comparison's launches {first}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model, opt, step = o2_pure_bert(torch, BertForPretraining(
        cfg, generator=gen))
    params = list(model.parameters())
    expect(all(p.dtype == torch.bfloat16 for p in params)
           and not any("__master__" in opt._slots.get(id(p), {})
                       for p in params),
           "bert_o2_pure: a parameter is not bf16 or has a master")
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    L = cfg.num_hidden_layers
    want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
            "fused_xent_fwd_bf16": 1, "fused_xent_bwd_bf16": 1,
            "fused_adam_bf16": 1}
    expect(all(np.isfinite(losses)), f"bert_o2_pure: non-finite loss "
                                     f"{losses}")
    for k, n in want.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"bert_o2_pure: {k} launched {launches.get(k, 0)} times over "
               f"{n_steps} steps, want {n} a step")
    expect(not any(launches.get(k, 0) for k in F32_TRAIN_FORMS
                   + K3_OTHER_FORMS),
           f"bert_o2_pure: an f32, master or other K3 form launched: "
           f"{launches}")
    expect(all(p.dtype == torch.bfloat16 for p in params) and all(
        all(v.dtype == torch.bfloat16 for v in opt._slots[id(p)].values())
        for p in params), "bert_o2_pure: a parameter or moment left bf16")
    expect(len(opt._kernel_cache[(torch.bfloat16, False)]["key"])
           == 5 * len(params),
           "bert_o2_pure: the Adam launch did not cover every parameter")
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 1e9
    breakdown = profile_step(torch, step, batch, bert_family, BERT_FAMILIES,
                             med)
    flops_per_step = bert_flops_per_step(cfg, B, S)
    row = {"phase": "bert_o2_pure", "config": "BERT-base (vocab 30592, 12 x "
           "768, 12 x 64 heads, ffn 3072), batch 128 x seq 128, AMP O2 bf16 "
           "WITHOUT masters (amp.decorate master_weight=False: bf16 weights "
           "and AdamW moments), dropout 0.1, AdamW lr 1e-4 wd 0.01",
           "params": int(sum(p.numel() for p in params)),
           "warmup_steps": WARM_STEPS, "timed_steps": TIMED_STEPS,
           "first_loss_kernel_f32": first["kernel"],
           "first_loss_plain_f32": first["plain"],
           "first_loss_rel_err": rel, "first_loss_rtol": FIRST_LOSS_RTOL,
           "tokens_per_s": B * S * TIMED_STEPS / (sum(step_ms) / 1e3),
           "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
           "step_ms": step_ms, "flops_per_step": flops_per_step,
           "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": launches,
           "launches_per_step": {k: launches.get(k, 0) / n_steps
                                 for k in want},
           "peak_mem_gb": peak, "breakdown": breakdown}
    row["bert_o2"] = {k: o2_row.get(k) for k in (
        "tokens_per_s", "step_ms_median", "step_ms_max", "mfu",
        "peak_mem_gb")}
    row["peak_mem_drop_gb"] = o2_row["peak_mem_gb"] - peak
    return row, launches


def phase_resnet50_lars(torch, counters, o1_row):
    """ResNet-50 128 x 224^2 at AMP O1 bf16 with ``LarsMomentum(0.1,
    momentum=0.9, lars_coeff=0.001, lars_weight_decay=0.0005)``: the
    large-batch recipe. No K3 launch; the rule runs in tensor operations,
    one ``optimizer_rule.LarsMomentum`` count a parameter, 161 a step;
    the loss finite; imgs/s and step ms beside ``resnet50``'s."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import LarsMomentum
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = resnet50(num_classes=RESNET_CLASSES, generator=gen)
    params = list(model.parameters())
    opt = LarsMomentum(0.1, momentum=0.9, lars_coeff=0.001,
                       lars_weight_decay=0.0005, parameters=params)
    ce = nn.CrossEntropyLoss()

    def loss_fn(m, x, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return ce(m(x), y)

    step = TrainStep(model, loss_fn, opt)
    B, S = RESNET_BATCH, RESNET_SIZE
    rng = np.random.RandomState(0)
    batch = (torch.tensor(rng.randn(B, 3, S, S).astype(np.float32),
                          device="cuda"),
             torch.tensor(rng.randint(0, RESNET_CLASSES, (B,)).astype(
                 np.int64), device="cuda"))
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    expect(all(np.isfinite(losses)), f"resnet50_lars: non-finite loss "
                                     f"{losses}")
    got = launches.get("optimizer_rule.LarsMomentum", 0)
    expect(got == len(params) * n_steps,
           f"resnet50_lars: optimizer_rule.LarsMomentum {got} over {n_steps} "
           f"steps, want {len(params)} a step")
    k3 = {k: v for k, v in launches.items() if k.startswith(("fused_",
                                                             "static_"))
          and "xent" not in k and "flash" not in k and "bag" not in k}
    expect(not k3, f"resnet50_lars: a K3 kernel launched: {k3}")
    expect(all(p.grad is not None for p in params)
           and all(bool((opt._slots[id(p)]["velocity"] != 0).any())
                   for p in params),
           "resnet50_lars: a parameter's velocity was never updated")
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 1e9
    breakdown = profile_step(torch, step, batch, resnet_family,
                             RESNET_FAMILIES, med)
    flops_per_step = 3 * 8.2e9 * B
    row = {"phase": "resnet50_lars", "config": "ResNet-50 (BottleneckBlock "
           "[3, 4, 6, 3], 1000 classes), batch 128 x 3 x 224 x 224, AMP O1 "
           "bf16, LarsMomentum lr 0.1 mu 0.9 lars_coeff 0.001 "
           "lars_weight_decay 0.0005, the same batch every step",
           "param_tensors": len(params), "warmup_steps": WARM_STEPS,
           "timed_steps": TIMED_STEPS,
           "imgs_per_s": B * TIMED_STEPS / (sum(step_ms) / 1e3),
           "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
           "step_ms": step_ms, "flops_per_step": flops_per_step,
           "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "launches": launches,
           "rule_counts_per_step": got / n_steps, "peak_mem_gb": peak,
           "breakdown": breakdown}
    row["resnet50"] = {k: o1_row.get(k) for k in (
        "imgs_per_s", "step_ms_median", "step_ms_max", "peak_mem_gb")}
    return row, launches


# per-tensor bound of the card-vs-CPU comparison, a share of the tensor's
# largest magnitude: the elementwise rules are the same IEEE operations on
# both (bit for bit where no reduction or pow enters); LARS's and Dpsgd's
# norms are sums in other orders, Ftrl's pow is another implementation
RULES_RTOL = 1e-5
DPSGD_NOISE = (1.0, 16)   # sigma, batch_size of the moment check (clip 1)


def rule_configs():
    """(name, build(params), steps) of the parity phase: the eight rules,
    DGC with a warm-up (momentum at step 1, sparsity 0.75 at step 2,
    0.999 at step 3), and the meta-optimizers over kernel rules."""
    from paddle_tpu_torch import optimizer as O

    def meta(cls, inner, **kw):
        return lambda ps: cls(inner(ps), **kw)

    return [
        ("Adamax", lambda ps: O.Adamax(1e-3, parameters=ps), 3),
        ("Adagrad", lambda ps: O.Adagrad(
            1e-2, parameters=ps, initial_accumulator_value=0.1), 3),
        ("DecayedAdagrad", lambda ps: O.DecayedAdagrad(1e-2, parameters=ps),
         3),
        ("Adadelta", lambda ps: O.Adadelta(1.0, parameters=ps), 3),
        ("RMSProp", lambda ps: O.RMSProp(1e-3, momentum=0.9, centered=True,
                                         parameters=ps), 3),
        ("Ftrl", lambda ps: O.Ftrl(1e-2, l1=1e-4, l2=1e-4, parameters=ps), 3),
        ("LarsMomentum", lambda ps: O.LarsMomentum(0.1, parameters=ps), 3),
        ("Dpsgd", lambda ps: O.Dpsgd(1e-2, clip=1.0, sigma=0.0,
                                     parameters=ps, seed=7), 3),
        ("DGCMomentum", lambda ps: O.DGCMomentum(
            1e-2, momentum=0.9, rampup_begin_step=1, rampup_step=2,
            sparsity=[0.75, 0.999], parameters=ps), 3),
        ("GradientMerge", meta(O.GradientMergeOptimizer,
                               lambda ps: O.Momentum(1e-2, parameters=ps),
                               k_steps=4), 12),
        ("LookAhead", meta(O.LookAhead, lambda ps: O.SGD(1e-2, parameters=ps),
                           alpha=0.5, k=2), 3)]


def rule_run(torch, build, shapes, grads, steps, device, record=None):
    """``steps`` steps of ``build(params)`` over f32 parameters of
    ``shapes`` on ``device``, the gradients ``grads[i % len(grads)]``
    (CPU tensors, copied): (parameters, slot tensors, DGC's masks)."""
    gen = torch.Generator().manual_seed(11)
    params = [torch.nn.Parameter((torch.randn(s, generator=gen) * 0.02)
                                 .to(device)) for s in shapes]
    opt = build(params)
    masks = []
    if record is not None:
        inner = opt.mask

        def mask(v, s):
            m = inner(v, s)
            masks.append(m.cpu())
            return m

        opt.mask = mask
    for i in range(steps):
        for p, g in zip(params, grads[i % len(grads)]):
            p.grad = g.to(device)
        opt.step()
    if device == "cuda":
        torch.cuda.synchronize()
    core = getattr(opt, "inner", opt)
    slots = [v for p in params for v in core._slots.get(id(p), {}).values()]
    out = ([p.detach().cpu() for p in params], [s.cpu() for s in slots],
           masks)
    del params, opt
    return out


RULE_NAMES = ("Adamax", "Adagrad", "DecayedAdagrad", "Adadelta", "RMSProp",
              "Ftrl", "LarsMomentum", "Dpsgd", "DGCMomentum")


def rel_err(a, b):
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def phase_optimizer_rules_parity(torch, counters, bert_shapes):
    """The eight XLA-only rules, DGCMomentum with a warm-up schedule and
    GradientMerge(k=4), LookAhead, EMA and ModelAverage, 3 steps on the
    card over ``bert_shapes`` (f32; the run passes BERT-base's cut to 3
    of its 12 layers: 62 tensors, the widths BERT-base's) with gradients
    from a seed, against the same code on the CPU in this process: every
    parameter and state tensor within ``RULES_RTOL`` of its largest
    value, the tensors bit for bit counted, DGC's masks equal bit for
    bit; the rules' counters on the card (``optimizer_rule.<rule>``, one
    a parameter and step); Dpsgd's noise (sigma 1, zero gradients) with
    the mean and deviation of its largest tensor."""
    from paddle_tpu_torch import optimizer as O

    gen = torch.Generator().manual_seed(13)
    grads = [[torch.randn(s, generator=gen) * 1e-3 for s in bert_shapes]
             for _ in range(2)]
    out = {}
    for name, build, steps in rule_configs():
        counters.reset()
        card = rule_run(torch, build, bert_shapes, grads, steps, "cuda",
                        record=True if name == "DGCMomentum" else None)
        launched = counters.snapshot()
        host = rule_run(torch, build, bert_shapes, grads, steps, "cpu",
                        record=True if name == "DGCMomentum" else None)
        pairs = list(zip(card[0] + card[1], host[0] + host[1]))
        worst = max(rel_err(a, b) for a, b in pairs)
        same = sum(int(torch.equal(a, b)) for a, b in pairs)
        expect(worst <= RULES_RTOL, f"optimizer_rules_parity: {name} on the "
               f"card differs from the CPU by {worst} of a tensor's largest "
               f"value (bound {RULES_RTOL})")
        row = {"tensors": len(pairs), "bitwise_tensors": same,
               "max_rel_err": worst}
        if name == "DGCMomentum":
            expect(len(card[2]) == len(host[2]) == 2 * len(bert_shapes)
                   and all(torch.equal(a, b)
                           for a, b in zip(card[2], host[2])),
                   "optimizer_rules_parity: DGC's masks differ")
            row["masks_equal"] = len(card[2])
            row["mask_density"] = [float(m.float().mean())
                                   for m in card[2][:1] + card[2][-1:]]
        key = "optimizer_rule." + name
        if name in RULE_NAMES:
            expect(launched.get(key, 0) == steps * len(bert_shapes),
                   f"optimizer_rules_parity: {key} counted "
                   f"{launched.get(key, 0)}, want {steps} x "
                   f"{len(bert_shapes)}")
            row["counted"] = launched.get(key, 0)
        row["kernel_launches"] = {k: v for k, v in launched.items()
                                  if k.startswith("fused_")}
        out[name] = row
        del card, host, pairs
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("EMA", "ModelAverage"):
        res = {}
        for device in ("cuda", "cpu"):
            params = [torch.nn.Parameter(g.to(device) * 20.0)
                      for g in grads[0]]
            opt = O.SGD(1e-2, parameters=params)
            avg = O.EMA(0.999) if name == "EMA" else O.ModelAverage()
            avg.register(params)
            for i in range(3):
                for p, g in zip(params, grads[i % 2]):
                    p.grad = g.to(device)
                opt.step()
                avg.update()
            fast = [p.detach().clone() for p in params]
            avg.apply()
            applied = [p.detach().to("cpu", copy=True) for p in params]
            avg.restore()
            restored = all(torch.equal(p, f) for p, f in zip(params, fast))
            res[device] = (applied, restored, [f.cpu() for f in fast])
            del params, opt, avg, fast
        pairs = list(zip(res["cuda"][0], res["cpu"][0]))
        worst = max(rel_err(a, b) for a, b in pairs)
        fast_worst = max(rel_err(a, b) for a, b in zip(res["cuda"][2],
                                                      res["cpu"][2]))
        bad = [(i, tuple(a.shape), rel_err(a, b), int((a != b).sum()))
               for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
        expect(worst <= RULES_RTOL and res["cuda"][1] and res["cpu"][1],
               f"optimizer_rules_parity: {name} differs by {worst} (the "
               f"SGD-stepped weights by {fast_worst}; tensors {bad[:6]}) "
               f"or did not restore ({res['cuda'][1]}, {res['cpu'][1]})")
        out[name] = {"tensors": len(pairs), "max_rel_err": worst,
                     "bitwise_tensors": sum(int(torch.equal(a, b))
                                            for a, b in pairs),
                     "restored": True}
    # Dpsgd's noise: zero gradients, lr 1: p2 - p = -(sigma clip / batch) n
    sigma, batch = DPSGD_NOISE
    big = max(bert_shapes, key=lambda s: int(np.prod(s)))
    p = torch.nn.Parameter(torch.zeros(big, device="cuda"))
    opt = O.Dpsgd(1.0, clip=1.0, batch_size=batch, sigma=sigma,
                  parameters=[p], seed=7)
    p.grad = torch.zeros_like(p)
    opt.step()
    noise = -p.detach().double() / (sigma / batch)
    mean, std = float(noise.mean()), float(noise.std())
    n = noise.numel()
    expect(abs(mean) <= 5.0 / np.sqrt(n) and abs(std - 1.0) <= 1e-2,
           f"optimizer_rules_parity: Dpsgd's noise mean {mean}, deviation "
           f"{std} over {n} draws")
    out["Dpsgd"]["noise"] = {"draws": n, "mean": mean, "std": std}
    return {"phase": "optimizer_rules_parity", "config": "BERT-base's 206 "
            "f32 parameter shapes (110 M elements), gradients from a seed "
            "(x 1e-3), 3 steps (GradientMerge 12 calls), the card against "
            "the CPU in one process", "rtol_of_max": RULES_RTOL,
            "rules": out}


class deterministic:
    """PyTorch's deterministic algorithms inside the block (warnings, not
    errors, where an op has none): its CUDA embedding backward adds with
    atomics, so two BERT steps without recompute differ in the token-type
    table's gradient (measured on an H100: 2.7e-7)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.prev = (self.torch.are_deterministic_algorithms_enabled(),
                     self.torch.is_deterministic_algorithms_warn_only_enabled())
        self.torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(self.prev[0],
                                                warn_only=self.prev[1])
        return False


def phase_bert_recompute(torch, counters, bert_row):
    """BERT-base 128 x 128 at O1 bf16 with dropout 0.1 under
    ``RecomputeOptimizer(AdamW)`` with the 12 encoder layers as
    checkpoints: every step-1 gradient bit for bit the ``bert`` phase's
    (a fresh model from the same weights and seed, without recompute;
    both steps under ``deterministic``, since PyTorch's embedding
    backward is not);
    then 3 + 10 steps: exactly 24 K1a and 12 K1b launches a step (each
    layer's forward runs again in the backward), one K2a + K2b and one
    K3-adam; peak memory below that of the step without recompute (a
    fresh model, measured in this phase from an empty cache) and below
    ``bert``'s, step ms beside ``bert``'s."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW, RecomputeOptimizer

    cfg = BertConfig.base()
    B, S = BERT_BATCH, BERT_SEQ
    batch = bert_batch(torch, np.random.RandomState(0), B, S,
                       cfg.vocab_size)

    def loss_fn(m, ids, tt, mlm, nsp):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(ids, tt, mlm, nsp)

    def build(recompute):
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = BertForPretraining(cfg, generator=gen)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        if recompute:
            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(list(model.bert.encoder.layers))
        return model, opt, TrainStep(model, loss_fn, opt)

    def step1_grads():
        model, _, step = build(False)
        with deterministic(torch):
            step(*batch)
        return [p.grad.cpu() for p in model.parameters()]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    want = step1_grads()
    # the step without recompute, measured as this phase measures its own
    # (phase 6's peak also counts what earlier phases left allocated)
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, step = build(True)
    counters.reset()
    with deterministic(torch):
        loss1 = float(step(*batch))
    torch.cuda.synchronize()
    first = counters.snapshot()
    got = [p.grad.cpu() for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    differ = [n for n, a, b in zip(names, got, want)
              if not same_bits(torch, [a], [b])]
    row = {"phase": "bert_recompute", "step1_grads_bitwise":
           len(names) - len(differ), "grads": len(names)}
    if differ:
        # shown and explained: is the plain step itself deterministic?
        again = step1_grads()
        row["differ"] = {n: max_err(a, b) for n, a, b in zip(
            names, got, want) if n in differ}
        row["plain_step_deterministic"] = all(
            same_bits(torch, [a], [b]) for a, b in zip(again, want))
        emit(row)
    expect(not differ, f"bert_recompute: {len(differ)} step-1 gradients "
                       f"differ from the run without recompute: "
                       f"{differ[:5]}")
    del want
    L = cfg.num_hidden_layers
    expect(first.get("flash_attention_fwd", 0) == 2 * L
           and first.get("flash_attention_bwd", 0) == L,
           f"bert_recompute: step 1 launched {first}")
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    per = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
           "fused_xent_fwd": 1, "fused_xent_bwd": 1, "fused_adam": 1}
    for k, n in per.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"bert_recompute: {k} launched {launches.get(k, 0)} times "
               f"over {n_steps} steps, want {n} a step")
    expect(all(np.isfinite(losses)), f"bert_recompute: non-finite loss "
                                     f"{losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    expect(peak < min(plain_peak, bert_row["peak_mem_gb"]),
           f"bert_recompute: peak {peak} GB, not below one step's without "
           f"recompute ({plain_peak}) or bert's ({bert_row['peak_mem_gb']})")
    med = float(np.median(step_ms))
    flops_per_step = bert_flops_per_step(cfg, B, S)
    row.update({
        "config": "BERT-base (vocab 30592, 12 x 768, 12 x 64 heads, ffn "
        "3072), batch 128 x seq 128, AMP O1 bf16, dropout 0.1, "
        "RecomputeOptimizer(AdamW lr 1e-4 wd 0.01), the 12 encoder layers "
        "as checkpoints", "warmup_steps": WARM_STEPS,
        "timed_steps": TIMED_STEPS, "loss_step1": loss1,
        "tokens_per_s": B * S * TIMED_STEPS / (sum(step_ms) / 1e3),
        "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
        "step_ms": step_ms, "flops_per_step": flops_per_step,
        "mfu": flops_per_step / (med / 1e3) / BF16_FLOPS_PER_S,
        "losses": losses, "launches": launches,
        "launches_per_step": {k: launches.get(k, 0) / n_steps for k in per},
        "peak_mem_gb": peak, "peak_mem_gb_without_recompute": plain_peak,
        "bert": {k: bert_row.get(k) for k in (
            "tokens_per_s", "step_ms_median", "step_ms_max",
            "peak_mem_gb")}})
    return row, launches


def scaler_step(model, opt, scaler, loss_fn, x, y):
    """The eager O2 loop's step: ``scaler.scale(loss).backward();
    scaler.minimize(opt, scaled); opt.clear_grad()``; the loss."""
    model.train()
    loss = loss_fn(model, x, y)
    scaled = scaler.scale(loss)
    scaled.backward()
    scaler.minimize(opt, scaled)
    opt.clear_grad()
    return loss.detach()


def phase_resnet50_fp16(torch, counters, o1_row):
    """The fp16 ResNet-50 recipe: ``decorate(level="O2",
    dtype="float16")``, Momentum(lr 0.1, mu 0.9, ``L2Decay(1e-4)``,
    ``multi_precision``) and ``GradScaler(init_loss_scaling=128)`` in the
    eager loop; 3 warm-up and 10 timed steps, each unskipped one a
    K3-momentum master launch. Then a forced overflow through the public
    API (scale 2**40 for two steps): no K3 launch, parameters, masters
    and velocities unchanged bit for bit, ``_step_count`` unchanged, the
    scale 2**39 after; the state restored, one more step launches one
    K3."""
    from paddle_tpu_torch import amp, nn, regularizer
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    gc.collect()
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = resnet50(num_classes=RESNET_CLASSES, generator=gen)
    params = list(model.parameters())
    opt = Momentum(learning_rate=0.1, momentum=0.9, parameters=params,
                   weight_decay=regularizer.L2Decay(1e-4),
                   multi_precision=True)
    amp.decorate(model, opt, level="O2", dtype="float16")
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    ce = nn.CrossEntropyLoss()

    def loss_fn(m, x, y):
        with amp.auto_cast(level="O2", dtype="float16"):
            return ce(m(x), y)

    B, S = RESNET_BATCH, RESNET_SIZE
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(B, 3, S, S).astype(np.float32),
                     device="cuda")
    y = torch.tensor(rng.randint(0, RESNET_CLASSES, (B,)).astype(np.int64),
                     device="cuda")
    counters.reset()
    losses, step_ms, skipped = [], [], 0
    n_steps = WARM_STEPS + TIMED_STEPS
    for i in range(n_steps):
        t0 = time.perf_counter()
        before = opt._step_count
        losses.append(float(scaler_step(model, opt, scaler, loss_fn, x, y)))
        torch.cuda.synchronize()
        if i >= WARM_STEPS:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        skipped += int(opt._step_count == before)
    launches = counters.snapshot()
    expect(all(np.isfinite(losses)),
           f"resnet50_fp16: non-finite loss {losses}")
    expect(launches.get("fused_momentum_master", 0) == n_steps - skipped,
           f"resnet50_fp16: fused_momentum_master launched "
           f"{launches.get('fused_momentum_master', 0)} times over "
           f"{n_steps - skipped} unskipped steps")
    expect(not launches.get("fused_momentum", 0),
           f"resnet50_fp16: the f32 Momentum form launched: {launches}")
    expect(masters_hold(torch, model, opt),
           "resnet50_fp16: a parameter is not fp16 or not its master's cast")
    bufs = [b for _, b in model.named_buffers()]
    expect(all(b.dtype == torch.float16 and bool(torch.isfinite(b).all())
               for b in bufs),
           "resnet50_fp16: a running statistic is not finite fp16")
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 1e9
    breakdown = profile_step(
        torch, lambda a, b: scaler_step(model, opt, scaler, loss_fn, a, b),
        (x, y), resnet_family, RESNET_FAMILIES, med)
    # a forced overflow through the public API
    saved = scaler.state_dict()
    snap = [t.clone() for p in params for t in
            (p.detach(), opt._slots[id(p)]["__master__"],
             opt._slots[id(p)]["velocity"])]
    count0 = opt._step_count
    counters.reset()
    scaler.set_state_dict({"scale": 2.0 ** 40, "good": 0, "bad": 0})
    overflow_losses = [float(scaler_step(model, opt, scaler, loss_fn, x, y))
                       for _ in range(2)]
    torch.cuda.synchronize()
    over = counters.snapshot()
    expect(not over.get("fused_momentum_master", 0),
           f"resnet50_fp16: a K3 launch on a forced-overflow step: {over}")
    expect(same_bits(torch, snap, [t for p in params for t in
                                   (p.detach(),
                                    opt._slots[id(p)]["__master__"],
                                    opt._slots[id(p)]["velocity"])]),
           "resnet50_fp16: a forced-overflow step changed a parameter, "
           "master or velocity")
    expect(opt._step_count == count0,
           "resnet50_fp16: a forced-overflow step counted")
    expect(scaler.get_loss_scaling() == 2.0 ** 39,
           f"resnet50_fp16: scale {scaler.get_loss_scaling()} after two "
           f"overflows, want 2**39")
    scaled_down = scaler.get_loss_scaling()
    scaler.set_state_dict(saved)
    counters.reset()
    after = float(scaler_step(model, opt, scaler, loss_fn, x, y))
    torch.cuda.synchronize()
    expect(counters.get("fused_momentum_master") == 1
           and opt._step_count == count0 + 1,
           "resnet50_fp16: the step after the restore did not launch one "
           "K3")
    expect(np.isfinite(after), f"resnet50_fp16: non-finite loss {after}")
    row = {"phase": "resnet50_fp16", "config": "ResNet-50 (BottleneckBlock "
           "[3, 4, 6, 3], 1000 classes), batch 128 x 3 x 224 x 224, AMP O2 "
           "fp16 with f32 masters (amp.decorate), Momentum lr 0.1 mu 0.9 "
           "L2Decay(1e-4) multi_precision, GradScaler(128) dynamic, eager "
           "loop, the same batch every step",
           "params": int(sum(p.numel() for p in params)),
           "param_tensors": len(params), "warmup_steps": WARM_STEPS,
           "timed_steps": TIMED_STEPS,
           "imgs_per_s": B * TIMED_STEPS / (sum(step_ms) / 1e3),
           "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
           "step_ms": step_ms, "loss_first": losses[0],
           "loss_last": losses[-1], "losses": losses,
           "skipped_steps": skipped, "launches": launches,
           "launches_per_unskipped_step":
               launches.get("fused_momentum_master", 0)
               / max(n_steps - skipped, 1),
           "loss_scale": saved["scale"],
           "forced_overflow": {"losses": overflow_losses,
                               "k3_launches": over.get(
                                   "fused_momentum_master", 0),
                               "unchanged_bitwise": True,
                               "step_count_unchanged": True,
                               "scale_after": scaled_down},
           "loss_after_restore": after,
           "mem_at_start_gb": mem_start, "peak_mem_gb": peak,
           "breakdown": breakdown}
    row["o1"] = {k: o1_row.get(k) for k in (
        "imgs_per_s", "step_ms_median", "step_ms_max", "peak_mem_gb")}
    row["o1"]["device_busy_share"] = o1_row["breakdown"].get(
        "device_busy_share")
    return row, launches


# ---------------------------------------------------------------------------
# the Transformer NMT (bench.py's config 4, bench_nmt)
# ---------------------------------------------------------------------------
NMT_VOCAB = 32000
NMT_CONFIG = dict(src_vocab_size=NMT_VOCAB, tgt_vocab_size=NMT_VOCAB,
                  d_model=512, nhead=8, num_encoder_layers=6,
                  num_decoder_layers=6, dim_feedforward=2048, dropout=0.1)
NMT_DESC = ("Transformer NMT (vocab 32000 / 32000, d_model 512, 8 x 64 "
            "heads, 6 + 6 layers, ffn 2048, dropout 0.1), batch 64 x seq "
            "128, Adam lr 1e-4, the same batch every step (bench_nmt)")
# a step's launches: 6 encoder self-attention, 6 decoder self-attention
# (the subsequent mask: causal) and 6 cross-attention calls
NMT_ATTENTION_CALLS = 18


def nmt_batch(torch, B, S, vocab):
    """``bench.py:1653-1661``'s ids: src, tgt_in, tgt_out from
    ``RandomState(0)``, in [1, vocab)."""
    rng = np.random.RandomState(0)
    return [torch.tensor(rng.randint(1, vocab, (B, S)).astype(np.int64),
                         device="cuda") for _ in range(3)]


def nmt_flops_per_step(B, S, vocab=NMT_VOCAB, H=512, inner=2048, layers=6):
    """``bench.py:1662-1666``: 3 x the forward's matmul flops (encoder
    token 8H^2 + 4HI + 4SH, decoder token 16H^2 + 4HI + 8SH a layer, the
    output projection 2HV)."""
    enc = layers * (8 * H * H + 4 * H * inner + 4 * S * H)
    dec = layers * (16 * H * H + 4 * H * inner + 8 * S * H) + 2 * H * vocab
    return 3 * (enc + dec) * B * S


def nmt_figures(torch, losses, step_ms, launches, n_steps, B, S):
    """The training row's common figures: tokens/s as bench counts them
    (2 B S a step: source and target), step ms, MFU over 989 TFLOP/s,
    peak memory, the losses and the launches a step."""
    med = float(np.median(step_ms))
    flops = nmt_flops_per_step(B, S)
    return {"warmup_steps": WARM_STEPS, "timed_steps": TIMED_STEPS,
            "tokens_per_s": 2 * B * S * TIMED_STEPS / (sum(step_ms) / 1e3),
            "step_ms_median": med, "step_ms_max": float(np.max(step_ms)),
            "step_ms": step_ms, "flops_per_step": flops,
            "mfu": flops / (med / 1e3) / BF16_FLOPS_PER_S,
            "loss_first": losses[0], "loss_last": losses[-1],
            "losses": losses, "launches": launches,
            "launches_per_step": {k: v / n_steps
                                  for k, v in launches.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def expect_launches(what, launches, want, n_steps):
    """Exactly ``want[k]`` launches of each kernel k a step (0: none)."""
    for k, n in want.items():
        expect(launches.get(k, 0) == n * n_steps,
               f"{what}: {k} launched {launches.get(k, 0)} times over "
               f"{n_steps} steps, want {n} a step")


def phase_nmt(torch, counters):
    """bench_nmt at its full width on the card: ``jit.TrainStep``, AMP O1
    bf16, 3 warm-up and 10 timed steps; exactly 18 K1a + 18 K1b (bf16),
    one K2a + K2b (f32: the decoder's last norm is black-listed) and one
    K3-adam a step, no per-query plain attention; a profiled step.
    Returns (row, launches, model) (the model for ``nmt_decode``)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.transformer import TransformerNMT
    from paddle_tpu_torch.optimizer import Adam

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TransformerNMT(**NMT_CONFIG, generator=gen)
    opt = Adam(learning_rate=1e-4, parameters=model.parameters())

    def loss_fn(m, src, tin, tout):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(src, tin, tout)

    step = TrainStep(model, loss_fn, opt)
    B, L, _, _ = NMT_ATTENTION
    batch = nmt_batch(torch, B, L, NMT_VOCAB)
    losses, step_ms, launches = train_steps(torch, counters, step, batch)
    n_steps = WARM_STEPS + TIMED_STEPS
    expect(all(np.isfinite(losses)), f"nmt: non-finite loss {losses}")
    expect(losses[-1] < losses[0],
           f"nmt: loss did not fall ({losses[0]} -> {losses[-1]})")
    expect_launches("nmt", launches, {
        "flash_attention_fwd": NMT_ATTENTION_CALLS,
        "flash_attention_bwd": NMT_ATTENTION_CALLS, "fused_xent_fwd": 1,
        "fused_xent_bwd": 1, "fused_adam": 1, "attention_per_query_plain": 0,
        "flash_attention_fwd_f16": 0, "flash_attention_masked_fwd": 0,
        "fused_xent_fwd_bf16": 0}, n_steps)
    row = {"phase": "nmt", "config": NMT_DESC + ", AMP O1 bf16, "
           "jit.TrainStep",
           "params": int(sum(p.numel() for p in model.parameters())),
           **nmt_figures(torch, losses, step_ms, launches, n_steps, B, L)}
    row["breakdown"] = profile_step(torch, step, batch, bert_family,
                                    BERT_FAMILIES, row["step_ms_median"])
    return row, launches, model


def nmt_small(torch, seed=3):
    """The parity runs' narrower NMT: vocab 1000, d_model 128 (2 x 64
    heads), 2 + 2 layers, ffn 256, dropout 0."""
    from paddle_tpu_torch.models.transformer import TransformerNMT

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return TransformerNMT(1000, 1000, d_model=128, nhead=2,
                          num_encoder_layers=2, num_decoder_layers=2,
                          dim_feedforward=256, dropout=0.0, generator=gen)


NMT_PARITY_RTOL = {"float32": 1e-5, "float16": 2e-3}


def phase_nmt_parity(torch, counters, fa, fx, fo):
    """Three Adam steps of a narrower NMT (``nmt_small``, batch 8 x 128,
    pad id 0 at the targets' last 16 positions) through ``TrainStep``
    with the kernels and again with the plain versions swapped in, from
    the same weights, on the card: in f32 (K1's f32 forms) and at AMP O1
    fp16 (K1's f16 forms); the losses within NMT_PARITY_RTOL."""
    import copy

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.optimizer import optimizer as optmod

    base = nmt_small(torch)
    src, tin, tout = nmt_batch(torch, 8, 128, 1000)
    tout[:, -16:] = 0
    row = {"phase": "nmt_parity", "config": "NMT vocab 1000, d_model 128, "
           "2 x 64 heads, 2 + 2 layers, ffn 256, dropout 0, batch 8 x 128, "
           "Adam lr 1e-3, 3 steps", "legs": {}}
    for dtype, flash in (("float32", "flash_attention_fwd"),
                         ("float16", "flash_attention_fwd_f16")):
        runs = {}
        for name in ("kernel", "plain"):
            model = copy.deepcopy(base)

            def loss_fn(m, *a):
                with amp.auto_cast(enable=dtype != "float32", level="O1",
                                   dtype=dtype):
                    return m.loss(*a)

            step = TrainStep(model, loss_fn, Adam(
                learning_rate=1e-3, parameters=model.parameters()))
            counters.reset()
            if name == "plain":
                with swapped(bert_plain_swaps(fa, fx, fo, optmod)):
                    losses = [float(step(src, tin, tout)) for _ in range(3)]
            else:
                losses = [float(step(src, tin, tout)) for _ in range(3)]
            torch.cuda.synchronize()
            runs[name] = (losses, counters.snapshot())
        (lk, ck), (lp, cp) = runs["kernel"], runs["plain"]
        rtol = NMT_PARITY_RTOL[dtype]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        expect(ck.get(flash, 0) == 3 * 6 and ck.get("fused_adam", 0) == 3
               and ck.get("fused_xent_fwd", 0) == 3,
               f"nmt_parity {dtype}: kernel launches {ck}")
        expect(not any(v for k, v in cp.items()),
               f"nmt_parity {dtype}: the plain run launched kernels: {cp}")
        expect(all(np.isfinite(lk)) and rel <= rtol,
               f"nmt_parity {dtype}: losses {lk} (kernels) against {lp} "
               f"(plain), relative {rel} > {rtol}")
        row["legs"][dtype] = {"losses_kernel": lk, "losses_plain": lp,
                              "max_rel_diff": rel, "rtol": rtol,
                              "launches": ck}
    return row


def nmt_scaler_step(model, opt, scaler, loss_fn, batch):
    """The eager fp16 loop's step (``scaler_step`` over the NMT batch)."""
    model.train()
    loss = loss_fn(model, *batch)
    scaled = scaler.scale(loss)
    scaled.backward()
    scaler.minimize(opt, scaled)
    opt.clear_grad()
    return loss.detach()


def phase_nmt_fp16(torch, counters, o1_row):
    """bench_nmt at AMP O1 fp16 in the eager loop with ``GradScaler()``
    (its default first scale, 2^15; dynamic): 3 warm-up and 10 timed
    steps; every step 18 K1a + 18 K1b in their f16 forms and none in
    bf16, one K2a + K2b (f32), one K3-adam an unskipped step. Then a
    forced overflow (the scale set to 2^40 for two steps): no K3 launch,
    parameters and moments unchanged bit for bit, the step count
    unchanged, the scale 2^39 after; the state restored, one more step
    launches one K3."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.transformer import TransformerNMT
    from paddle_tpu_torch.optimizer import Adam

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TransformerNMT(**NMT_CONFIG, generator=gen)
    params = list(model.parameters())
    opt = Adam(learning_rate=1e-4, parameters=params)
    scaler = amp.GradScaler()

    def loss_fn(m, *a):
        with amp.auto_cast(level="O1", dtype="float16"):
            return m.loss(*a)

    B, L, _, _ = NMT_ATTENTION
    batch = nmt_batch(torch, B, L, NMT_VOCAB)
    counters.reset()
    losses, step_ms, skipped = [], [], 0
    n_steps = WARM_STEPS + TIMED_STEPS
    for i in range(n_steps):
        t0 = time.perf_counter()
        before = opt._step_count
        losses.append(float(nmt_scaler_step(model, opt, scaler, loss_fn,
                                            batch)))
        torch.cuda.synchronize()
        if i >= WARM_STEPS:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        skipped += int(opt._step_count == before)
    launches = counters.snapshot()
    expect(all(np.isfinite(losses)), f"nmt_fp16: non-finite loss {losses}")
    expect_launches("nmt_fp16", launches, {
        "flash_attention_fwd_f16": NMT_ATTENTION_CALLS,
        "flash_attention_bwd_f16": NMT_ATTENTION_CALLS,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "fused_xent_fwd": 1, "fused_xent_bwd": 1,
        "attention_per_query_plain": 0}, n_steps)
    expect(launches.get("fused_adam", 0) == n_steps - skipped,
           f"nmt_fp16: fused_adam launched {launches.get('fused_adam', 0)} "
           f"times over {n_steps - skipped} unskipped steps")
    row = {"phase": "nmt_fp16", "config": NMT_DESC + ", AMP O1 fp16, "
           "GradScaler() dynamic, the eager loop",
           **nmt_figures(torch, losses, step_ms, launches, n_steps, B, L),
           "skipped_steps": skipped, "loss_scale": scaler.get_loss_scaling()}
    row["breakdown"] = profile_step(
        torch, lambda *a: nmt_scaler_step(model, opt, scaler, loss_fn, a),
        batch, bert_family, BERT_FAMILIES, row["step_ms_median"])
    saved = scaler.state_dict()

    def state():
        return [t.clone() for p in params for t in
                (p.detach(), opt._slots[id(p)]["moment1"],
                 opt._slots[id(p)]["moment2"])]

    snap, count0 = state(), opt._step_count
    counters.reset()
    scaler.set_state_dict({"scale": 2.0 ** 40, "good": 0, "bad": 0})
    over_losses = [float(nmt_scaler_step(model, opt, scaler, loss_fn, batch))
                   for _ in range(2)]
    torch.cuda.synchronize()
    over = counters.snapshot()
    expect(not over.get("fused_adam", 0),
           f"nmt_fp16: a K3 launch on a forced-overflow step: {over}")
    expect(same_bits(torch, snap, state()),
           "nmt_fp16: a forced-overflow step changed a parameter or moment")
    expect(opt._step_count == count0 and
           scaler.get_loss_scaling() == 2.0 ** 39,
           f"nmt_fp16: after two overflows the step count moved or the "
           f"scale is {scaler.get_loss_scaling()} (want 2**39)")
    scaled_down = scaler.get_loss_scaling()
    scaler.set_state_dict(saved)
    counters.reset()
    after = float(nmt_scaler_step(model, opt, scaler, loss_fn, batch))
    torch.cuda.synchronize()
    expect(counters.get("fused_adam") == 1 and np.isfinite(after),
           "nmt_fp16: the step after the restore did not launch one K3")
    row["forced_overflow"] = {"losses": over_losses,
                              "k3_launches": over.get("fused_adam", 0),
                              "f16_flash_fwd": over.get(
                                  "flash_attention_fwd_f16", 0),
                              "unchanged_bitwise": True,
                              "scale_after": scaled_down}
    row["loss_after_restore"] = after
    row["o1_bf16"] = {k: o1_row.get(k) for k in (
        "tokens_per_s", "step_ms_median", "step_ms_max", "mfu",
        "peak_mem_gb")}
    row["o1_bf16"]["device_busy_share"] = o1_row["breakdown"].get(
        "device_busy_share")
    return row, launches


def nmt_top2_gap(torch, model, src, prefix):
    """The top-2 gap of ``model``'s next-token logits after ``prefix``
    (one row), with the plain versions in place of the kernels."""
    with torch.no_grad():
        logits = model(src[None], prefix[None])[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def phase_nmt_decode(torch, counters, fa, model):
    """``greedy_decode`` and ``beam_search_decode`` (beam 4, max_len 64)
    of the first 8 sources of the ``nmt`` phase's batch with the trained
    model (f32, eval: K1's f32 forms, cross-attention at Lq 1-63 against
    Lk 128, causal self-attention at L 1-63; beam search at L 64 over
    32 rows), held against the same model with the plain versions: a
    greedy row may part only where the plain model's top-2 gap at the
    first differing token is < 1e-3; a beam entry's ids may differ only
    where the two runs' best scores are within 1e-3. Tokens/s, the K1
    launches; no per-query plain attention."""
    src = nmt_batch(torch, 8, NMT_ATTENTION[1], NMT_VOCAB)[0]
    plain = [(fa, "flash_attention_fwd", fa._plain_fwd),
             (fa, "flash_attention_bwd", fa._plain_bwd)]
    out = {}
    for name in ("kernel", "plain"):
        counters.reset()
        with swapped(plain if name == "plain" else []):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy = model.greedy_decode(src, max_len=64)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, scores = model.beam_search_decode(src, beam_size=4,
                                                   max_len=64)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        out[name] = {"greedy": greedy, "ids": ids, "scores": scores,
                     "greedy_s": t1 - t0, "beam_s": t2 - t1,
                     "launches": counters.snapshot()}
    k, p = out["kernel"], out["plain"]
    expect(k["launches"].get("flash_attention_fwd", 0) > 0
           and not k["launches"].get("attention_per_query_plain", 0),
           f"nmt_decode: K1 did not launch, or the per-query route ran: "
           f"{k['launches']}")
    expect(not p["launches"].get("flash_attention_fwd", 0),
           f"nmt_decode: the plain run launched K1: {p['launches']}")
    ties, greedy_equal = [], 0
    model.eval()
    with swapped(plain):
        for r in range(src.shape[0]):
            a, b = k["greedy"][r].tolist(), p["greedy"][r].tolist()
            t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if t is None and len(a) == len(b):
                greedy_equal += 1
                continue
            expect(t is not None, "nmt_decode: greedy rows of other lengths")
            gap = nmt_top2_gap(torch, model, src[r], p["greedy"][r][:t])
            expect(gap < 1e-3, f"nmt_decode: greedy row {r} parted at token "
                               f"{t} with a top-2 gap of {gap}")
            ties.append({"row": r, "token": t, "gap": gap})
    model.train()
    beam_equal, beam_ties = 0, []
    for r in range(src.shape[0]):
        if torch.equal(k["ids"][r, 0], p["ids"][r, 0]):
            beam_equal += 1
            continue
        gap = abs(float(k["scores"][r, 0]) - float(p["scores"][r, 0]))
        expect(gap < 1e-3, f"nmt_decode: beam entry {r} parted with best "
                           f"scores {gap} apart")
        beam_ties.append({"row": r, "score_gap": gap})
    n_greedy = int(k["greedy"].shape[1] - 1) * src.shape[0]
    return {"phase": "nmt_decode", "config": "the nmt phase's trained "
            "model, f32 eval, 8 sources of 128 tokens, greedy max_len 64, "
            "beam 4 max_len 64 (length penalty 0.6)",
            "greedy_tokens_per_s": n_greedy / k["greedy_s"],
            "greedy_plain_tokens_per_s": n_greedy / p["greedy_s"],
            "beam_tokens_per_s": 8 * 4 * 63 / k["beam_s"],
            "beam_plain_tokens_per_s": 8 * 4 * 63 / p["beam_s"],
            "greedy_len": int(k["greedy"].shape[1]),
            "greedy_rows_equal": greedy_equal, "greedy_near_ties": ties,
            "beam_best_equal": beam_equal, "beam_near_ties": beam_ties,
            "beam_ids_equal_all": bool(torch.equal(k["ids"], p["ids"])),
            "launches": k["launches"]}


# forms no phase's main path runs, checked in phase 1 only: K2's f16 form
# (at O1 the vocabulary heads take the f32 output of a black-listed norm,
# and no phase trains BERT at O2 fp16), and the main paths train with
# Adam, AdamW and Momentum
PHASE1_ONLY = ("fused_xent_fwd_f16", "fused_xent_bwd_f16", "fused_sgd_master",
               "fused_lamb_master", "fused_adam_f16", "fused_momentum_bf16",
               "fused_momentum_f16", "fused_sgd_bf16", "fused_sgd_f16",
               "fused_lamb_bf16", "fused_lamb_f16")


# ---------------------------------------------------------------------------
# the framework core: the repo's user scripts through the public surface,
# and the op library on the card against the CPU
# ---------------------------------------------------------------------------
def example_text(name):
    """``examples/<name>`` with only its import changed (``paddle_tpu``
    -> ``paddle_tpu_torch``): the card is the default device."""
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", name)
    with open(path) as f:
        src = f.read()
    src = re.sub(r"^import paddle_tpu as paddle$",
                 "import paddle_tpu_torch as paddle", src, flags=re.M)
    return re.sub(r"^from paddle_tpu([ .])", r"from paddle_tpu_torch\1",
                  src, flags=re.M)


def run_example(torch, counters, name, env=None):
    """Run the script's text with the launch counts set to 0 just
    before: (its namespace, its stdout lines, wall s, the launches)."""
    import contextlib
    import io

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out = io.StringIO()
    ns = {"__name__": "__main__"}
    try:
        counters.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            exec(compile(example_text(name), name, "exec"), ns)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters.snapshot()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = out.getvalue().splitlines()
    expect(lines and lines[-1] == "OK", f"{name}: did not print OK "
                                        f"({lines[-3:]})")
    return ns, lines, wall, launches


def per_step(launches, n):
    return {k: v / n for k, v in sorted(launches.items()) if v}


API_TIME_PAIRS = 6


def api_bert_profiled_pairs():
    """In a process of its own (``spawn``): ``train_bert.py``'s step
    through the public surface (``paddle.seed(0)``, BERT-base, AdamW,
    ``TrainStep``, ``to_tensor`` inputs), ``WARM_STEPS`` steps, then a
    step fed the batch as plain torch tensors and one fed it as
    ``Tensor``s profiled in turn until a pair's windows both hold a lead
    spin and the same kernels, copies and fills, name for name, 5 pairs
    at most; then ``API_TIME_PAIRS`` timed pairs of ``TIMED_STEPS``
    steps each, plain and ``Tensor`` inputs alternating which goes
    first: (the last profiled pair's two windows, the pairs profiled,
    what each pair profiled again recorded, each timed pair's median
    step ms). Late in a full run the main process's torch.profiler
    sessions drop kernels and lead spins (``lenet_profiled_pairs``); a
    fresh process records whole windows."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paddle.seed(0)
    cfg = BertConfig.base()
    model = BertForPretraining(cfg)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=model.parameters())

    def loss_fn(m, *b):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(*b)

    step = TrainStep(model, loss_fn, opt)
    rng = np.random.RandomState(0)
    B, S, V = BERT_BATCH, BERT_SEQ, cfg.vocab_size
    wrapped = (paddle.to_tensor(rng.randint(0, V, (B, S)).astype(np.int32)),
               paddle.to_tensor(np.zeros((B, S), np.int32)),
               paddle.to_tensor(rng.randint(0, V, (B, S)).astype(np.int32)),
               paddle.to_tensor(rng.randint(0, 2, (B,)).astype(np.int32)))
    plain = tuple(paddle.unwrap(t) for t in wrapped)
    for _ in range(WARM_STEPS):
        step(*wrapped)
    retried = []
    for pairs in range(1, 6):
        a = step_device_events(torch, step, plain)
        b = step_device_events(torch, step, wrapped)
        if a["lead_spins"] and b["lead_spins"] and all(
                a[k] == b[k] for k in ("kernels", "copies", "fills",
                                       "kernel_names")):
            break
        names, names_b = a["kernel_names"], b["kernel_names"]
        retried.append({
            "counts": [[a[k], b[k]] for k in ("kernels", "copies",
                                               "fills")],
            "lead_spins": [a["lead_spins"], b["lead_spins"]],
            "differ_by": {k[:60]: names.get(k, 0) - names_b.get(k, 0)
                          for k in set(names) | set(names_b)
                          if names.get(k, 0) != names_b.get(k, 0)}})
    timed = []
    for i in range(API_TIME_PAIRS):
        order = ("plain", "tensor") if i % 2 == 0 else ("tensor", "plain")
        row = {"first": order[0]}
        for kind in order:
            batch = plain if kind == "plain" else wrapped
            ms = []
            for _ in range(TIMED_STEPS):
                t0 = time.perf_counter()
                float(step(*batch))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            row[kind + "_ms_median"] = float(np.median(ms))
        timed.append(row)
    return a, b, pairs, retried, timed


def phase_api_bert(torch, counters, bert_row):
    """``examples/train_bert.py`` as a user runs it (BERT-base 128 x 128,
    AMP O1 bf16, AdamW 1e-4, ``jit.TrainStep``, inputs by
    ``paddle.to_tensor`` of int32 arrays, 1 + 50 steps, its own assertion
    that the loss falls), with only its import changed: it must print
    ``device: gpu:0`` and ``OK``, and launch exactly what phase 6 does a
    step (12 K1a, 12 K1b, one K2a + K2b, one K3-adam, and nothing else);
    then 3 + 10 timed steps of its ``TrainStep`` (median step ms beside
    phase 6's) and, in a process of its own
    (``api_bert_profiled_pairs``), a profiled step fed the batch as
    ``Tensor``s against one fed the same tensors plain: the same kernels,
    copies and fills, name for name (the public surface adds no device
    work); and alternated timed pairs of the two, each pair's medians
    and their ratio reported (not held to a bound)."""
    ns, lines, wall, launches = run_example(torch, counters, "train_bert.py")
    expect(lines[0] == "device: gpu:0", f"api_bert: {lines[0]!r}")
    n = 51
    bert_per = per_step(bert_row["launches"], WARM_STEPS + TIMED_STEPS)
    got_per = per_step(launches, n)
    expect(got_per == bert_per, f"api_bert: launches a step {got_per}, "
                                f"phase 6's {bert_per}")
    step = ns["step"]
    wrapped = tuple(ns[k] for k in ("ids", "tt", "mlm", "nsp"))
    paddle = ns["paddle"]
    expect(all(isinstance(t, paddle.Tensor) and t.is_cuda
               for t in wrapped), "api_bert: to_tensor did not give "
                                  "Tensors on the card")
    losses, step_ms, _ = train_steps(torch, counters, step, wrapped)
    med = float(np.median(step_ms))
    loss = step(*wrapped)
    expect(isinstance(loss, paddle.Tensor), "api_bert: the step's loss is "
                                            "not a Tensor")
    del ns, step, wrapped, loss
    gc.collect()
    torch.cuda.empty_cache()
    from paddle_tpu_torch.distributed import spawn

    a, b, tries, retried, timed = spawn(api_bert_profiled_pairs,
                                        timeout=600)[0]
    ratios = [r["tensor_ms_median"] / r["plain_ms_median"] for r in timed]
    expect(a["lead_spins"] and b["lead_spins"] and all(
        a[k] == b[k] for k in ("kernels", "copies", "fills",
                               "kernel_names")),
           f"api_bert: a step fed Tensors ran other device work than one "
           f"fed torch tensors ({tries} pairs: {retried})")
    return {"phase": "api_bert", "config": "examples/train_bert.py: "
            "BERT-base, batch 128 x seq 128, AMP O1 bf16, dropout 0.1, "
            "AdamW lr 1e-4, 1 + 50 steps through the public surface",
            "script_lines": lines, "script_wall_s": wall,
            "launches": launches, "launches_per_step": got_per,
            "bert_launches_per_step": bert_per,
            "step_ms_median": med, "step_ms": step_ms,
            "bert_step_ms_median": bert_row["step_ms_median"],
            "losses_timed": losses,
            "kernels_per_step": b["kernels"],
            "bert_kernels_per_step_plain_inputs": a["kernels"],
            "bert_phase_profiled_kernels":
                bert_row["breakdown"].get("kernels"),
            "copies_per_step": b["copies"], "fills_per_step": b["fills"],
            "profile_pairs": tries, "profile_retried": retried,
            "alternated_pairs": timed,
            "tensor_over_plain_ratios": ratios,
            "tensor_over_plain_median": float(np.median(ratios))}


def phase_api_bert_eager(torch, counters):
    """The same model written eagerly, as a dygraph user writes it:
    ``loss = model.loss(...)`` under ``auto_cast``, ``loss.backward()``,
    ``opt.step()``, ``opt.clear_grad()``, ``float(loss)``, 10 steps at
    dropout 0 from ``paddle.seed(0)``'s weights, with exactly phase 6's
    launches a step; against 3 ``TrainStep`` steps of a model built from
    the same seed on the same batch: the first 3 losses within 1e-5
    relative (both under ``use_deterministic_algorithms``, warn only:
    PyTorch's CUDA embedding backward adds with atomics)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    cfg = BertConfig.base()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    B, S = BERT_BATCH, BERT_SEQ
    rng = np.random.RandomState(0)
    ids = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (B, S))
                           .astype(np.int32))
    tt = paddle.to_tensor(np.zeros((B, S), np.int32))
    mlm = paddle.to_tensor(rng.randint(0, cfg.vocab_size, (B, S))
                           .astype(np.int32))
    nsp = paddle.to_tensor(rng.randint(0, 2, (B,)).astype(np.int32))

    def build():
        paddle.seed(0)
        model = BertForPretraining(cfg)
        return model, optimizer.AdamW(learning_rate=1e-4,
                                      parameters=model.parameters())

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model, opt = build()
        counters.reset()
        eager, ms = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = model.loss(ids, tt, mlm, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = counters.snapshot()
        del model, opt, loss
        torch.cuda.empty_cache()
        model, opt = build()

        def loss_fn(m, *b):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                return m.loss(*b)

        step = TrainStep(model, loss_fn, opt)
        ts = [float(step(ids, tt, mlm, nsp)) for _ in range(3)]
        del model, opt, step
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    L = cfg.num_hidden_layers
    want = {"flash_attention_bwd": L, "flash_attention_fwd": L,
            "fused_adam": 1, "fused_xent_bwd": 1, "fused_xent_fwd": 1}
    got = per_step(launches, 10)
    expect(got == want, f"api_bert_eager: launches a step {got}, want "
                        f"{want}")
    rel = [abs(a - b) / abs(b) for a, b in zip(eager[:3], ts)]
    expect(max(rel) <= 1e-5, f"api_bert_eager: eager losses {eager[:3]} "
                             f"vs TrainStep {ts} (rel {rel})")
    expect(all(np.isfinite(eager)), f"api_bert_eager: non-finite loss "
                                    f"{eager}")
    return {"phase": "api_bert_eager", "config": "phase 6's model at "
            "dropout 0, eager model.loss / backward / step / clear_grad",
            "losses": eager, "trainstep_losses": ts, "rel_diff": rel,
            "launches": launches, "launches_per_step": got,
            "step_ms_median": float(np.median(ms[3:])), "step_ms": ms}


def phase_api_wgan(torch, counters):
    """``examples/train_wgan_gp.py`` at its own size (G 4-32-2, D
    2-32-1, batch 64, 30 steps): a double gradient on the card through
    ``autograd.grad(create_graph=True)``; the script asserts the penalty
    is finite and prints ``OK``; K3-adam (f32) runs twice a step and no
    other kernel runs."""
    ns, lines, wall, launches = run_example(torch, counters,
                                            "train_wgan_gp.py")
    want = {"fused_adam": 2 * 30}
    got = {k: v for k, v in launches.items() if v}
    expect(got == want, f"api_wgan: launches {got}, want {want}")
    expect(np.isfinite(ns["last_gp"]), "api_wgan: gp not finite")
    return {"phase": "api_wgan", "script_lines": lines,
            "script_wall_s": wall, "step_ms_mean": wall / 30 * 1e3,
            "gp_first": ns["first_gp"], "gp_last": ns["last_gp"],
            "launches": got}


def phase_api_nmt(torch, counters):
    """``examples/translate_beam.py`` at its own size (``TransformerNMT``
    d_model 64, 4 heads of width 16, 2 + 2 layers, vocab 20, 300 Adam
    steps of batch 64, then beam 4): beam-copy accuracy above 0.8 (the
    script asserts it); its attention runs the counted plain route
    (``attention_plain``: head width 16, which JAX computes outside
    Pallas too) and no K1 launch; one K2a + K2b and one K3-adam a step.
    Then the route on the card: attention at head width 16 equals the
    same call on the CPU within 1e-5; at head widths 192 and 256 (f32)
    it launches K1a, within 1e-4 of the CPU's plain version."""
    from paddle_tpu_torch.nn import functional as F

    ns, lines, wall, launches = run_example(torch, counters,
                                            "translate_beam.py")
    got = {k: v for k, v in launches.items() if v}
    expect(got.get("attention_plain", 0) > 0,
           f"api_nmt: no plain attention ran ({got})")
    expect(not any(k.startswith("flash_attention") for k in got),
           f"api_nmt: a flash kernel ran at head width 16 ({got})")
    for k in ("fused_xent_fwd", "fused_xent_bwd", "fused_adam"):
        expect(got.get(k) == 300, f"api_nmt: {k} {got.get(k)}, want 300")
    expect(ns["acc"] > 0.8, f"api_nmt: accuracy {ns['acc']}")
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, 4, 16, generator=gen) for _ in range(3))
    counters.reset()
    out = F.scaled_dot_product_attention(q.cuda(), k.cuda(), v.cuda(),
                                         is_causal=True)
    ref = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    err = float((out.cpu() - ref).abs().max())
    expect(err <= 1e-5 and counters.get("attention_plain") == 2,
           f"api_nmt: head width 16 on the card: err {err}, "
           f"{counters.snapshot()}")
    wide = {}
    for d in (192, 256):
        x = torch.randn(1, 128, 2, d, generator=gen)
        counters.reset()
        out = F.scaled_dot_product_attention(x.cuda(), x.cuda(), x.cuda())
        wide[d] = float((out.cpu() - F.scaled_dot_product_attention(
            x, x, x)).abs().max())
        expect(wide[d] <= 1e-4 and counters.get("flash_attention_fwd") == 1
               and counters.get("attention_plain") == 0,
               f"api_nmt: head width {d} on the card: err {wide[d]}, "
               f"{counters.snapshot()}")
    return {"phase": "api_nmt", "script_lines": lines,
            "script_wall_s": wall, "step_ms_mean": wall / 300 * 1e3,
            "accuracy": float(ns["acc"]), "launches": got,
            "head16_max_abs_err_vs_cpu": err,
            "head192_256_max_abs_err_vs_cpu": wide}


def phase_ops_parity(torch):
    """Every case of ``tests/_torch_op_cases.py`` (each op of the op
    library, the v1.8 ``paddle.tensor`` spellings) on CUDA tensors
    against the same case on the CPU, and every method of the method
    table and every operator on a CUDA ``Tensor``: integer, boolean,
    layout and index results bit for bit, float results within the
    case's tolerance (``TOL``: elementwise 1e-6, reductions, special
    functions and linear algebra 1e-5, of the output's largest value;
    ``CARD_TOL``: the eigendecompositions 3e-5, cuSOLVER against
    LAPACK), the gradients the same way; every result a ``Tensor`` on
    the card.
    The random ops by shape, dtype, range and determinism under
    ``paddle.seed``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import math_op_patch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import _torch_op_cases as C

    on_card = []

    def check(out):
        for o in C._leaves(out):
            if isinstance(o, torch.Tensor):
                on_card.append(isinstance(o, paddle.Tensor) and o.is_cuda)

    failures, n_cases, n_grads = [], 0, 0
    t0 = time.perf_counter()
    for case in C.cases():
        try:
            paddle.set_device("cpu")
            want, want_g = C.run(paddle, case)
            paddle.set_device("gpu")
            got, got_g = C.run(paddle, case, check=check)
            rtol = C.CARD_TOL.get(case.name)
            C.assert_close(got, want, case.kind, case.key, rtol)
            if want_g is not None:
                n_grads += 1
                C.assert_close(got_g, want_g, "elem" if case.kind == "exact"
                               else case.kind, case.key + " grad", rtol)
            n_cases += 1
        except Exception as e:
            failures.append(f"{case.key}: {type(e).__name__}: {e}"[:300])
    methods = 0
    by_name = {}
    for case in C.cases():
        by_name.setdefault(case.name, case)
    for m in math_op_patch.METHODS:
        case = by_name[m]
        for dev in ("cpu", "gpu"):
            paddle.set_device(dev)
            rng = np.random.RandomState(0)
            args = [C._inputs(paddle, C.make(a, rng), False)
                    for a in case.args]
            kwargs = {k: C._inputs(paddle, C.make(v, rng), False)
                      for k, v in case.kwargs.items()}
            out = getattr(args[0], m)(*args[1:], **kwargs)
            vals = [C._np(o) for o in C._leaves(out)]
            if dev == "cpu":
                ref = vals
            else:
                check(out)
        try:
            C.assert_close(vals, ref, case.kind, "method " + m,
                           C.CARD_TOL.get(m))
            methods += 1
        except AssertionError as e:
            failures.append(f"method {m}: {e}"[:300])
    ops = 0
    for dunder, (name, _) in math_op_patch.DUNDERS.items():
        vals = []
        for dev in ("cpu", "gpu"):
            paddle.set_device(dev)
            rng = np.random.RandomState(1)
            x = rng.standard_normal((3, 4)).astype(np.float32)
            y = np.abs(rng.standard_normal((3, 4))).astype(np.float32) + .5
            if name == "matmul":
                y = y.T.copy()
            if name.startswith("logical"):
                x, y = x > 0, y > 1
            out = getattr(paddle.to_tensor(x), dunder)(paddle.to_tensor(y))
            if dev == "gpu":
                check(out)
            vals.append([C._np(out)])
        kind = "red" if name == "matmul" else "elem"
        try:
            C.assert_close(vals[1], vals[0], kind, dunder)
            ops += 1
        except AssertionError as e:
            failures.append(f"{dunder}: {e}"[:300])
    rand = {}
    for name, (args, kwargs) in C.RANDOM.items():
        paddle.set_device("gpu")
        fn = paddle.tensor if name in ("standard_normal", "shuffle") \
            else paddle
        draws = []
        for s in (7, 7, 8):
            paddle.seed(s)
            rng = np.random.RandomState(0)
            a = [C._inputs(paddle, C.make(v, rng), False) for v in args]
            out = getattr(fn, name)(*a, **kwargs)
            check(out)
            draws.append(C._np(out))
        ok = np.array_equal(draws[0], draws[1]) and (
            name == "multinomial" or not np.array_equal(draws[0],
                                                        draws[2]))
        rand[name] = {"shape": list(draws[0].shape),
                      "dtype": draws[0].dtype.name, "seeded": bool(ok)}
        if not ok:
            failures.append(f"random {name}: not determined by seed")
    from paddle_tpu_torch._device import set_default_device

    set_default_device(None)
    expect(not failures, f"ops_parity: {len(failures)} failures: "
                         f"{failures[:10]}")
    expect(on_card and all(on_card), f"ops_parity: "
           f"{on_card.count(False)} results not a Tensor on the card")
    return {"phase": "ops_parity", "cases": n_cases,
            "gradients": n_grads, "methods": methods, "operators": ops,
            "random_ops": rand, "results_checked_on_card": len(on_card),
            "seconds": time.perf_counter() - t0}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    expect(smi.returncode == 0, "nvidia-smi failed")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 1 (no timing, no engine)")
    ap.add_argument("--bag-shapes", action="store_true",
                    help="only time K6 at each of BAG_SHAPES")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.inference import decode as dec
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops.cuda import _build, counters
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_embedding as fe
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    from paddle_tpu_torch.ops.cuda import fused_xent as fx
    from paddle_tpu_torch.ops.cuda import paged_attention as pa
    from paddle_tpu_torch.ops.cuda import sampling as samp
    from paddle_tpu_torch.parallel import ring
    from paddle_tpu_torch.vision.models import LeNet, resnet50

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    if args.bag_shapes:   # K6 alone, built at its first call
        emit({"phase": "bag_shapes", "card": card_line(),
              "shapes": bag_shapes(torch, fe)})
        return 0
    try:
        t0 = time.perf_counter()
        logs = _build.build_all(ptxas_verbose=True)
        tc_counts, wide_wg = tensor_core_counts(_build)
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": sorted(logs), "ptxas": logs,
              "tensor_core_instructions": tc_counts,
              "wide_wgmma_kernels": wide_wg})

        timing = not args.kernels_only
        k4a = check_attention(torch, pa, rng, False, timing)
        k4h = check_attention(torch, pa, rng, False, timing, torch.bfloat16)
        k4f = check_attention(torch, pa, rng, False, timing, torch.float16)
        k4b = check_attention(torch, pa, rng, True, timing)
        k5 = check_sampling(torch, samp, rng, timing)
        emit({"phase": "kernels_vs_plain", "paged_attention": k4a,
              "paged_attention_bf16": k4h, "paged_attention_f16": k4f,
              "paged_attention_quant": k4b, "fused_sample": k5})
        # the decode engine before any torch.profiler session: once one
        # has run (phase 1's device timings), the process's host-side
        # launches stay slower, and the engine's tick is its launch loop
        total = {}
        if timing:
            cfg = dec.DecodeModelConfig(**FULL)
            t0 = time.perf_counter()
            params = dec.init_decode_params(cfg, seed=0)
            torch.cuda.synchronize()
            emit({"phase": "init", "seconds": time.perf_counter() - t0,
                  "params": int(sum(p.numel() for p in params.values()))})
            for phase in (phase_int8, phase_f32, phase_sample, phase_2byte,
                          phase_spec, phase_host_tier, phase_adopt,
                          phase_fleet):
                extra = (pa,) if phase is phase_2byte else ()
                row, launches = phase(torch, dec, counters, params, cfg, rng,
                                      *extra)
                torch.cuda.empty_cache()
                emit(row)
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            del params
            torch.cuda.empty_cache()
        k1 = check_flash(torch, fa, timing)
        emit({"phase": "kernels_vs_plain", "flash_attention": k1})
        k1h = check_flash_f16(torch, fa, counters, timing)
        emit({"phase": "kernels_vs_plain", "flash_attention_f16": k1h})
        torch.cuda.empty_cache()
        k2 = check_xent(torch, fx, timing)
        emit({"phase": "kernels_vs_plain", "fused_xent": k2})
        k1s = check_flash_short(torch, fa, timing, tc_counts)
        emit({"phase": "kernels_vs_plain", "flash_attention_short": k1s})
        torch.cuda.empty_cache()
        bert_shapes = [tuple(p.shape) for p in BertForPretraining(
            BertConfig.base()).parameters()]
        k3 = check_adam(torch, fo, counters, bert_shapes, timing)
        emit({"phase": "kernels_vs_plain", "fused_adam": k3})
        shapes = [tuple(p.shape) for p in resnet50().parameters()]
        k3m = check_momentum(torch, fo, counters, shapes, timing)
        emit({"phase": "kernels_vs_plain", "fused_momentum": k3m})
        lenet_shapes = [tuple(p.shape) for p in LeNet().parameters()]
        k3s = check_sgd(torch, fo, counters, {"lenet": lenet_shapes,
                                              "bert_base": bert_shapes},
                        timing)
        emit({"phase": "kernels_vs_plain", "fused_sgd": k3s})
        k3l = check_lamb(torch, fo, counters, bert_shapes, timing)
        emit({"phase": "kernels_vs_plain", "fused_lamb": k3l})
        torch.cuda.empty_cache()
        k2h = check_xent(torch, fx, timing, "bfloat16")
        k2f = check_xent(torch, fx, timing, "float16")
        emit({"phase": "kernels_vs_plain", "fused_xent_bf16": k2h,
              "fused_xent_f16": k2f})
        torch.cuda.empty_cache()
        k3am = check_adam(torch, fo, counters, bert_shapes, timing,
                          "bfloat16")
        k3mm = check_momentum(torch, fo, counters, shapes, timing, "float16")
        k3sm = check_sgd(torch, fo, counters, {"lenet": lenet_shapes},
                         timing, "bfloat16")
        k3lm = check_lamb(torch, fo, counters, bert_shapes, timing,
                          "bfloat16")
        emit({"phase": "kernels_vs_plain", "fused_adam_master": k3am,
              "fused_momentum_master": k3mm, "fused_sgd_master": k3sm,
              "fused_lamb_master": k3lm})
        torch.cuda.empty_cache()
        k3n = check_k3_2byte(torch, fo, counters, bert_shapes, shapes, timing)
        emit({"phase": "kernels_vs_plain", "k3_2byte": k3n})
        torch.cuda.empty_cache()
        static_shapes = static_param_shapes()
        k3st = check_static_optim(torch, fo, counters,
                                  {"static_resnet": static_shapes,
                                   "bert_base": bert_shapes}, timing)
        emit({"phase": "kernels_vs_plain", "static_optim": k3st})
        torch.cuda.empty_cache()
        k6 = check_embedding_bag(torch, fe, timing)
        emit({"phase": "kernels_vs_plain", "fused_embedding_bag": k6})
        torch.cuda.empty_cache()
        k1m = check_flash_masked(torch, fa, timing)
        emit({"phase": "kernels_vs_plain", "flash_attention_masked": k1m})
        torch.cuda.empty_cache()
        k1r = check_flash_ring(torch, fa, ring, timing)
        emit({"phase": "kernels_vs_plain", "flash_ring": k1r})
        torch.cuda.empty_cache()
        k3c = check_chunk_lamb(torch, fo, counters, timing)
        emit({"phase": "kernels_vs_plain", "chunk_lamb": k3c})
        torch.cuda.empty_cache()
        if args.kernels_only:
            return 0


        def add(launches):
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v

        emit(phase_bert_parity(torch, counters, fa, fx, fo))
        torch.cuda.empty_cache()
        o1_row, launches = phase_bert(torch, counters)
        emit(o1_row)
        add(launches)
        torch.cuda.empty_cache()
        for row in (phase_api_bert(torch, counters, o1_row),
                    phase_api_bert_eager(torch, counters)):
            emit(row)
            add(row["launches"])
            gc.collect()
            torch.cuda.empty_cache()
        row, launches = phase_bert_recompute(torch, counters, o1_row)
        emit(row)
        add(launches)
        torch.cuda.empty_cache()
        emit(phase_bert_o2_parity(torch, counters, fa, fx, fo))
        torch.cuda.empty_cache()
        row, launches = phase_bert_o2(torch, counters, o1_row)
        emit(row)
        add(launches)
        del launches, o1_row
        torch.cuda.empty_cache()
        row, launches = phase_bert_o2_pure(torch, counters, fa, fx, fo, row)
        emit(row)
        add(launches)
        del row, launches
        torch.cuda.empty_cache()

        emit(phase_resnet_parity(torch, counters, fo))
        torch.cuda.empty_cache()
        o1_row, launches = phase_resnet50(torch, counters)
        emit(o1_row)
        add(launches)
        del launches
        torch.cuda.empty_cache()
        row, launches = phase_resnet50_lars(torch, counters, o1_row)
        emit(row)
        add(launches)
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_resnet50_fp16(torch, counters, o1_row)
        emit(row)
        add(launches)
        del row, launches, o1_row
        torch.cuda.empty_cache()

        # BERT-base's widths at 3 of its 12 layers: the CPU side of this
        # check took 100 s of the run at 12
        rule_shapes = [tuple(p.shape) for p in BertForPretraining(
            BertConfig(num_hidden_layers=3)).parameters()]
        emit(phase_optimizer_rules_parity(torch, counters, rule_shapes))
        gc.collect()
        torch.cuda.empty_cache()

        emit(phase_bert_lamb_parity(torch, counters, fa, fx, fo))
        torch.cuda.empty_cache()
        row, launches = phase_bert512_lamb(torch, counters)
        emit(row)
        add(launches)
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_bert512_lamb(torch, counters, dtype="float16")
        emit(row)
        add(launches)
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_bert512_lamb(torch, counters, heads=4)
        emit(row)
        for k in ("flash_attention_short_fwd", "flash_attention_short_bwd"):
            total[k + "_d192"] = launches.get(k, 0)
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_lenet_sgd(torch, counters)
        emit(row)
        add(launches)
        total["fused_lamb"] = total.get("fused_lamb_phase1", 0) \
            + total.get("fused_lamb_apply", 0)
        torch.cuda.empty_cache()

        emit(phase_static_parity(torch, counters, fo))
        blob = tempfile.mkdtemp(prefix="chip_smoke_blob_")
        try:
            for form, steps in (("momentum", STATIC_STEPS), ("adam", 13),
                                ("lamb", 13), ("sgd", 13)):
                row, launches = phase_static_resnet(
                    torch, counters, form, steps,
                    inference=form == "momentum",
                    save_to=blob if form == "momentum" else None)
                emit(row)
                add(launches)
            torch.cuda.empty_cache()
            emit(phase_serving(torch, blob))
        finally:
            shutil.rmtree(blob, ignore_errors=True)
        total["static_lamb"] = total.get("static_lamb_phase1", 0) \
            + total.get("static_lamb_apply", 0)
        torch.cuda.empty_cache()

        emit(phase_bag_parity(torch, counters, fe))
        row, launches = phase_embedding_bag(torch, counters)
        emit(row)
        total["fused_embedding_bag"] = launches.get("fused_embedding_bag", 0)
        del row, launches
        emit(phase_bert_parity(torch, counters, fa, fx, fo, masked=True))
        row, launches = phase_bert512_lamb(torch, counters, fa, masked=True)
        emit(row)
        for k in ("flash_attention_masked_fwd", "flash_attention_masked_bwd"):
            total[k] = launches.get(k, 0)
        del row, launches
        torch.cuda.empty_cache()

        emit(phase_gpt_sp_parity(torch, counters))
        torch.cuda.empty_cache()
        row, launches = phase_gpt(torch, counters)
        emit(row)
        gpt_params = row["params"]
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_gpt(torch, counters, heads=3)
        emit(row)
        expect(row["params"] == gpt_params,
               f"gpt_d256: {row['params']} parameters, gpt {gpt_params}")
        for k in ("flash_attention_fwd", "flash_attention_bwd"):
            total[k + "_d256"] = launches.get(k, 0)
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_gpt_sp(torch, counters)
        emit(row)
        total["flash_attention_ext_bwd"] = launches.get(
            "flash_attention_ext_bwd", 0)
        del row, launches
        torch.cuda.empty_cache()
        row, launches = phase_gpt_sp(torch, counters, dtype="float16")
        emit(row)
        for k in ("flash_attention_fwd_f16", "flash_attention_ext_bwd_f16"):
            total[k] = total.get(k, 0) + launches.get(k, 0)
        del row, launches
        torch.cuda.empty_cache()

        emit(phase_static_zero_parity(torch, counters))
        row, launches = phase_static_zero(torch, counters)
        emit(row)
        total["chunk_lamb"] = launches.get("chunk_lamb_phase1", 0) \
            + launches.get("chunk_lamb_apply", 0)
        del row, launches
        torch.cuda.empty_cache()

        emit(phase_nmt_parity(torch, counters, fa, fx, fo))
        o1_row, launches, nmt_model = phase_nmt(torch, counters)
        emit(o1_row)
        add(launches)
        emit(phase_nmt_decode(torch, counters, fa, nmt_model))
        del nmt_model, launches
        torch.cuda.empty_cache()
        row, launches = phase_nmt_fp16(torch, counters, o1_row)
        emit(row)
        add(launches)
        del row, launches, o1_row
        torch.cuda.empty_cache()
        for phase in (phase_api_wgan, phase_api_nmt):
            row = phase(torch, counters)
            emit(row)
            add(row["launches"])
            gc.collect()
            torch.cuda.empty_cache()
        emit(phase_ops_parity(torch))
        torch.cuda.empty_cache()

        def split(k, part):
            """the forward (a) or backward (b) half of a K1/K2 row; the
            library time is the same half (the backward one replays a
            retained autograd graph)"""
            lib = k[part + "_library_ms"]
            return {"max_abs_err": k[part + "_max_abs_err"],
                    "ms": k[part + "_ms"], "plain_ms": k[part + "_plain_ms"],
                    "bound_ms": k[part + "_bound_ms"],
                    "bound_by": k[part + "_bound_by"], "library_ms": lib}

        src = "paddle_tpu_torch/ops/cuda/csrc/"
        kernels = []
        for name, row, source, replaces in (
                ("paged_attention", k4a, src + "paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:150"),
                ("paged_attention_bf16", k4h, src + "paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:150"),
                ("paged_attention_f16", k4f, src + "paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:150"),
                ("paged_attention_quant", k4b, src + "paged_attention.cu",
                 "paddle_tpu/ops/pallas/paged_attention.py:241"),
                ("fused_sample", k5, src + "sampling.cu",
                 "paddle_tpu/ops/pallas/sampling.py:85"),
                ("flash_attention_fwd", split(k1, "fwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:284"),
                ("flash_attention_bwd", split(k1, "bwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:339"),
                ("flash_attention_fwd_f16", split(k1h, "fwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:284"),
                ("flash_attention_bwd_f16", split(k1h, "bwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:339"),
                ("fused_xent_fwd", split(k2, "fwd"), src + "fused_xent.cu",
                 "paddle_tpu/ops/pallas/fused_xent.py:185"),
                ("fused_xent_bwd", split(k2, "bwd"), src + "fused_xent.cu",
                 "paddle_tpu/ops/pallas/fused_xent.py:216"),
                ("fused_adam", k3, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("fused_momentum", k3m, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("flash_attention_short_fwd", split(k1s, "fwd"),
                 src + "flash_short.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:611"),
                ("flash_attention_short_bwd", split(k1s, "bwd"),
                 src + "flash_short.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:638"),
                ("fused_sgd", k3s, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("fused_lamb", k3l, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("static_sgd", k3st["sgd"], src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:175"),
                ("static_momentum", k3st["momentum"],
                 src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:182"),
                ("static_adam", k3st["adam"], src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:196"),
                ("static_lamb", k3st["lamb"], src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:217"),
                ("fused_embedding_bag", k6, src + "fused_embedding.cu",
                 "paddle_tpu/ops/pallas/fused_embedding.py:86"),
                ("flash_attention_masked_fwd", split(k1m, "fwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:284"),
                ("flash_attention_masked_bwd", split(k1m, "bwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:339"),
                ("flash_attention_ext_bwd", k1r, src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:339"),
                ("flash_attention_short_fwd_f16", split(k1s["short_f16"],
                                                        "fwd"),
                 src + "flash_short.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:611"),
                ("flash_attention_short_bwd_f16", split(k1s["short_f16"],
                                                        "bwd"),
                 src + "flash_short.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:638"),
                ("flash_attention_ext_bwd_f16", k1r["f16"],
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:339"),
                ("chunk_lamb", k3c, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:455"),
                # head widths 256 (gpt_d256) and 192 (bert512_d192): the
                # same entry points, counted under the same names
                ("flash_attention_fwd_d256", wide_kernel_row(
                    k1["wide"]["bf16_D256_causal_L1024"], "fwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:284"),
                ("flash_attention_bwd_d256", wide_kernel_row(
                    k1["wide"]["bf16_D256_causal_L1024"], "bwd"),
                 src + "flash_attention.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:339"),
                ("flash_attention_short_fwd_d192", wide_kernel_row(
                    k1s["wide"]["bf16_D192_L512"], "fwd"),
                 src + "flash_short.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:611"),
                ("flash_attention_short_bwd_d192", wide_kernel_row(
                    k1s["wide"]["bf16_D192_L512"], "bwd"),
                 src + "flash_short.cu",
                 "paddle_tpu/ops/pallas/flash_attention.py:638"),
                ("fused_xent_fwd_bf16", split(k2h, "fwd"),
                 src + "fused_xent.cu",
                 "paddle_tpu/ops/pallas/fused_xent.py:185"),
                ("fused_xent_bwd_bf16", split(k2h, "bwd"),
                 src + "fused_xent.cu",
                 "paddle_tpu/ops/pallas/fused_xent.py:216"),
                ("fused_xent_fwd_f16", split(k2f, "fwd"),
                 src + "fused_xent.cu",
                 "paddle_tpu/ops/pallas/fused_xent.py:185"),
                ("fused_xent_bwd_f16", split(k2f, "bwd"),
                 src + "fused_xent.cu",
                 "paddle_tpu/ops/pallas/fused_xent.py:216"),
                ("fused_adam_master", k3am, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("fused_momentum_master", k3mm, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("fused_sgd_master", k3sm, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                ("fused_lamb_master", k3lm, src + "fused_optimizer.cu",
                 "paddle_tpu/ops/pallas/fused_optimizer.py:267"),
                *[(f"fused_{rule}_{t}", k3n[f"fused_{rule}_{t}"],
                   src + "fused_optimizer.cu",
                   # no TPU kernel: JAX's XLA route for non-f32 updates
                   "paddle_tpu/ops/pallas/fused_optimizer.py:305")
                  for rule in ("adam", "momentum", "sgd", "lamb")
                  for t in ("bf16", "f16")]):
            on_path = name not in PHASE1_ONLY
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": total.get(name, 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "main_path": on_path})
            expect(not on_path or total.get(name, 0) > 0,
                   f"{name} was not launched on the main path")
        emit({"kernels": kernels})
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1

    print(card_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
