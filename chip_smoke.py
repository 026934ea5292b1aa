#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA package (``repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU, the
CUDA toolkit (``nvcc``) and PyTorch built for CUDA::

    python3 chip_smoke.py [--seed 0] [--ticks 5] [--f32-layers 4]
                          [--replaced DIR] [--serve ARCH ...] [--shard]
                          [--gmm-backward]

What it does, in phases (one JSON line each; any failure raises and the
process exits non-zero):

1. ``env``      torch / CUDA / nvcc versions, the GPU's name and power limit.
2. ``build``    compiles every CUDA kernel of the package from ``csrc/``,
                one ``nvcc`` per source, all started together.
3. ``kernels``  holds each kernel against its plain PyTorch version on the
                GPU: the Eq. 5 gate kernel (``torch.equal`` on the int8 gate
                bits: tolerance 0) at the full-incident shape and on corner
                batches (NaN, -0.0, ±inf and subnormal values, counts and
                masks; W 1; R 1, 31 and one pass and one tile of its plan
                ± 1 row; an all-padded window; F 2, 9, 14, 16, 64, 257 and
                514; unaligned views at F 14 and 514), through both of its
                paths (vector and scalar, the scalar one with several
                column chunks), timed at the full incident; flash attention (K2)
                and decode attention (K3) at
                the serving path's shapes and corners (ragged lengths, n_rep
                1 and 16, head_dim 64 and 128, Sq 1, 17 and 129 at the
                bf16 kernel's 128-row tiles; for K3 cache_len at 0, at and
                one past every split edge of the bf16 kernel's plan and the
                last position, n_rep 1, 2, 16 and 32, caches off the
                64-position tile) in bfloat16 and float32, with the JAX
                package's kernel-test tolerances (2e-2 and 2e-5, rtol = atol:
                sums in another order, and bf16 keeps 8 bits); K2 and K3 are
                timed at the serving path's shapes (glm4-9b's and
                granite-moe-1b-a400m's prefill and last decode step) beside
                their plain versions and ``scaled_dot_product_attention``;
                and at the head layouts of the families served in phase 7
                and 9 (head_dim 128 at n_rep 6, 4 and 1; internvl2's
                2048-position prefill; K3 at n_rep 6, a partial 16-row head
                group, at the split edges of the serving cache and of
                internvl2's 2088-position one); the MoE
                grouped matmul (K5: 3e-2 / 1e-4, the reference's tolerances
                for it) at granite-moe-1b-a400m's prefill and decode shapes
                and corners (empty experts, one row, one expert holding 5x
                the mean, row counts and widths off the tiles, groups of
                exactly one tile, boundaries inside tiles, fewer rows than
                a tile, one expert, both tile heights forced; olmoe-1b-7b's
                64 experts at its prefill and at a decode step's 64 slots,
                64 groups of 0 or 1 rows; jamba-v0.1-52b's 14336 → 4096
                down projection) and the SSD
                intra-chunk kernel (K4: 2e-2 / 2e-5; the float32 kernel
                against a float64 plain version) at mamba2-130m's prefill
                shape and corners (G > 1, one chunk, one chunk of 12 and of
                100 steps that ``ssd_chunked_cuda`` pads to 16-step tiles,
                an initial state, N 16, shapes whose bf16 blocks take 1, 2
                or 3 heads of a G > 1 group, at N 16, Q 64 and in a
                ragged second wave, and jamba's prefill: 128 heads, N 16),
                also through ``ssd_chunked_cuda``;
                K5 (prefill gate/up and down, decode, a training step's
                gate/up) and K4 (its float32 ``y``, as served) are timed
                at the serving shapes (and K2 / K3 at seamless-m4t-medium's
                and at the served families' prefill and last step, K5 at
                olmoe's and jamba's, K4 at jamba's, and K2 at granite's
                training shapes)
                beside their plain versions and, for K5,
                ``torch._grouped_mm``.  K5's backward kernels (``dX``,
                ``dW``) at granite's training launches (32 768 rows over
                32 experts, gate/up and down): uniform and skewed routing
                (empty experts), rows off 64, one expert holding every
                row, zero rows, each input's gradient alone; their
                launches, no host sync inside ``torch.autograd.grad``
                (``set_sync_debug_mode("error")``), ``GMM_BWD_TOL`` of the
                plain forms, an empty expert's ``dW`` exactly zero; each
                kernel timed beside its bound, the plain backward and
                ``torch._grouped_mm``'s backward (alone:
                ``--gmm-backward``).  With ``--replaced DIR`` (a
                ``csrc`` holding the K1, K2, K3, K4 and K5 bodies this
                version replaced, e.g. the parent commit's) those that
                differ from the current ones are built too, held against
                the current kernels and timed in the same turns
                (``replaced_ms``; null without the option or for a body
                that did not change).  Then K2, K4 and K5 at
                ``shard_path``'s sharded shapes (one participant's heads,
                rows and experts), and K2, K3 and K5 at
                ``shard_serve_path``'s (K2 over the prefills' local
                heads, K3 over granite's local cache at its split edges
                and last step, K5 over granite's local experts' share of a
                prefill's and of a step's slots), held the same way and
                timed beside their library calls; the same for the
                fully-seq cases (batch 1 x 512: K2 over granite's (4, 1)
                and glm4's (2, 2) local heads, K3's statistics form over
                granite's 262-position block with ``cache_len`` -1, 0,
                its middle and its last, K4 over mamba2's (2, 2) heads,
                K5 over all 32 of granite's experts); the same for the
                encoder-decoder's sharded shapes (seamless on (1, 4): K2
                at the encoder ``[8,256,4,64]`` non-causal, the decoder's
                self ``[8,1024,4,64]`` and cross ``[8,1024→256,4,64]``, K3
                over the self ``[8,1048,4,64]`` and cross ``[8,256,4,64]``
                caches) and ``uneven_path``'s (K4 ``[2,512,2,64]``, a
                participant's 96 channels at offset 32 of its two head
                slots, the others zero: their ``y`` and state exactly
                zero), each timed beside its plain version and SDPA; the
                same for the fully-seq encoder-decoder (seamless on (4,
                1), batch 1: K2 at the encoder ``[1,256,16,64]``, the
                decoder's self ``[1,512,16,64]`` and cross
                ``[1,512→256,16,64]``, K3's statistics form over a self
                block ``[1,262,16,64]`` and a cross block
                ``[1,64,16,64]``) and for jamba's fully-seq cases (K2
                ``[1,512,32,128]`` over 8 kv heads and, on (2, 2),
                ``[1,512,16,128]`` over 4; K3's statistics form over rank
                0's block of the (2, 1) cache ``[1,262144,8,128]``, 32
                heads, at the last step's position and its corners; K4
                over 128 and 64 SSD heads, N 16; K5 over 16 and 8 of its
                experts at a prefill's 1024 and a step's 2 slots), each
                timed beside its plain version and SDPA or
                ``torch._grouped_mm``.  K3's statistics
                form at the JAX package's ``long_500k`` decode (jamba's
                attention width, q ``[1, 32, 128]`` over a 524 288 x 8 x
                128 bf16 cache drawn N(0, 1), cut into 4 blocks of
                131 072, the token in block 2): each block's ``(o, m,
                l)`` against its plain version, the four combined by
                ``combine_blocks`` against the default K3 over the whole
                cache (2e-2), block 3 giving ``m = -1e30``, ``l = 0``,
                ``o = 0``; one full block's launch timed beside its plain
                version and SDPA, with its bound.
4. ``main_path`` drives the per-tick fleet diagnosis sweep through its user
                entry points — ``StepDelta`` bytes into a ``FleetAggregator``
                (default retention, ``attribution=True``), then driven ticks of
                ``Diagnosis.fleet(..., forecaster=...).tick`` — at a fleet of
                64 live stage windows x 16384 rows, and checks every tick's
                causes against a second run of the same package with the
                numpy gate oracle and everything else on the CPU.  Launch
                counters are zeroed just before and read just after.
5. the gate kernel at the main path's own last packed batch: compare, then
   time kernel, plain version and (``--replaced``) the body it replaced,
   beside the bound counted over what the function needs (``gate_bound``).
6. ``diagnosis_stack`` drives the rest of the diagnosis stack on the GPU
                through ``repro_torch.anomaly`` (wire telemetry, simulated
                transport, star and tree aggregation, ``analyze_fleet`` with
                K1, the policy engine): the six library scenarios and the
                two pinned episode exports, each byte for byte against the
                JAX package's golden under ``tests/golden/``, K1's launches
                counted (zeroed before and read after each run) and required
                in every run that confirms a cause through the gates;
                ``hot_host_cpu`` scaled to 1024 hosts on 32 racks, K1
                against the numpy gate oracle byte for byte and the incident
                host's causes against the 16-host golden's; the closed-loop
                mitigation A/B (``ab_compare``) as
                ``examples/fault_tolerance_demo.py`` asserts it, equal to the
                same call on the host; and the forecaster trained on the
                card (400 Adam steps) through the value gate of the JAX
                package's ``tests/test_forecast.py``, with its largest
                parameter difference from the same training on the host.
7. ``serve_path``, once for each of glm4-9b (dense GQA: K2, K3),
                granite-moe-1b-a400m (GQA + MoE: K2, K3, K5), mamba2-130m
                (SSM: K4), jamba-v0.1-52b (hybrid: K2, K3, K4 and K5 in
                one model; cut to 8 of its 32 layers, one period of its
                pattern), codeqwen1.5-7b (MHA with qkv bias),
                granite-3-8b (tied embeddings), granite-8b (dense GQA) and
                olmoe-1b-7b (MHA + 64 experts top-8: K2, K3, K5),
                each at full width and (jamba but) full depth (random
                weights from a seeded generator, float32 parameters cast
                leaf by leaf to the bfloat16 the engine serves, drawn again
                for the float32 reference once the engine is gone),
                through ``ServeEngine`` with streaming telemetry and
                ``Diagnosis.local``: 8 requests x 1024 prompt tokens, 32
                greedy new tokens each.  Launch counters are zeroed just
                before the run and read after every call: K2 once per
                attention layer of the prefill, K3 once per attention layer
                of every decode step, K4 once per SSM layer of the prefill
                (none in decode: the recurrent step is plain), K5 three
                times per MoE layer of the prefill and of every step.  The
                same prompts then go through the reference's plain forms
                (dense attention, ragged MoE, chunked SSD) teacher-forced
                with the run's tokens and, through ``moe.routing_hook``,
                its routing (slots whose expert moved counted and limited,
                and past the limit in the control): in bf16, where
                the kernel path must lie within a limit of them that a
                lower-precision control exceeds, and in float32, the model
                both are held to.  A float32 variant cut to
                ``--f32-layers`` layers (full width; whole periods of the
                pattern, so 8 for jamba) must give the greedy tokens of the
                plain forms with float64 activations (teacher-forced, the
                weights cast per use).

8. ``train_path``, once for each of granite-moe-1b-a400m (8 x 512 tokens a
                step: K2, K5) and mamba2-130m (8 x 1024: K4), at full width and
                depth through ``launch.train.run`` (the user's entry point:
                seeded float32 weights, bf16 compute, ``remat``, AdamW, the
                data pipeline, an async checkpoint every 4 steps, live
                diagnosis every step): 8 steps, each step's kernel launches
                asserted (K2 once per attention layer, K4 once per SSM
                layer, K5 three times per MoE layer, all twice under remat:
                the forward and each block's recompute), K1 launched in the
                live ticks (in the tick of step 3 at least, a straggler
                made by holding the host before it), the last checkpoint restored byte for byte
                against the parameters it was saved from, step time by CUDA
                events with its forward / backward / optimizer parts, one
                more step profiled for the device's idle share, and K5's
                backward kernels counted (``BACKWARD_LAUNCHES``: dX and dW
                for each grouped product, 144 a granite step).  Then the
                gradients of the kernel path (the kernels forward; K5's
                backward kernels, K2's and K4's plain versions' autograd
                backward) against the reference's
                plain forms on the run's first batch and initial
                parameters, the routing replayed (``TrainRouting``, which
                also checks that every recompute routes as its forward):
                float32 cut to ``--f32-layers`` (loss, every leaf) and bf16
                at full depth (loss, global norm, worst leaf), each limit
                with a control that must exceed it; and each kernel's
                forward and backward at its training shape, launched twice
                to check it is deterministic.
9. ``encdec_path``: seamless-m4t-medium (12 + 12 layers, d 1024, 16 heads
                over 16 kv heads, head_dim 64, vocab 256206; ~0.98 B
                parameters) at full size.  Serving through
                ``Model.init_cache`` / ``prefill`` / ``decode``: 8 requests
                of 256 frame embeddings and a 1024-token decoder prompt, 32
                greedy new tokens; every call's launches asserted (K2 once
                per encoder layer in ``init_cache``, twice per decoder layer
                in the prefill: self and cross; K3 twice per decoder layer
                in a step: the self and the cross cache); the bf16 logits
                held to the plain forms as ``serve_path`` holds them, and a
                float32 variant cut to ``--f32-layers`` (encoder and
                decoder) to the plain forms with float64 activations.  Then
                ``train_path``'s run and checks at 8 x 512 decoder tokens
                and 128 frames (K2 72 times a step: 36 forward, 36
                recompute).  The new kernel shapes are among the K2 / K3
                corners of phase 3 (``Sq != Sk`` non-causal, n_rep 1 at
                head_dim 64, the cross cache's ``cache_len``) and timed there.
                ``vlm_path``: internvl2-26b's backbone (d 6144, 48 heads over
                8, d_ff 16384, vocab 92553) cut to 8 of its 48 layers,
                served the same way through ``Model`` with 1024 seeded patch
                embeddings ahead of each 1024-token prompt (K2 once per
                layer of the 2048-position prefill, K3 once per layer of a
                step over a 2088-position cache) and held to the same
                rules.
10. ``ep_path``: granite-moe-1b-a400m with ``moe_impl="ep"`` on a (data 1,
                model 4) mesh of virtual shards: its 8 x 1024 prefill
                through ``Model.prefill`` (K5 three times per shard per MoE
                layer, K2 once per layer), its logits against the same ep
                function with K5's plain version (routing replayed) within
                granite's bf16 limit, the kept and dropped slots of both
                runs equal, the dropped share and the distance to the
                token-sorted MoE reported; a decode step raises, as the
                reference asserts (S = 1 is not a multiple of 4); K5 timed
                at one shard's rows.
11. ``parallel``: the int8 all-reduce over 4 shards of granite's ``embed``
                leaf against the mean of their dequantized values, and the
                pipeline over 4 stages against the sequential composition.
12. ``dist_path``: the rank form of phases 10 and 11, one shard a
                ``torch.distributed`` rank: 4 spawned rank processes on the
                one card (gloo over a file store, CUDA tensors staged
                through pinned host buffers; one card cannot host several
                NCCL ranks), a (data 1, model 4) mesh.  Each rank draws
                granite-moe-1b-a400m's parameters on the card from the
                seed, prefills the serving batch with ``moe_impl="ep"``
                (K2 24 and K5 72 launches counted in the rank), and runs
                its part of the int8 all-reduce and the pipeline; the
                parent holds every rank's logits, kept slots, ``MoeAux``,
                observed collectives (kind and one participant's bytes),
                all-reduce (hashes of the mean and the gathered payloads
                and scales) and pipeline output byte for byte against the
                list form of phases 10 and 11, and a decode step must
                raise on every rank.  A rank that raises fails the run;
                every rank is joined within 600 s, then killed.
13. ``shard_path``: the sharded train step (``make_train_step`` with the
                mesh's shards and ``state_shardings``), one participant a
                rank process, 4 on the one card as in ``dist_path``:
                granite-moe-1b-a400m on (data 1, model 4) at 4 layers
                (kv heads and experts sharded: K2 and K5), glm4-9b on
                (1, 4) at 2 layers (kv heads replicated, n_rep 8: K2) and
                mamba2-130m on (2, 2) at 8 layers with ZeRO-1 (12 SSD heads a
                participant, ``inner_norm`` summed over the model axis:
                K4) and seamless-m4t-medium on (1, 4) at 4 + 4 layers, 4 x
                512 + 128 frames (the encoder-decoder: K2 over 4 heads, its
                float32 control the encoder's output outside the model
                region, since it has no partial leaf there), bf16,
                ``remat``, 3 steps each from seeded parameters
                and ``launch.train``'s batches.  Per rank and case: K2,
                K4 and K5's exact launches a step; float32 at 4 layers (2
                for glm4), the routing of rank 0's unsharded run replayed:
                the loss and every gathered gradient leaf against the
                unsharded step (``train_path``'s float32 limits), and the
                control (no sum over ``"model"`` of the partial
                gradients) past the leaf limit; bf16 step 1's loss and
                gradient norm against the unsharded bf16 step (the
                ``grad_bf16`` limits); under ZeRO-1 the moments' slices
                equal to those of the same step without it and the
                parameters within the float32 leaf limit; every block of
                every leaf the same bits on each rank holding it
                (checksums) after each step.  Printed, not limited: step
                ms per rank, spawn-to-ready seconds, peak GB per rank,
                collectives per rank and step.  The kernels are held
                against their plain versions at these shapes (and timed)
                in ``kernels``.  Then expert parallelism inside the
                sharded step (``EP_KEY``): granite-moe-1b-a400m with
                ``moe_impl="ep"`` on (2, 2) at 4 layers, 8 x 512, 3 bf16
                steps, each participant routing its sequence block of its
                rows and running K5 three times a layer over the 10 240
                rows it receives for its 16 experts; float32 at 2 layers
                against rank 0's unsharded ep step over the same mesh
                (the list form; each participant replays its shard's
                router calls), with three controls past the leaf limit
                (the partial leaves unsummed, the entry's backward
                keeping the participant's own block of ``dx``, the aux
                terms' gradient whole on every model participant); bf16
                step 1 against the unsharded bf16 ep step at granite's
                ``grad_bf16`` limits.  Then ``compress=True`` on the three-axis
                mesh ``("pod", "data", "model")`` (2, 1, 2):
                olmoe-1b-7b at 1 layer (K2 over 8 of 16 heads, K5 over 32
                of 64 experts), 4 x 512, 3 bf16 steps; in every step on
                every rank the sharded ``ef_compress`` of the step's
                gradient block byte-equal to ``ef_compress`` of the
                gradient and residual gathered for the check, cut to the
                block, and the scales taken per shard (no max over
                ``"model"``) breaking it on leaves whose int8 blocks
                straddle the model cut (the ``head``'s) and nowhere else;
                float32 at 1 layer, rank 0's unsharded compressed steps
                (routing recorded and replayed on each rank's rows):
                step 1's loss within ``grad_f32``'s limit, every loss
                within 1e-5, and after the third step the gathered
                parameters, moments and residual within 1e-5 of each
                leaf's scale on at least 99 % of the elements.  Then the
                collective count (its own line): every rank's record of
                one train step of each case above and of the prefill and
                first decode step of each ``shard_serve_path`` case
                (kind, order, operand bytes) equal to the same call run
                on ``meta`` over ``MetaShards`` at the rank's coordinate
                (each rank runs its own, in parallel), the dry run's count.
                ``shard_serve_path`` (in the same 4 rank processes, its
                own line): sharded prefill and decode through
                ``Model.init_cache`` / ``prefill`` / ``decode`` with
                ``shards=``, bf16, 8 x 1024 prompts, 16 teacher-forced
                steps, a 1048-position cache: granite-moe-1b-a400m on
                (1, 4) at 4 layers (head-sharded cache: K2, K3, K5),
                glm4-9b on (1, 4) at 2 layers (hd-sharded: K2; K3 never
                launches), mamba2-130m on (2, 2) at 8 layers (K4),
                seamless-m4t-medium on (1, 4) at 4 + 4 layers with 256
                frames (``init_cache`` encodes its rows: K2 once per
                encoder layer; K2 twice per decoder layer of a prefill, K3
                twice per decoder layer of a step; its control every
                participant's cross K/V projected from participant 0's
                kv heads, a cache built and prefilled under it).  Per
                rank and case: every call's launches exact (K5 three times
                per MoE layer whose local slots are not none); float32 at
                4 / 2 / 4 layers against rank 0's unsharded run (its
                greedy tokens fed to both, its routing replayed): every
                call's gathered logits and the gathered cache after the
                prefill and after the last step within 1e-4 relative RMS,
                tokens equal, and the first step under a control past
                that limit (granite: K3
                read with an exclusive mask; glm4: the partial scores not
                summed over ``"model"``; mamba2: ``inner_norm`` per block
                in the recurrent step); bf16 against rank 0's unsharded
                bf16 run within ``serve_path``'s limit, routing ``moved``
                within 3 %; the same logits and ``conv_bc`` bits on every
                model participant of a data group; a full cache raises
                ``IndexError`` on every rank.  The ep prefill
                (``EP_KEY``, prefill only): granite-moe with
                ``moe_impl="ep"`` on (2, 2) at 4 layers (float32 at 2),
                8 x 1024, 20 480 received rows a participant's K5 launch;
                logits (and in float32 the gathered cache) against rank
                0's unsharded ep prefill, its control every block of the
                layer's output the participant's own; its decode step
                raises ``ValueError`` on every rank before any
                collective, as the reference's ``shard_map`` asserts.
                Then the fully-seq cache
                layout (a batch that does not divide over the data axes:
                every rank takes every row, its cache block is a block of
                the positions), batch 1 x 512 prompt, 16 steps into the
                same cache (on dp 4 blocks of 262: the steps cross into
                rank 2's block at 524, rank 3's holds no valid position):
                granite-moe on (4, 1) at 4 layers (whole heads: K2, K3's
                statistics form on every rank's block, the blocks'
                softmax combined across dp, K5 over all 32 experts),
                glm4-9b on (2, 2) at 2 layers (``head_dim`` blocks of the
                positions: K2; K3 never), mamba2 on (2, 2) at 4 layers
                (its batch whole, K4); float32 at 4 / 2 / 4 layers with
                the controls: the block's ``cache_len`` not offset by its
                start (granite), the blocks averaged with equal weights
                (glm4), ``inner_norm`` per block (mamba2); bf16 within
                ``serve_path``'s limits; the same bits on all four ranks;
                a full cache (granite, prefilled to 1040 positions)
                raises ``IndexError`` on every rank.  The fully-seq
                encoder-decoder: seamless at 4 + 4 layers, batch 1 x 512
                and 256 frames, on (4, 1) (``"seq"``: the self cache's
                positions and the cross cache's encoder positions split
                over dp, K3's statistics form over both blocks) and on
                (2, 2) (``"seq_hd"``: K3 never), float32 with two
                controls each (the layout's, and the cross cache cut at
                encoder position 0 on every rank, a control of the
                cache).  jamba-v0.1-52b at 8 layers, every width whole,
                batch 1 x 512 into the ``long_500k`` cell's 524 288
                positions, bf16 only, on (2, 2) (``"seq_hd"``, the
                production layout of that cell: K3 never, K5 over 8
                experts, K4 over 64 of 128 SSD heads) here and on (2, 1)
                (``"seq"``, K3's statistics form on rank 0's block of
                262 144 positions and on rank 1's empty one, K5 over all
                16 experts) in ``long_path`` below; each rank builds its
                block leaf by leaf from the seeded generator, in turns
                (``seeded_block``, ``build_in_turns``: one whole float32
                leaf on the card at a time), after rank 0's unsharded
                bf16 run has been freed; their control, the block's
                ``CONTROL_WEIGHTS`` rounded to 5 bits, must leave the
                limit, and the SSD state's checksums must be equal on
                every data participant.  Printed, not limited: prefill and
                step ms per rank, collectives, peak GB a rank (running,
                and while building its block), the card's memory in use.  Then ``uneven_path`` (its own line, after the 4
                ranks have exited): mamba2-130m on (1, 16), the production
                cut of its 24 SSD heads (96 channels, 1.5 heads a
                participant), in 16 rank processes on the one card: the
                train case at 4 of 24 layers, 2 x 512, 2 bf16 steps,
                float32 at 4 layers, and the serving case, 2 x 512
                prompts, 8 steps, a cache of 528, each held as above, the
                serving case's float32 control the blocks' channels
                mapped to heads from a head boundary (read on the logits
                and the gathered state); the whole SSD state's bits equal on all
                16 ranks after the prefill and after the last step (it is
                all-gathered from the participants' channels); K4 once per
                SSM layer of a prefill and twice a train step; its
                collective count (``uneven_collective_count``); one
                summary line of the two new cases' times.  Then
                ``long_path`` (its own line, after the 16 ranks have
                exited): jamba's (2, 1) case above in 2 rank processes,
                each holding the whole bf16 model (26.5 GB), and its
                collective count (``long_collective_count``).
14. ``roofline``: for each timed path (the prefill and a decode step of
                every served arch at its served depth, a train step of
                granite-moe-1b-a400m, mamba2-130m and seamless-m4t-medium,
                whose prefill also gets its ``mfu`` over ``init_cache`` +
                prefill: its model FLOPs count the encoder), the
                same step counted on ``meta`` tensors by the dry run's
                counters at the same shape and impls
                (``repro_torch.launch.dryrun``): ``mfu`` (model FLOPs over
                the measured time × the bf16 peak) and the achieved roofline
                fraction (the counted bound over the measured time), each
                at most 1.05; the meta run's kernel launches equal to the
                card's and its argument bytes on a 1 × 1 mesh at most the
                measured peak memory.
15. ``dryrun``: ``python -m repro_torch.launch.dryrun --all --mesh both``
                (started in the background after the build, in 2
                processes beside the card's phases; this phase waits for
                it) into a temporary directory, every cell ``ok``, the
                report's
                two tables printed; every one of the 64 cells' collectives
                counted (one participant's sharded program on meta), none
                refused; ``dominant`` tallied over compute, memory and
                collective; a few cells' collective bytes by kind.
16. ``examples``: the six ``repro_torch.examples`` on the GPU with their
                smallest documented arguments, each ending with ``OK``, its
                kernel launches counted: K1 once per packed sweep,
                ``serve_demo`` K2 and K3; ``quickstart`` and
                ``anomaly_study`` print what they print on the host.

The last three lines of standard output are the GPU's name and power limit
as ``nvidia-smi`` gives them, one JSON object ``{"kernels": [...]}``, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import importlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.anomaly import (  # noqa: E402
    SCENARIO_LIBRARY,
    ab_compare,
    build_scenario,
    export_episodes,
    run_scenario,
)
from repro_torch.anomaly.scenario import EPISODE_PINS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BigRootsAnalyzer,
    BigRootsThresholds,
    Forecaster,
    JAX_FEATURES,
    cause_to_wire,
    evaluate_forecaster,
    lead_time_curve,
    train_forecaster,
)
from repro_torch.core.fleet import GateStaging  # noqa: E402
from repro_torch.configs import ShapeSpec, cells, get_config  # noqa: E402
from repro_torch.device import sm_count  # noqa: E402
from repro_torch.core.forecast import PREDICTED_STRAGGLER  # noqa: E402
from repro_torch.data.pipeline import DataConfig, HostDataLoader  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    bigroots_gates,
    build,
    decode_attention,
    flash_attention,
    moe_gmm,
    ssd_chunked_cuda,
    ssd_scan,
)
from repro_torch.kernels.grad import PlainGradient  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_ranks,
    make_mesh,
    run_ranks,
)
from repro_torch.models import (  # noqa: E402
    ForecastConfig,
    Model,
    forecast_init,
    lm,
)
from repro_torch.models import moe as moe_layer  # noqa: E402
from repro_torch.models.ssd import ssd_chunked as ssd_chunked_plain  # noqa: E402
from repro_torch.parallel import (  # noqa: E402
    collectives,
    compressed_allreduce_mean,
    dequantize,
    ep_moe,
    quantize,
)
from repro_torch.parallel.dist import RankShards  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from repro_torch.parallel.sharding import param_block  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Diagnosis,
    FleetAggregator,
    Request,
    ServeEngine,
)
from repro_torch.serve.engine import cast_params, served_dtype  # noqa: E402
from repro_torch.train import global_norm  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, AdamWState  # noqa: E402
from repro_torch.train import step as train_step_mod  # noqa: E402
from repro_torch.telemetry import (  # noqa: E402
    ResourceTimeline,
    StageDelta,
    StepDelta,
    StepTelemetry,
)

#: The fleet: 64 live stage windows (the aggregator's default retention) of
#: 16384 rows each, filled by 32 senders; every tick 4 senders add 64 fresh
#: rows to every stage.  Only the number of ticks can be cut.
STAGES = 64
ROWS = 16384
SENDERS = 32
FRESH_SENDERS = 4
FRESH_ROWS = 64
NODE_NAMES = 512
RISK_TOL = 1e-12
#: The serving path: glm4-9b, batch 8 of 1024-token prompts, 32 new tokens
#: each, and a cache of prompt + new + 8 positions (as ``launch/serve.py``
#: sizes it).
SERVE_ARCH = "glm4_9b"
SERVE_BATCH = 8
PROMPT_LEN = 1024
MAX_NEW = 32
MAX_LEN = PROMPT_LEN + MAX_NEW + 8
#: The JAX package's kernel-test tolerances (rtol = atol), by dtype: the
#: attention and SSD kernels', and the grouped matmul's.
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
GMM_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
#: K5's backward kernels against its gradient's plain forms (rtol = atol):
#: bf16's step at 2^-6, the largest error the forward's bf16 checks read
#: at the sharded shapes; one rounding apart reads 2^-8 relative.
GMM_BWD_TOL = 2 ** -6
#: K3's statistics-form ``o`` and the blocks' combine, held by relative RMS
#: (over a long block ``o`` is small, about sqrt(e / positions), and the
#: elementwise ``ATTN_TOL`` would pass ``o = 0``).  bf16 ``p`` rounded at
#: the kernel's split maxima, not the block's, reads about 2e-3 (the plain
#: splits emulated at 16 384 positions); the controls read about 1.
STATS_REL_RMS = 1e-2
#: The MoE (K5) and Mamba2 (K4) serving paths, at the same batch, prompt
#: and new tokens as glm4-9b's.
MOE_ARCH = "granite_moe_1b_a400m"
SSM_ARCH = "mamba2_130m"
#: Every arch served through ``ServeEngine``, in the order they run, with
#: the depth it is served at (None: the config's own).  A cut keeps whole
#: periods of the layer pattern: jamba-v0.1-52b at 8 of its 32 layers is
#: one period (1 attention, 7 SSM and 4 MoE layers, 13.3 B parameters), the
#: only model whose forward runs K2, K4 and K5 together.  olmoe-1b-7b
#: (64 experts top-8) is served since the routing check holds the slots
#: whose expert moved (``ROUTING_FLIP_SHARE``).
HYBRID_ARCH = "jamba_v0_1_52b"
SERVE_PATHS = {SERVE_ARCH: None, MOE_ARCH: None, SSM_ARCH: None,
               HYBRID_ARCH: 8, "codeqwen1_5_7b": None, "granite_3_8b": None,
               "granite_8b": None, "olmoe_1b_7b": None}
#: The VLM: internvl2-26b's backbone at full width, cut to 8 of its 48
#: layers (all 48 are ~80 GB of float32 master weights), served through
#: ``Model`` with ``frontend_tokens`` (1024) seeded patch embeddings ahead
#: of each prompt; its cache also holds the patches.
VLM_ARCH = "internvl2_26b"
VLM_LAYERS = 8
#: The bf16 kernel path's logits are held to the float32 model (the
#: reference's plain forms in float32 on the same f32 weights, teacher-forced
#: with the same tokens and the kernel run's routing): their relative RMS
#: error may be at most this factor times that of the plain forms in bf16.
#: A fixed bound would not do: the two bf16 forms round at different places
#: (the dense form rounds logits and probabilities to bf16, the kernels keep
#: f32 logits) in each layer, bf16 keeps 8 bits, and how far that carries
#: to the logits is a property of the weights, not of the kernels.
SERVE_BF16_MARGIN = 1.5
#: The bf16 kernel path against the bf16 plain forms (teacher-forced with
#: its tokens and routing), relative RMS of the worst step, by arch.  Each
#: limit lies between the readings of sound runs and those of a control:
#: the plain forms on weights whose products feed the kernels (attention
#: q/k/v, the experts, the SSD's x and B/C projections) rounded to
#: ``CONTROL_BITS`` significant bits, three fewer than bf16's, as a kernel
#: that lost precision would be.  Every run checks that its control lies
#: past the limit.  Readings on an H100 (sound / control at 5 bits):
#: glm4-9b 0.080 / 0.206, mamba2-130m 0.018 / 0.086; granite-moe-1b-a400m
#: 0.034 / 0.065 with its control at 6 bits, which 5 bits only widens;
#: seamless-m4t-medium 0.0223 / 0.0408; jamba-v0.1-52b (8 layers) 0.0169 /
#: 0.0741, internvl2-26b (8 layers, with patches) 0.0479 / 0.1632,
#: codeqwen1.5-7b 0.0700 / 0.1896, granite-3-8b 0.0760 / 0.2133,
#: granite-8b 0.0739 / 0.2097, olmoe-1b-7b 0.0592 / 0.1963 (the limits
#: near their geometric means).  A second seed (``--serve`` of every arch
#: of ``SERVE_PATHS`` with ``--seed 1``, NVIDIA H100 80GB HBM3, 700.00 W),
#: sound / control at 5 bits: glm4-9b 0.0782 / 0.2121, granite-moe
#: 0.0350 / 0.1104, mamba2 0.0158 / 0.0845, jamba (8 layers) 0.0160 /
#: 0.0741, codeqwen 0.0713 / 0.1919, granite-3-8b 0.0784 / 0.1994,
#: granite-8b 0.0721 / 0.1972, olmoe 0.0611 / 0.1788: every sound reading
#: under its limit and every control past it, as at seed 0.  The
#: encoder-decoder and the VLM at seed 1 (``--serve seamless_m4t_medium
#: internvl2_26b --seed 1``, NVIDIA H100 80GB HBM3, 700.00 W): seamless
#: 0.0223 / 0.0392, internvl2 (8 layers, with patches) 0.0477 / 0.1611,
#: both under their limits with their controls past them.
SERVE_BF16_KERNEL_VS_PLAIN = {"glm4_9b": 0.12, "granite_moe_1b_a400m": 0.055,
                              "mamba2_130m": 0.04,
                              "seamless_m4t_medium": 0.03,
                              "jamba_v0_1_52b": 0.035, "internvl2_26b": 0.09,
                              "codeqwen1_5_7b": 0.115, "granite_3_8b": 0.125,
                              "granite_8b": 0.125, "olmoe_1b_7b": 0.11}
CONTROL_BITS = 5
#: A replayed routing slot (token x k) has moved where the replaying run's
#: own top-k does not hold the slot's recorded expert: the set difference,
#: one count per changed expert (routing by an unrelated top-8 of 32 moves
#: 1 - 8/32 = 75 %).  In bf16 their share may be at most the limit below,
#: and every bf16 run also replays the routing in its control (the plain
#: forms on weights rounded to ``CONTROL_BITS`` bits), which must lie past
#: it.  ``flips``, the positions where the two top-k lists, each sorted by
#: expert id, differ (one changed expert counts 1 to k of them), is
#: reported beside it; float32 runs hold it to 1e-3 (0 in every reading).
#: The bf16 limit had been 8 % on ``flips``, with no control; olmoe-1b-7b
#: read 8.3 % there with 2.5 % moved.  bf16 ``moved`` on an H100 (NVIDIA
#: H100 80GB HBM3, 700 W; the same to four digits in every run), sound
#: against the bf16 plain forms / float32, then the 5-bit control:
#: granite-moe serving 1.37 / 1.41 %, control 4.21 %; its ep prefill 1.04
#: %, control 4.20 %; its training gradient check 1.31 %, control 4.02 %;
#: jamba 0.71 / 1.82 %, control 3.76 %; olmoe 2.53 / 2.52 %, control 7.32
#: %.  The limit lies between the highest sound reading (olmoe's 2.53 %)
#: and the lowest control (jamba's 3.76 %), near their geometric mean; so
#: olmoe is served in ``SERVE_PATHS``.  At seed 1 (``--serve ... --seed
#: 1``): granite-moe 1.38 / 1.40 %, control 4.24 %; jamba 0.66 / 1.82 %,
#: control 3.81 %; olmoe 2.49 / 2.52 %, control 7.31 %.
ROUTING_FLIP_SHARE = {"bfloat16": 0.03, "float32": 1e-3}
#: The tally each dtype's limit holds.
ROUTING_TALLY = {"bfloat16": "moved", "float32": "flips"}
#: float32 logits of the kernel path against the plain forms in float64,
#: relative RMS: float32 rounding through 4 layers.
SERVE_F32_REL_RMS = 1e-4
#: The encoder-decoder path: seamless-m4t-medium at its published size,
#: 8 requests of ``ENC_FRAMES`` frame embeddings (seq / 4, the JAX
#: package's rule, ``launch/specs.py``) and a 1024-token decoder prompt,
#: 32 greedy new tokens, the same cache as the decoder-only paths.
ENCDEC_ARCH = "seamless_m4t_medium"
ENC_FRAMES = PROMPT_LEN // 4
#: Expert parallelism: granite-moe-1b-a400m with ``moe_impl="ep"`` on a
#: (data 1, model 4) mesh of virtual shards on the one card, its prefill at
#: the serving batch; logits against the same ep function with K5's plain
#: version within granite's bf16 limit.
EP_SHARDS = 4
EP_KERNEL_VS_PLAIN = SERVE_BF16_KERNEL_VS_PLAIN[MOE_ARCH]
#: The served prefill drops no slot at the default capacity factor 1.25
#: (random routers route evenly), so the drop path is driven directly: one
#: ep layer at this factor, K5 against its plain version.
EP_LOW_CF = 0.5


#: The diagnosis stack's goldens, pinned by the JAX package.
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
#: hot_host_cpu scaled from its 16 hosts to this fleet (and racks); the
#: simulation is host Python, which bounds the size within the run's limit.
SCALED_HOSTS = 1024
SCALED_RACKS = 32
SCALED_NODE = "h0003"
#: The forecaster's value gate (the JAX package's
#: ``tests/test_forecast.py::TestForecastValue``): (scenario, seed) of the
#: training and held-out exports, and the training run.
VALUE_TRAIN = (("hot_host_cpu", 11), ("hot_host_cpu", 211),
               ("clock_skew", 53), ("clock_skew", 253))
VALUE_HELD = (("hot_host_cpu", 411), ("clock_skew", 453))
VALUE_STEPS = 400
#: Closed-loop A/B: the least share of the mean step time that acting on
#: causes must recover (examples/fault_tolerance_demo.py).
AB_IMPROVEMENT = 0.02


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, message: str) -> None:
    """A failed check fails the run (also under ``python -O``)."""
    if not cond:
        raise RuntimeError(message)


# -- data ---------------------------------------------------------------------

def incident_columns(n: int, rng) -> dict:
    """A fleet-incident block of ``n`` rows: the Mantri threshold flags
    ~20% of rows as stragglers while only a ~0.2% hot set (at least one
    row) carries an attributable feature signal."""
    dur = rng.lognormal(mean=0.0, sigma=0.18, size=n) * 10.0
    slow = rng.choice(n, size=max(n // 5, 1), replace=False)
    dur[slow] *= 1.9
    cpu = rng.uniform(0.1, 0.3, n)
    hot = slow[: max(n // 500, 1)]
    cpu[hot] = 0.95
    return {
        "dur": dur,
        "hot": hot,
        "features": {
            "cpu": cpu,
            "disk": rng.uniform(0.15, 0.2, n),
            "network": rng.uniform(5e5, 6e5, n),
            "read_bytes": rng.uniform(0.95, 1.05, n) * 64e6,
            "gc_time": rng.uniform(0, 0.05, n),
            "data_load_time": rng.uniform(0, 0.4, n),
            "h2d_time": rng.uniform(0, 0.1, n),
        },
    }


def sender_payload(sender: int, seq: int, rows: int, first: int, tag: str,
                   seed: int) -> tuple[bytes, set]:
    """One sender's ``StepDelta`` wire payload: ``rows`` rows for each of
    the ``STAGES`` stage windows (hosts ``first .. first+rows-1``).  Returns
    the bytes and the injected hot task ids."""
    blocks, hot_ids = [], set()
    for s in range(STAGES):
        rng = np.random.default_rng([seed, sender, seq, s])
        cols = incident_columns(rows, rng)
        hosts = np.arange(first, first + rows)
        task_ids = [f"h{h}/{tag}s{s}" for h in hosts]
        hot_ids.update(task_ids[i] for i in cols["hot"])
        blocks.append(StageDelta(
            f"steps_{s:06d}", task_ids,
            [f"h{h % NODE_NAMES}" for h in hosts],
            np.zeros(rows), cols["dur"], np.zeros(rows, dtype=np.int16),
            cols["features"],
            {k: np.ones(rows, dtype=bool) for k in cols["features"]},
        ))
    return StepDelta(f"sender{sender}", seq, blocks, boot=1).to_bytes(), hot_ids


def make_stream(args) -> dict:
    """The whole run's payloads, made once and fed to both runs."""
    per_sender = ROWS // SENDERS
    fill, hot = [], set()
    for sender in range(SENDERS):
        raw, h = sender_payload(sender, 1, per_sender, sender * per_sender,
                                "", args.seed)
        fill.append(raw)
        hot |= h
    ticks = []
    for tick in range(args.ticks):
        batch, tick_hot = [], set()
        for sender in range(FRESH_SENDERS):
            raw, h = sender_payload(
                sender, 2 + tick, FRESH_ROWS,
                ROWS + (tick * FRESH_SENDERS + sender) * FRESH_ROWS,
                f"t{tick}", args.seed)
            batch.append(raw)
            tick_hot |= h
        ticks.append((batch, tick_hot))
    return {"fill": fill, "fill_hot": hot, "ticks": ticks}


# -- the main path ------------------------------------------------------------

class Stopwatch:
    """Host-clock spans around the path's public entry points (each span's
    work ends in a device synchronisation of its own: a ``.cpu()``
    read-back)."""

    def __init__(self) -> None:
        self.ms: dict[str, float] = {}
        self.started: dict[str, float] = {}
        self.sizes: dict[str, int] = {}

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            self.started[name] = t0
            if a and hasattr(a[0], "__len__"):
                self.sizes[name] = len(a[0])
            try:
                return fn(*a, **kw)
            finally:
                self.ms[name] = self.ms.get(name, 0.0) + (
                    time.perf_counter() - t0) * 1e3
                self.started[name + "_end"] = time.perf_counter()

        setattr(obj, attr, timed)

    def reset(self) -> None:
        self.ms.clear()
        self.started.clear()
        self.sizes.clear()


def build_fleet(args, device, backend: str, watch: Stopwatch | None):
    schema = JAX_FEATURES
    analyzer = BigRootsAnalyzer(schema, backend=backend, device=device)
    agg = FleetAggregator(schema, analyzer, attribution=True,
                          max_rows=ROWS, device=device)
    cfg = ForecastConfig(features=len(schema))
    forecaster = Forecaster(
        forecast_init(cfg, seed=args.seed), cfg, schema,
        risk_threshold=0.45, hold_steps=2, min_history=2, device=device)
    diag = Diagnosis.fleet(agg, forecaster=forecaster)
    if watch is not None:
        analyzer.staging.record_events = True
        watch.wrap(analyzer, "analyze_fleet", "sweep")
        watch.wrap(agg.stream.attributor, "attribute", "whatif")
        watch.wrap(forecaster, "step", "forecast")
    return analyzer, agg, forecaster, diag


def drive(args, stream, device, backend: str, timed: bool):
    """Ingest the fill payloads, then drive the ticks.  Returns the per-tick
    cause wire dicts (and the per-tick timings when ``timed``)."""
    watch = Stopwatch() if timed else None
    analyzer, agg, forecaster, diag = build_fleet(args, device, backend, watch)
    t0 = time.perf_counter()
    rows = sum(agg.ingest(raw) for raw in stream["fill"])
    ingest_s = time.perf_counter() - t0
    check(rows == STAGES * ROWS, f"fill ingested {rows} rows")
    check(len(agg.store) == STAGES, f"{len(agg.store)} stage windows")
    clock = iter(np.arange(0.0, 1e6, 10.0).tolist())
    telem = StepTelemetry("h0", wire=True, window=1, boot=1,
                          clock=lambda: next(clock))
    causes, timings = [], []
    for tick, (batch, _hot) in enumerate(stream["ticks"]):
        if watch is not None:
            watch.reset()
        t_in = time.perf_counter()
        for raw in batch:
            agg.ingest(raw)
        with telem.step(tick % STAGES) as scope:
            scope.add("read_bytes", 64e6)
        t_tick = time.perf_counter()
        fresh = diag.tick(telem, step_time=10.0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        causes.append([cause_to_wire(c) for c in fresh])
        if watch is not None:
            st = watch.started
            staging = analyzer.staging
            h2d, kern, d2h = staging.last_ms
            gates_t0, gates_t1 = staging.last_span
            need = gate_bound(staging.last_inputs())
            timings.append({
                "tick": tick,
                "windows_swept": watch.sizes["sweep"],
                "batch_shape": list(staging.last_inputs()[0].shape),
                "live_rows": need["live_rows"],
                "pv_sectors": need["pv_sectors"],
                "gate_bound_ms": need["bound_ms"],
                "fresh_ingest_ms": (t_tick - t_in) * 1e3,
                "prelude_pack_ms": (gates_t0 - st["sweep"]) * 1e3,
                "h2d_ms": h2d, "gate_kernel_ms": kern, "d2h_ms": d2h,
                "gates_host_ms": (gates_t1 - gates_t0) * 1e3,
                "finish_ms": (st["sweep_end"] - gates_t1) * 1e3,
                "whatif_ms": watch.ms.get("whatif", 0.0),
                "forecast_ms": watch.ms["forecast"],
                "tick_total_ms": (t_end - t_tick) * 1e3,
                "causes": len(fresh),
            })
    return causes, timings, ingest_s, analyzer, agg


def compare_runs(got, want, stream) -> dict:
    """Tick by tick: confirmed causes and attributions exactly equal, forecast
    risks within ``RISK_TOL``; every injected hot task confirmed."""
    confirmed = attributed = predicted = 0
    found_cpu = set()
    for tick, (g_tick, w_tick) in enumerate(zip(got, want)):
        check(len(g_tick) == len(w_tick),
              f"tick {tick}: {len(g_tick)} causes vs oracle {len(w_tick)}")
        for g, w in zip(g_tick, w_tick):
            if w["feature"] == PREDICTED_STRAGGLER:
                predicted += 1
                g, w = dict(g), dict(w)
                gv, wv = g.pop("value"), w.pop("value")
                check(abs(gv - wv) <= RISK_TOL + RISK_TOL * abs(wv),
                      f"tick {tick}: forecast risk {gv} vs oracle {wv}")
                g.pop("guidance"), w.pop("guidance")  # quotes the risk
            else:
                confirmed += 1
                attributed += w["attribution"] is not None
                if w["feature"] == "cpu":
                    found_cpu.add(w["task_id"])
            check(g == w, f"tick {tick}: {g} != {w}")
        for g in g_tick:
            check(np.isfinite(g["value"]), f"tick {tick}: non-finite {g}")
    injected = set(stream["fill_hot"])
    for _batch, hot in stream["ticks"]:
        injected |= hot
    # A hot row is only a finding when its duration also clears the
    # straggler threshold, which the draw leaves to ~7 in 8 of them.
    recall = len(injected & found_cpu) / len(injected)
    check(recall >= 0.7,
          f"only {recall:.2f} of the injected hot set confirmed")
    check(confirmed > 0 and attributed > 0 and predicted > 0,
          f"confirmed={confirmed} attributed={attributed} "
          f"predicted={predicted}")
    return {"confirmed": confirmed, "attributed": attributed,
            "predicted": predicted, "injected_hot": len(injected),
            "hot_confirmed": len(injected & found_cpu),
            "cpu_causes_outside_hot_set": len(found_cpu - injected)}


# -- the kernel against its plain version -------------------------------------

def synthetic_batch(rng, W, R, F, device):
    counts = rng.integers(R // 2, R + 1, size=W)
    rowmask = (np.arange(R)[None, :] < counts[:, None]).astype(np.float64)
    arrays = (
        rng.normal(1.0, 2.0, (W, R, F)), rng.normal(2.0, 4.0, (W, R, F)),
        rng.integers(0, 6, (W, R, 1)).astype(np.float64),
        rng.integers(0, 6, (W, R, 1)).astype(np.float64),
        rowmask[:, :, None], rng.normal(0.0, 8.0, (W, 1, F)),
        rng.normal(0.5, 1.0, (W, 1, F)), rng.choice([0.0, 1.0], (W, 1, F)),
        np.where(rng.random((1, 1, F)) < 0.3, 0.2, -np.inf),
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def corner_batch(rng, device, F: int):
    """NaN values, zero counts, padded rows, an odd row count."""
    t = [x.cpu().numpy().copy() for x in synthetic_batch(rng, 3, 257, F, "cpu")]
    t[0][0, :40] = np.nan
    t[2][:, ::2] = 0.0
    t[3][:, 1::2] = 0.0
    t[1][0, ::2] = t[5][0]
    t[4][1] = 0.0
    t[4][2, 100:] = 0.0
    t[0][2, 100:] = 100.0
    return tuple(torch.from_numpy(a).to(device) for a in t)


def special_batch(rng, W, R, F, device):
    """A synthetic batch with a quarter of every input's entries (values,
    counts, masks, column vectors, floor) replaced by
    ``bigroots_gates.SPECIAL_VALUES``."""
    t = [x.numpy().copy() for x in synthetic_batch(rng, W, R, F, "cpu")]
    for a in t:
        hit = rng.random(a.shape) < 0.25
        a[hit] = rng.choice(bigroots_gates.SPECIAL_VALUES, int(hit.sum()))
    return tuple(torch.from_numpy(a).to(device) for a in t)


def shifted(tensors):
    """The same batch as contiguous views one element into their storage:
    no pointer is 16-byte aligned, so the kernel takes its scalar path."""
    out = []
    for t in tensors:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return tuple(out)


def gate_corners(rng, device) -> list:
    """K1's corner batches: ``(label, tensors)``.  Special values at F 2,
    9, 14, 16 and 64; W 1; R 1, 31, and one pass and one tile of the
    F = 14 vector plan and the F = 9 scalar plan, each ± 1 row; a window
    whose rows are all padded; F 514, whose 257 column pairs take more than
    one column chunk; unaligned views (the scalar path) at F 14 and at F
    514, and F 257 (odd), whose columns take several chunks on the scalar
    path."""
    F = len(JAX_FEATURES)
    out = [(f"special values F={f}", special_batch(rng, 4, 300, f, device))
           for f in (2, 9, 14, 16, 64)]
    out.append(("W=1", synthetic_batch(rng, 1, 300, F, device)))
    for f in (F, 9):
        plan = bigroots_gates.gate_plan(1, 1, f, aligned=True)
        tile = plan.rows_per_pass * bigroots_gates.ROWS_PER_THREAD
        for R in sorted({1, 31, plan.rows_per_pass - 1, plan.rows_per_pass,
                         plan.rows_per_pass + 1, tile - 1, tile + 1}):
            out.append((f"R={R} F={f} ({plan.path} plan)",
                        synthetic_batch(rng, 3, R, f, device)))
    padded = synthetic_batch(rng, 3, 200, F, device)
    padded[4][1] = 0.0
    padded[0][1] = 100.0
    out.append(("an all-padded window", padded))
    for f in (2, 16, 64, 514):
        out.append((f"F={f}", synthetic_batch(rng, 2, 150, f, device)))
    out.append(("unaligned view F=14",
                shifted(synthetic_batch(rng, 3, 257, F, device))))
    out.append(("unaligned view, special values",
                shifted(special_batch(rng, 3, 100, F, device))))
    out.append(("unaligned view F=514",
                shifted(synthetic_batch(rng, 2, 40, 514, device))))
    out.append(("F=257", special_batch(rng, 2, 40, 257, device)))
    return out


def hold_against_plain(tensors, peer_mean: float, label: str = "") -> dict:
    got = bigroots_gates.gates_launch(*tensors, peer_mean=peer_mean)
    torch.cuda.synchronize()
    want = bigroots_gates.eval_gates_torch(*tensors, peer_mean=peer_mean)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    mismatches = int((diff != 0).sum().item())
    path = bigroots_gates.plan_for(tensors[0], tensors[1], got).path
    check(torch.equal(got, want),
          f"{mismatches} gate bits differ at {list(got.shape)} "
          f"({label}, {path} path)")
    return {"case": label, "shape": list(tensors[0].shape), "path": path,
            "mismatches": mismatches,
            "max_abs_err": float(diff.max().item()),
            "fired": int((want != 0).sum().item())}


#: Device cycles (~0.5 ms) the card spins before each timed launch, so that
#: the host has enqueued the launch before the start event is reached.
HOST_LEAD_CYCLES = 1_000_000


def time_ms(fn, flush, reps: int = 25) -> list[float]:
    """Device times of ``reps`` launches of ``fn`` (CUDA events), with the
    50 MB L2 cache displaced before each launch by *reading* a larger buffer
    (writing one would leave dirty lines whose write-back competes with the
    timed launch).  A spin of ``HOST_LEAD_CYCLES`` on the device follows
    the flush: without it the start event is passed as soon as the flush
    ends, and a wrapper whose host work (checks, tensor maps) outlasts the
    flush would add the device's wait for its launch to the reading.  The
    warm-up keeps the card busy for a quarter of a second first: the main
    path leaves it idle most of the time, and an idle card clocks down."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.25:
        flush.sum()
        fn()
        torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _sectors(hit: torch.Tensor) -> int:
    """32-byte sectors (four float64, the card's unit of transfer) of an
    array that hold an element where ``hit`` is true."""
    flat = hit.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 4)])
    return int(flat.view(-1, 4).any(1).sum().item())


def gate_bound(tensors) -> dict:
    """What the function needs of these inputs.  ``rowmask`` of every row
    says which rows are live; ``v`` of every live element (with the column
    vectors) says which elements can fire: mask > 0, v > q, numok > 0 and
    v > floor.  Only there do ``pv`` and the two counts change the output,
    so they are counted by the 32-byte sectors holding such an element (for
    ``pv``) or such a row (for each count); the bytes and operations are
    ``roofline.gate_work``'s.

    Two earlier yardsticks beside it: ``bytes_live_rows`` /
    ``bound_live_rows_ms`` count ``v`` and ``pv`` of every live row and
    24 B of row scalars for every row; ``bytes_all_rows`` /
    ``bound_all_rows_ms`` count ``v`` and ``pv`` of every row as well."""
    v, pv, icnt, acnt, mask, vsum, q, numok, floor = tensors
    W, R, F = v.shape
    live = mask > 0.0
    decides = live & (v > q) & (numok > 0.0) & (v > floor)
    n_live = int(live.sum().item())
    pv_sectors = _sectors(decides)
    work = roofline.gate_work(W, R, F, n_live, pv_sectors,
                              _sectors(decides.any(2)))
    f64 = torch.float64
    need = roofline.work_bound(work)
    return {"live_rows": n_live, "rows": W * R,
            "deciding_elements": int(decides.sum().item()),
            "pv_sectors": pv_sectors,
            "pv_sectors_all": -(-W * R * F // 4),
            "bytes": work["bytes"], "bound_ms": need["bound_ms"],
            "bound_by": need["bound_by"],
            "bytes_live_rows": work["bytes_live_rows"],
            "bound_live_rows_ms": roofline.bound(
                work["flops"], work["bytes_live_rows"], f64)["bound_ms"],
            "bytes_all_rows": work["bytes_all_rows"],
            "bound_all_rows_ms": roofline.bound(
                work["flops_all_rows"], work["bytes_all_rows"],
                f64)["bound_ms"]}


def measure_fns(fns: dict, flush, rounds: int = 4, reps: int = 25) -> dict:
    """CUDA-event times of each function, timed in turns (``rounds`` times
    each, order reversed every other round): at a small size one block of
    launches can sit ~40 % off the next, so each number is the median over
    all rounds and the round medians are kept beside it."""
    samples = {k: [] for k in fns}
    per_round = {k: [] for k in fns}
    for rnd in range(rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for k in order:
            got = time_ms(fns[k], flush, reps)
            samples[k] += got
            per_round[k].append(statistics.median(got))
    return {**{k: statistics.median(v) for k, v in samples.items()},
            "round_medians": per_round}


def measure(tensors, peer_mean: float, flush, replaced=None) -> dict:
    """The gate kernel, its plain version and (``replaced``) the body it
    replaced, held bit-identical first, timed in turns."""
    W, R, F = tensors[0].shape
    out = torch.empty((W, R, F), dtype=torch.int8, device=tensors[0].device)

    def kernel():
        return bigroots_gates.gates_launch(*tensors, peer_mean=peer_mean,
                                           out=out)
    fns = with_replaced({
        "ms": kernel,
        "plain_ms": lambda: bigroots_gates.eval_gates_torch(
            *tensors, peer_mean=peer_mean),
    }, replaced and replaced.body(
        "bigroots_gates", lambda: replaced.gates(tensors, peer_mean)),
        kernel, "bigroots_gates", 0.0)
    return {"shape": [W, R, F],
            "path": bigroots_gates.plan_for(tensors[0], tensors[1], out).path,
            **measure_fns(fns, flush), **gate_bound(tensors)}


# -- the attention kernels against their plain versions -------------------------

def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def compare(got, want, tol: float, what: str) -> dict:
    """Elementwise ``|got - want| <= tol + tol * |want|`` (rtol = atol)."""
    err = (got.float() - want.float()).abs()
    bad = int((err > tol + tol * want.float().abs()).sum().item())
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite")
    res = {"max_abs_err": float(err.max().item()) if err.numel() else 0.0,
           "tolerance": tol, "outside_tolerance": bad}
    check(bad == 0, f"{what} differs: {res}")
    return res


def flash_case(gen, B, S, H, KV, D, dtype, causal, device, bhsd=False,
               Sk=None):
    """Kernel against plain version on one shape: ``S`` queries over ``Sk``
    keys (default ``S``).  ``bhsd``: the inputs are the JAX kernel's
    ``[B*H, S, D]`` layout seen as ``[1, S, B*H, D]`` views (strided, not
    copied)."""
    if bhsd:
        q = _randn(gen, (B * H, S, D), dtype, device).permute(1, 0, 2)[None]
        k = _randn(gen, (B * KV, S, D), dtype, device).permute(1, 0, 2)[None]
        v = _randn(gen, (B * KV, S, D), dtype, device).permute(1, 0, 2)[None]
    else:
        q = _randn(gen, (B, S, H, D), dtype, device)
        k = _randn(gen, (B, Sk or S, KV, D), dtype, device)
        v = _randn(gen, (B, Sk or S, KV, D), dtype, device)
    got = flash_attention.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention.flash_attention_torch(q, k, v, causal=causal)
    res = {"kernel": "flash_attention", "shape": list(q.shape), "kv": KV,
           "keys": k.shape[1], "dtype": str(dtype).removeprefix("torch."),
           "causal": causal, "bhsd_view": bhsd}
    return {**res, **compare(got, want, ATTN_TOL[dtype],
                             f"flash_attention {res}")}


def decode_case(gen, B, S, H, KV, D, dtype, cache_len, device):
    q = _randn(gen, (B, H, D), dtype, device)
    k = _randn(gen, (B, S, KV, D), dtype, device)
    v = _randn(gen, (B, S, KV, D), dtype, device)
    n = torch.tensor(cache_len, dtype=torch.int32, device=device)
    got = decode_attention.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_torch(q, k, v, n)
    res = {"kernel": "decode_attention", "cache": list(k.shape), "heads": H,
           "dtype": str(dtype).removeprefix("torch."),
           "cache_len": cache_len}
    if dtype == torch.bfloat16:
        res["splits"] = decode_attention.split_plan(B, KV, H // KV, S,
                                                    sm_count(device))
    return {**res, **compare(got, want, ATTN_TOL[dtype],
                             f"decode_attention {res}")}


def decode_stats_case(gen, B, S, H, KV, D, dtype, cache_len, device, q=None,
                      kv=None) -> tuple[dict, tuple]:
    """K3's statistics form against its plain version on one block of a
    cache (``q`` and ``kv`` given, else drawn): ``o``, ``m`` and ``l`` each
    within K3's tolerance (``l`` relative to its size), ``o`` also within
    ``STATS_REL_RMS``; a ``cache_len`` of -1 must give ``m = -1e30``, ``l =
    0`` and ``o = 0`` exactly.  Returns the readings, the kernel's ``(o, m,
    l)`` and the plain version's ``o``."""
    q = _randn(gen, (B, H, D), dtype, device) if q is None else q
    k, v = kv or (_randn(gen, (B, S, KV, D), dtype, device),
                  _randn(gen, (B, S, KV, D), dtype, device))
    n = torch.tensor(cache_len, dtype=torch.int32, device=device)
    got = decode_attention.decode_attention(q, k, v, n, stats=True)
    torch.cuda.synchronize()
    want = decode_attention.decode_attention_stats_torch(q, k, v, n)
    res = {"kernel": "decode_attention", "form": "statistics",
           "cache": list(k.shape), "heads": H,
           "dtype": str(dtype).removeprefix("torch."),
           "cache_len": cache_len}
    if dtype == torch.bfloat16:
        res["splits"] = decode_attention.split_plan(B, KV, H // KV, S,
                                                    sm_count(device))
    tol = ATTN_TOL[dtype]
    o, m, l = (compare(g, w, tol, f"decode_attention stats {name} {res}")
               for name, g, w in zip("oml", got, want))
    check(all(t.dtype == torch.float32 for t in got),
          f"the statistics form is not float32: {res}")
    if cache_len < 0:
        check(not got[0].any() and not got[2].any()
              and bool((got[1] == -1e30).all()),
              f"a block with no valid position: {res}")
    else:
        o["o_rel_rms"] = rel_rms(got[0], want[0])
        check(o["o_rel_rms"] <= STATS_REL_RMS,
              f"decode_attention stats o past {STATS_REL_RMS} relative "
              f"RMS: {res} {o}")
    return ({**res, **o, "m_max_abs_err": m["max_abs_err"],
             "l_max_abs_err": l["max_abs_err"]}, got, want[0])


def decode_corners(B, S, H, KV, device) -> list[int]:
    """cache_len values at the bf16 kernel's edges for one cache shape: 0,
    the last position of every split and the first of the next, and the
    last position of the cache."""
    n, length = decode_attention.split_plan(B, KV, H // KV, S,
                                            sm_count(device))
    edges = [e for s in range(1, n) for e in (s * length - 1, s * length)]
    return sorted({0, *edges, S - 1})


def attention_checks(device, seed: int) -> list[dict]:
    """The serving path's shapes and the corners around them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32
    cfg = get_config(SERVE_ARCH)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = []
    for dtype in (bf, f32):
        out.append(flash_case(gen, SERVE_BATCH, PROMPT_LEN, H, KV, D, dtype,
                              True, device))
        out.append(flash_case(gen, 2, 1000, H, KV, D, dtype, True, device))
        out.append(flash_case(gen, 2, 1000, H, KV, D, dtype, False, device))
        out.append(flash_case(gen, 2, 256, 8, 8, 128, dtype, True, device))
        out.append(flash_case(gen, 2, 300, 16, 1, 64, dtype, True, device))
        out.append(flash_case(gen, 2, 200, 8, 2, 64, dtype, False, device,
                              bhsd=True))
        # The bf16 kernel's 128-row query and key tiles: one row, a partial
        # tile, one row past a whole tile; both head dims.
        for S in (1, 17, 129):
            for causal in (True, False):
                out.append(flash_case(gen, 2, S, 8, 2, 128 if S != 17 else 64,
                                      dtype, causal, device))
        for cache_len in sorted({511, 512, PROMPT_LEN + MAX_NEW - 1,
                                 *decode_corners(SERVE_BATCH, MAX_LEN, H, KV,
                                                 device)}):
            out.append(decode_case(gen, SERVE_BATCH, MAX_LEN, H, KV, D, dtype,
                                   cache_len, device))
        # granite-moe-1b-a400m's decode (n_rep 2, D 64) at its split edges.
        mcfg = get_config(MOE_ARCH)
        for cache_len in decode_corners(SERVE_BATCH, MAX_LEN, mcfg.n_heads,
                                        mcfg.n_kv_heads, device):
            out.append(decode_case(gen, SERVE_BATCH, MAX_LEN, mcfg.n_heads,
                                   mcfg.n_kv_heads, mcfg.head_dim, dtype,
                                   cache_len, device))
        out.append(decode_case(gen, 2, MAX_LEN, 8, 8, 128, dtype, 700,
                               device))
        out.append(decode_case(gen, 2, MAX_LEN, 16, 1, 64, dtype, 64, device))
        out.append(decode_case(gen, 2, 100, 16, 1, 64, dtype, 99, device))
        # n_rep 32: two groups of 16 query heads per kv head; S_max off the
        # 64-position tile and off the 16-position split multiple.
        for cache_len in decode_corners(2, 1000, 64, 2, device):
            out.append(decode_case(gen, 2, 1000, 64, 2, 128, dtype,
                                   cache_len, device))
        out.append(decode_case(gen, 3, 70, 4, 2, 64, dtype, 69, device))
        out.append(decode_case(gen, 1, 5, 4, 4, 128, dtype, 2, device))
        out += encdec_attention_checks(gen, dtype, device)
        out += served_attention_checks(gen, dtype, device)
    return out


def served_attention_checks(gen, dtype, device) -> list[dict]:
    """The head layouts of jamba, olmoe, codeqwen, granite-8b / 3-8b and
    internvl2, all at head_dim 128.  K2: n_rep 6 (internvl2's 48 query heads
    over 8) at one query row, one row past a 128-row tile and its 2048
    positions (1024 patch embeddings + 1024 text tokens); n_rep 4 (jamba,
    both granites) and n_rep 1 (codeqwen, olmoe) at 1024.  K3: n_rep 6 (a
    partial group of 6 in a 16-row head group) at the split edges of the
    serving cache and of internvl2's; n_rep 4 and 1 at the last step."""
    out = [flash_case(gen, 2, S, 48, 8, 128, dtype, True, device)
           for S in (1, 129, 2 * PROMPT_LEN)]
    out += [flash_case(gen, 2, PROMPT_LEN, H, KV, 128, dtype, True, device)
            for H, KV in ((32, 8), (32, 32), (16, 16))]
    for S_max in (MAX_LEN, serve_max_len(served_config(VLM_ARCH))):
        out += [decode_case(gen, SERVE_BATCH, S_max, 48, 8, 128, dtype, n,
                            device)
                for n in decode_corners(SERVE_BATCH, S_max, 48, 8, device)]
    out += [decode_case(gen, SERVE_BATCH, MAX_LEN, H, KV, 128, dtype,
                        PROMPT_LEN + MAX_NEW - 1, device)
            for H, KV in ((32, 8), (32, 32), (16, 16))]
    return out


def encdec_attention_checks(gen, dtype, device) -> list[dict]:
    """seamless-m4t-medium's shapes: plain MHA (n_rep 1) at head_dim 64.
    K2: the decoder's causal self-attention, the encoder's non-causal one
    over ``ENC_FRAMES``, and cross-attention (non-causal, ``Sq != Sk``) at
    its serving shape and at a query row or key past a 128-row tile, one
    key, one query; K3: the cross cache (``cache_len`` 0, the split edges,
    ``ENC_FRAMES - 1`` as served) and the self cache at its split edges."""
    cfg = get_config(ENCDEC_ARCH)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = SERVE_BATCH
    out = [flash_case(gen, B, PROMPT_LEN, H, KV, D, dtype, True, device),
           flash_case(gen, B, ENC_FRAMES, H, KV, D, dtype, False, device)]
    for Sq, Sk in ((PROMPT_LEN, ENC_FRAMES), (1, 256), (17, 129), (129, 17),
                   (300, 1)):
        out.append(flash_case(gen, B if Sq == PROMPT_LEN else 2, Sq, H, KV,
                              D, dtype, False, device, Sk=Sk))
    out.append(flash_case(gen, 2, 17, 8, 2, 128, dtype, False, device,
                          Sk=129))
    for cache_len in sorted({0, ENC_FRAMES - 1,
                             *decode_corners(B, ENC_FRAMES, H, KV, device)}):
        out.append(decode_case(gen, B, ENC_FRAMES, H, KV, D, dtype,
                               cache_len, device))
    for cache_len in decode_corners(B, MAX_LEN, H, KV, device):
        out.append(decode_case(gen, B, MAX_LEN, H, KV, D, dtype, cache_len,
                               device))
    return out


class Replaced:
    """The kernel bodies this version replaced, for timing in turns with the
    current ones in the same call: ``bigroots_gates.cu``,
    ``flash_attention.cu``, ``moe_gmm.cu``, ``decode_attention.cu`` and
    ``ssd_scan.cu`` from another tree's ``csrc`` (``--replaced DIR``; e.g.
    the parent commit's, unpacked with ``git archive``), built with the
    package's flags under their own library names.  A body whose source and
    shared headers equal the current ones replaced nothing: it is neither
    built nor timed (:meth:`body` gives None).  The C entry points bound:
    the gate kernel's, flash attention's and the grouped matmul's as now,
    decode attention's with its f32 split scratch and no split plan, the
    SSD's without the heads per block."""

    NAMES = ("bigroots_gates", "flash_attention", "moe_gmm",
             "decode_attention", "ssd_scan")

    def __init__(self, src_dir: str) -> None:
        out = os.path.join(build.build_dir(), "replaced")
        os.makedirs(out, exist_ok=True)
        nvcc = build.find_nvcc()
        self.built = [n for n in self.NAMES
                      if not self._same_as_current(src_dir, n)]
        procs = {n: subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", os.path.join(out, f"lib{n}.so"),
             os.path.join(src_dir, f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in self.built}
        for n, proc in procs.items():
            log, _ = proc.communicate()
            check(proc.returncode == 0, f"replaced {n} did not build: {log}")
        import ctypes
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

        def lib(n):
            return ctypes.CDLL(os.path.join(out, f"lib{n}.so"))
        self.src_dir = src_dir
        if "bigroots_gates" in self.built:
            self._gates = lib("bigroots_gates").bigroots_gates_f64
            self._gates.argtypes = [ptr] * 10 + [i32] * 3 + [
                ctypes.c_double, ptr]
        if "flash_attention" in self.built:
            self._flash = lib("flash_attention").flash_attention_fwd
            self._flash.argtypes = ([ptr] * 4 + [i32] * 8 + [ctypes.c_float]
                                    + [i64] * 12 + [ptr])
        if "moe_gmm" in self.built:
            self._gmm = lib("moe_gmm").moe_gmm_fwd
            self._gmm.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        if "decode_attention" in self.built:
            dec = lib("decode_attention")
            dec.decode_attention_split.restype = i32
            self._dec_split = dec.decode_attention_split()
            self._dec = dec.decode_attention_fwd
            self._dec.argtypes = ([ptr] * 8 + [i32] * 6 + [ctypes.c_float]
                                  + [i64] * 10 + [ptr])
        if "ssd_scan" in self.built:
            self._ssd = lib("ssd_scan").ssd_intra_chunk_fwd
            self._ssd.argtypes = [ptr] * 8 + [i32] * 8 + [i64] * 15 + [ptr]

    @staticmethod
    def _same_as_current(src_dir: str, name: str) -> bool:
        """``DIR/name.cu`` and every ``DIR/*.cuh`` equal the package's."""
        def sources(d):
            d = str(d)
            files = [f"{name}.cu"] + sorted(
                f for f in os.listdir(d) if f.endswith(".cuh"))
            return {f: open(os.path.join(d, f), "rb").read() for f in files}
        return sources(src_dir) == sources(build.CSRC)

    def body(self, name: str, fn):
        """``fn`` (a call of the replaced ``name``) when that body was
        built, else None."""
        return fn if name in self.built else None

    def gates(self, tensors, peer_mean: float):
        W, R, F = tensors[0].shape
        out = torch.empty((W, R, F), dtype=torch.int8,
                          device=tensors[0].device)
        rc = self._gates(*(t.data_ptr() for t in tensors), out.data_ptr(),
                         W, R, F, float(peer_mean),
                         torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"replaced bigroots_gates_f64: CUDA error {rc}")
        return out

    def flash(self, q, k, v, causal=True):
        B, Sq, H, D = q.shape
        out = torch.empty_like(q)
        st = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
        rc = self._flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, Sq, k.shape[1], H, k.shape[2], D,
                         int(causal), 1, 1.0 / D ** 0.5, *st,
                         torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"replaced flash_attention_fwd: CUDA error {rc}")
        return out

    def gmm(self, xs, w, sizes):
        out = torch.empty((xs.shape[0], w.shape[2]), dtype=xs.dtype,
                          device=xs.device)
        gs = sizes.to(torch.int32)
        M, E = xs.shape[0], w.shape[0]
        rc = self._gmm(xs.data_ptr(), w.data_ptr(), gs.data_ptr(),
                       out.data_ptr(), M, xs.shape[1], w.shape[2], E, 1,
                       moe_gmm.tile_rows(M, E),
                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"replaced moe_gmm_fwd: CUDA error {rc}")
        return out

    def decode(self, q, kc, vc, n):
        B, H, D = q.shape
        S, KV = kc.shape[1], kc.shape[2]
        n_s = -(-S // self._dec_split)
        m = torch.empty((B, H, n_s), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        acc = torch.empty((B, H, n_s, D), dtype=torch.float32,
                          device=q.device)
        out = torch.empty_like(q)
        st = (q.stride(0), q.stride(1),
              *(t.stride(i) for t in (kc, vc) for i in range(3)),
              out.stride(0), out.stride(1))
        rc = self._dec(q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                       n.data_ptr(), m.data_ptr(), l.data_ptr(),
                       acc.data_ptr(), out.data_ptr(), B, S, H, KV, D, 1,
                       1.0 / D ** 0.5, *st,
                       torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"replaced decode_attention_fwd: CUDA error {rc}")
        return out

    def ssd(self, x, dt, A, Bm, Cm, Q):
        B_, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        y = torch.empty((B_, S, H, P), dtype=torch.float32, device=x.device)
        states = torch.empty((B_, H, S // Q, N, P), dtype=torch.float32,
                             device=x.device)
        seg = torch.empty((B_, H, S // Q, Q), dtype=torch.float32,
                          device=x.device)
        st = [t.stride(i) for t in (x, dt, Bm, Cm, y) for i in range(3)]
        rc = self._ssd(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                       Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
                       states.data_ptr(), seg.data_ptr(), B_, S, H, G, Q, N,
                       P, 1, *st, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"replaced ssd_intra_chunk_fwd: CUDA error {rc}")
        return y, states, seg


def with_replaced(fns: dict, replaced_fn, current, what: str, tol: float
                  ) -> dict:
    """``fns`` plus ``replaced_ms`` when a replaced body is given: its
    output (each of them, for a tuple) is first held against the current
    kernel's with the plain version's tolerance ``tol``, then it is timed
    in the same turns."""
    if replaced_fn is None:
        return fns
    got, want = replaced_fn(), current()
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        compare(g, w, tol, f"replaced {what}")
    return {**fns, "replaced_ms": replaced_fn}


def flash_timing(gen, device, flush, arch: str, replaced,
                 Sq: int = PROMPT_LEN, Sk: int = PROMPT_LEN,
                 causal: bool = True) -> dict:
    """K2 at ``arch``'s prefill: ``[8, Sq, H, D]`` over ``Sk`` keys of its
    kv heads (by default causal, ``Sq = Sk = 1024``), bf16, beside its
    plain version, SDPA and (``replaced``) the body it replaced."""
    F = torch.nn.functional
    cfg = get_config(arch)
    B, H, KV, D, dt = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim, torch.bfloat16
    q = _randn(gen, (B, Sq, H, D), dt, device)
    k = _randn(gen, (B, Sk, KV, D), dt, device)
    v = _randn(gen, (B, Sk, KV, D), dt, device)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def kernel():
        return flash_attention.flash_attention(q, k, v, causal=causal)
    fns = {
        "ms": kernel,
        "plain_ms": lambda: flash_attention.flash_attention_torch(
            q, k, v, causal=causal),
        "library_ms": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True),
    }
    fns = with_replaced(fns, replaced and replaced.body(
        "flash_attention", lambda: replaced.flash(q, k, v, causal)), kernel,
        "flash_attention", ATTN_TOL[dt])
    t = measure_fns(fns, flush, rounds=2)
    t.update(shape=[B, Sq, H, D], keys=Sk, kv_heads=KV, causal=causal,
             dtype="bfloat16", path=cfg.name,
             work_items=H * B * -(-Sq // flash_attention.BF16_BQ),
             **roofline.work_bound(roofline.flash_work(
                 B, Sq, Sk, H, KV, D, dt, causal)))
    return t


def decode_timing(gen, device, flush, arch: str, replaced,
                  S_max: int = MAX_LEN,
                  last: int = PROMPT_LEN + MAX_NEW - 1) -> dict:
    """K3 at ``arch``'s last decode step: one-token attention over a
    ``[8, S_max, KV, D]`` cache with ``cache_len = last`` (by default the
    self cache of 1064 positions, 1056 valid), bf16, beside its plain
    version, SDPA and (``replaced``) the body it replaced."""
    F = torch.nn.functional
    cfg = get_config(arch)
    B, H, KV, D, dt = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim, torch.bfloat16
    q = _randn(gen, (B, H, D), dt, device)
    kc = _randn(gen, (B, S_max, KV, D), dt, device)
    vc = _randn(gen, (B, S_max, KV, D), dt, device)
    n = torch.tensor(last, dtype=torch.int32, device=device)
    valid = (torch.arange(S_max, device=device) <= n)[None, None, None, :]
    q4, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)

    def kernel():
        return decode_attention.decode_attention(q, kc, vc, n)
    fns = with_replaced({
        "ms": kernel,
        "plain_ms": lambda: decode_attention.decode_attention_torch(
            q, kc, vc, n),
        "library_ms": lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=valid, enable_gqa=True),
    }, replaced and replaced.body(
        "decode_attention", lambda: replaced.decode(q, kc, vc, n)), kernel,
        "decode_attention", ATTN_TOL[dt])
    t = measure_fns(fns, flush, rounds=4)
    t.update(cache=[B, S_max, KV, D], heads=H, cache_len=last,
             dtype="bfloat16", path=cfg.name,
             splits=decode_attention.split_plan(B, KV, H // KV, S_max,
                                                sm_count(device)),
             **roofline.work_bound(roofline.decode_work(
                 B, H, KV, D, last + 1, dt)))
    return t


def attention_timings(device, seed: int, flush, replaced=None) -> dict:
    """K2 at glm4-9b's prefill (``[8, 1024, 32, 128]`` causal over 2 kv
    heads) and granite-moe-1b-a400m's (``[8, 1024, 16, 64]`` over 8), and
    K3 at the last decode step of each: a ``[8, 1064, 2, 128]`` cache for
    32 heads and a ``[8, 1064, 8, 64]`` one for 16; seamless-m4t-medium's
    encoder, cross- and self-attention (``[8, 1024, 16, 64]`` over 16 kv
    heads) and K3 over its cross and self cache; granite's training shape
    ``[8, 512, 16, 64]``; bf16."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    S_train = TRAIN_SHAPES[MOE_ARCH][1]
    return {
        "flash_attention": flash_timing(gen, device, flush, SERVE_ARCH,
                                        replaced),
        "flash_attention_granite": flash_timing(gen, device, flush, MOE_ARCH,
                                                replaced),
        "decode_attention": decode_timing(gen, device, flush, SERVE_ARCH,
                                          replaced),
        "decode_attention_granite": decode_timing(gen, device, flush,
                                                  MOE_ARCH, replaced),
        # seamless-m4t-medium: the encoder, the decoder's cross-attention
        # over the encoder output, and a decode step's cross-attention over
        # the whole cross cache
        "flash_attention_encoder": flash_timing(
            gen, device, flush, ENCDEC_ARCH, replaced, ENC_FRAMES,
            ENC_FRAMES, causal=False),
        "flash_attention_cross": flash_timing(
            gen, device, flush, ENCDEC_ARCH, replaced, PROMPT_LEN,
            ENC_FRAMES, causal=False),
        "decode_attention_cross": decode_timing(
            gen, device, flush, ENCDEC_ARCH, replaced, ENC_FRAMES,
            ENC_FRAMES - 1),
        # the decoder's causal self-attention at n_rep 1 and a decode
        # step's over the self cache
        "flash_attention_self": flash_timing(gen, device, flush, ENCDEC_ARCH,
                                             replaced),
        "decode_attention_self": decode_timing(gen, device, flush,
                                               ENCDEC_ARCH, replaced),
        # granite-moe-1b-a400m's training shape, [8, 512, 16, 64]
        "flash_attention_train": flash_timing(
            gen, device, flush, MOE_ARCH, replaced, S_train, S_train),
        **served_attention_timings(gen, device, flush, replaced),
    }


#: The served families' attention layouts, all at head_dim 128, by the
#: name their timings carry: n_rep 6 (internvl2, whose prefill is 2048
#: positions), 4 (jamba, granite-8b and granite-3-8b alike), 1 (codeqwen's
#: 32 heads, olmoe's 16).
SERVED_ATTENTION = {"internvl2": VLM_ARCH, "jamba": HYBRID_ARCH,
                    "codeqwen": "codeqwen1_5_7b", "olmoe": "olmoe_1b_7b"}


def served_attention_timings(gen, device, flush, replaced) -> dict:
    """K2 at the prefill and K3 at the last decode step of each of
    ``SERVED_ATTENTION``, as served (internvl2's patch embeddings lengthen
    its prefill and cache by ``frontend_tokens``)."""
    out = {}
    for name, arch in SERVED_ATTENTION.items():
        cfg = served_config(arch)
        S, S_max = cfg.frontend_tokens + PROMPT_LEN, serve_max_len(cfg)
        out[f"flash_attention_{name}"] = flash_timing(
            gen, device, flush, arch, replaced, S, S)
        out[f"decode_attention_{name}"] = decode_timing(
            gen, device, flush, arch, replaced, S_max, S + MAX_NEW - 1)
    return out


# -- the MoE grouped matmul (K5) and the SSD intra-chunk kernel (K4) -------------

def routed_sizes(gen, rows: int, experts: int, device) -> torch.Tensor:
    """Group sizes of ``rows`` routed slots drawn from a random router's
    softmax over ``experts`` (uneven, as real routing is), int64 on the
    device."""
    logits = torch.randn((rows, experts), generator=gen, device=device)
    ids = torch.multinomial(torch.softmax(logits, -1), 1, generator=gen)[:, 0]
    return torch.bincount(ids, minlength=experts)


def gmm_case(gen, sizes, K, N, dtype, device, label: str,
             rows_per_tile=None) -> dict:
    sizes = torch.as_tensor(sizes, dtype=torch.int64, device=device)
    M, E = int(sizes.sum()), sizes.numel()
    xs = _randn(gen, (M, K), dtype, device)
    w = (torch.randn((E, K, N), generator=gen, device=device)
         / K ** 0.5).to(dtype)
    got = moe_gmm.grouped_matmul(xs, w, sizes, rows_per_tile=rows_per_tile)
    torch.cuda.synchronize()
    want = moe_gmm.grouped_matmul_torch(xs, w, sizes)
    return {"kernel": "moe_gmm", "case": label, "rows": M, "experts": E,
            "K": K, "N": N, "dtype": str(dtype).removeprefix("torch."),
            "rows_per_tile": (rows_per_tile or moe_gmm.tile_rows(M, E)
                              if dtype == torch.bfloat16 else None),
            **compare(got, want, GMM_TOL[dtype], f"moe_gmm {label}")}


def gmm_checks(device, seed: int) -> list[dict]:
    """K5 at granite-moe-1b-a400m's shapes (prefill and decode, gate/up and
    down) and the corners: empty experts, one row, one expert holding five
    times the mean, row counts and widths off the tiles."""
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    cfg = get_config(MOE_ARCH)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
    slots = SERVE_BATCH * PROMPT_LEN * cfg.moe_top_k
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        prefill = routed_sizes(gen, slots, E, device)
        decode = routed_sizes(gen, SERVE_BATCH * cfg.moe_top_k, E, device)
        out.append(gmm_case(gen, prefill, d, f, dtype, device, "prefill gate"))
        out.append(gmm_case(gen, prefill, f, d, dtype, device, "prefill down"))
        out.append(gmm_case(gen, decode, d, f, dtype, device, "decode gate"))
        out.append(gmm_case(gen, [0, 300, 0, 0, 77, 1000, 0, 1], 1000, 200,
                            dtype, device, "empty experts, ragged widths"))
        out.append(gmm_case(gen, [0] * 5 + [1] + [0] * 26, d, f, dtype,
                            device, "one row"))
        out.append(gmm_case(gen, [50] * 7 + [5 * 57 + 1], 256, 128, dtype,
                            device, "one expert 5x the mean"))
        # The bf16 kernel's 64- and 128-row tiles: groups of exactly one
        # tile, group boundaries inside a tile, fewer rows than a tile, one
        # expert, and each tile height forced once against its usual choice.
        out.append(gmm_case(gen, [128, 64, 0, 128], d, f, dtype, device,
                            "groups of exactly one tile"))
        out.append(gmm_case(gen, [100, 90, 37, 200], d, f, dtype, device,
                            "boundaries inside tiles"))
        out.append(gmm_case(gen, [5, 0, 20], d, f, dtype, device,
                            "fewer rows than a tile"))
        out.append(gmm_case(gen, [300], f, d, dtype, device, "one expert"))
        out.append(gmm_case(gen, prefill, d, f, dtype, device,
                            "prefill gate, 64-row tiles", rows_per_tile=64))
        out.append(gmm_case(gen, decode, d, f, dtype, device,
                            "decode gate, 128-row tiles", rows_per_tile=128))
        out += served_gmm_checks(gen, dtype, device)
    return out


def served_gmm_checks(gen, dtype, device) -> list[dict]:
    """K5 at olmoe's and jamba's widths: olmoe's 64 experts (top-8, 2048 →
    1024) at its prefill's routed rows and at a decode step's 64 slots,
    where nearly every group holds 0, 1 or 2 rows (also one of only 0 and
    1 rows); jamba's 16 experts (top-2) at its prefill down projection
    14336 → 4096, the longest reduction of any served path."""
    out = []
    for arch, cases in (("olmoe_1b_7b", ("prefill gate", "decode gate")),
                        (HYBRID_ARCH, ("prefill down",))):
        cfg = served_config(arch)
        E, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
        for case in cases:
            tokens = SERVE_BATCH * (PROMPT_LEN if "prefill" in case else 1)
            sizes = routed_sizes(gen, tokens * cfg.moe_top_k, E, device)
            K, N = (f, d) if "down" in case else (d, f)
            out.append(gmm_case(gen, sizes, K, N, dtype, device,
                                f"{cfg.name} {case}"))
    out.append(gmm_case(gen, (torch.arange(64) % 3 != 0).long(), 2048, 1024,
                        dtype, device, "64 groups of 0 or 1 rows"))
    return out


def ssd_inputs(gen, B, S, H, G, N, dtype, device, P=64):
    """x, dt (softplus of a shifted normal: 0.02-0.2), A (-1..-H, as
    ``A_log = log(1..H)``), and B/C as strided views of one [B, S, 2GN]
    tensor, as the model slices them."""
    x = _randn(gen, (B, S, H, P), dtype, device)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=device) * 0.5 - 3.0)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=device)
    bc = _randn(gen, (B, S, 2 * G * N), dtype, device)
    return (x, dt, A, bc[..., :G * N].view(B, S, G, N),
            bc[..., G * N:].view(B, S, G, N))


def owned_channels(x, channels):
    """``x [B, S, H, P]`` with zeros outside the ``n`` channels from ``off``
    of its ``H * P`` (``channels = (off, n)``: a participant's block laid
    into whole-head slots, ``models/ssd.py``); the mask of those kept."""
    B, S, H, P = x.shape
    off, n = channels
    keep = torch.zeros(H * P, dtype=torch.bool, device=x.device)
    keep[off:off + n] = True
    keep = keep.reshape(H, P)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)), keep


def ssd_case(gen, B, S, H, G, N, chunk, dtype, device, h0=False,
             channels=None) -> dict:
    """The kernel against its plain version (where the chunk is whole
    16-step tiles: a shorter one-chunk S reaches the kernel padded, through
    ``ssd_chunked_cuda`` only), and ``ssd_chunked_cuda`` (kernel +
    recurrence) against the reference's plain chunked form.  ``channels``
    (``(off, n)``): x zero outside those channels, whose ``y`` and state
    must then be exactly zero too."""
    inputs = ssd_inputs(gen, B, S, H, G, N, dtype, device)
    keep = None
    if channels:
        x, keep = owned_channels(inputs[0], channels)
        inputs = (x, *inputs[1:])
    # The float32 kernel is held to the plain version in float64: seg
    # reaches a few hundred, and a float32 plain version's own rounding of
    # the decays' seg differences (~1e-4) would exceed the 2e-5 tolerance.
    ref_in = (tuple(t.double() for t in inputs) if dtype == torch.float32
              else inputs)
    Q = min(chunk, S)
    tol = ATTN_TOL[dtype]
    label = f"B{B} S{S} H{H} G{G} N{N} Q{Q}" + (" h0" if h0 else "") + (
        f" channels {channels[0]}+{channels[1]}" if channels else "")
    res = {"kernel": "ssd_scan", "case": label,
           "dtype": str(dtype).removeprefix("torch.")}
    if dtype == torch.bfloat16 and Q % ssd_scan.CHUNK_MULTIPLE == 0:
        res["heads_per_block"] = ssd_scan.head_group_plan(
            B, S, H, G, N, Q, sms=sm_count(device))
    if Q % ssd_scan.CHUNK_MULTIPLE == 0:
        got = ssd_scan.ssd_intra_chunk(*inputs, Q)
        torch.cuda.synchronize()
        check(got[0].dtype == torch.float32, "y_intra is not float32")
        want = ssd_scan.ssd_intra_chunk_torch(*ref_in, Q)
        for name, g, w in zip(("y", "states", "seg"), got, want):
            res[name] = compare(g, w, tol, f"ssd_intra_chunk {label} {name}")
    init = (torch.randn((B, H, 64, N), generator=gen, device=device)
            if h0 else None)
    y, h = ssd_chunked_cuda(*inputs, chunk, h0=init)
    torch.cuda.synchronize()
    h0_ref = init.double() if init is not None and ref_in is not inputs \
        else init                      # the f32 state as it is, for bf16
    y_ref, h_ref = ssd_chunked_plain(*ref_in, chunk, h0=h0_ref)
    res["chunked_y"] = compare(y, y_ref, tol, f"ssd_chunked_cuda {label} y")
    res["chunked_state"] = compare(h, h_ref, tol,
                                   f"ssd_chunked_cuda {label} state")
    if keep is not None:
        res["foreign_channels_zero"] = bool(
            not y.masked_select(~keep).any()
            and not h.masked_select(~keep[..., None]).any())
        check(res["foreign_channels_zero"],
              f"ssd_chunked_cuda {label}: a zero channel's y or state is "
              "not zero")
    res["max_abs_err"] = max(v["max_abs_err"] for v in res.values()
                             if isinstance(v, dict))
    return res


def ssd_checks(device, seed: int) -> list[dict]:
    """K4 at mamba2-130m's prefill shape and the corners: G > 1, one chunk
    (chunk > S, also of 12 and 100 steps, which ``ssd_chunked_cuda`` pads
    to the kernel's 16-step tiles), a nonzero initial state, N 16 (jamba),
    Q 64; and shapes where the bf16 kernel's blocks take 2 or 3 heads."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    cfg = get_config(SSM_ARCH)
    H, G, N, Q = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        out.append(ssd_case(gen, SERVE_BATCH, PROMPT_LEN, H, G, N, Q, dtype,
                            device))
        out.append(ssd_case(gen, 2, 512, 8, 2, 64, 256, dtype, device,
                            h0=True))
        out.append(ssd_case(gen, 2, 128, 4, 1, N, 256, dtype, device,
                            h0=True))
        out.append(ssd_case(gen, 2, 256, 4, 4, 16, 64, dtype, device))
        out.append(ssd_case(gen, 2, 12, 4, 1, N, 256, dtype, device))
        out.append(ssd_case(gen, 2, 100, 8, 2, 64, 256, dtype, device,
                            h0=True))
        # Shapes where the bf16 kernel's plan puts several heads of a
        # G > 1 group in a block: 2 heads at N 16 and Q 64 and at N 128 and
        # Q 256, 3 heads at N 16 and Q 64 (the corners above take 1 head,
        # mamba2's prefill 3 in 256 blocks: a ragged second wave).
        out.append(ssd_case(gen, 3, 256, 12, 2, 16, 64, dtype, device))
        out.append(ssd_case(gen, 3, PROMPT_LEN, 12, 2, N, Q, dtype, device))
        out.append(ssd_case(gen, 3, PROMPT_LEN, 6, 2, 16, 64, dtype, device))
        # jamba's prefill: 128 heads (d_inner 8192 / 64) on one B/C group,
        # N 16: 2 heads a block, 2048 blocks in 15.5 waves of an H100.
        jcfg = served_config(HYBRID_ARCH)
        out.append(ssd_case(gen, SERVE_BATCH, PROMPT_LEN, jcfg.ssm_heads,
                            jcfg.ssm_groups, jcfg.ssm_state, jcfg.ssm_chunk,
                            dtype, device))
    return out


def gmm_bound(sizes, K, N, dtype) -> dict:
    """``roofline.gmm_work`` of these group sizes: the experts that have
    rows are the active ones."""
    return roofline.work_bound(roofline.gmm_work(
        int(sizes.sum()), K, N, int((sizes > 0).sum()), dtype))


def grouped_mm_library(xs, w, sizes):
    """PyTorch's own grouped product (``torch._grouped_mm``) where this
    build has it, else a per-expert ``torch.matmul`` loop; returns
    (callable, name)."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        return (lambda: torch._grouped_mm(xs, w, offs=offs)), \
            "torch._grouped_mm"
    bounds = [0] + torch.cumsum(sizes, 0).tolist()
    groups = [(e, bounds[e], bounds[e + 1]) for e in range(sizes.numel())
              if bounds[e + 1] > bounds[e]]

    def loop():
        return [xs[a:b] @ w[e] for e, a, b in groups]
    return loop, "torch.matmul per expert"


def moe_ssd_timings(device, seed: int, flush, replaced=None) -> dict:
    """K5 at granite-moe-1b-a400m's prefill gate/up launch (65536 routed
    rows over 32 experts, 1024 → 512, bf16), its prefill down launch
    (512 → 1024), a decode step's gate/up (64 rows) and a training step's
    gate/up (32768 rows at 8 × 512 tokens), and the same three serving
    launches at olmoe-1b-7b's widths (64 experts top-8, 2048 → 1024) and
    jamba-v0.1-52b's (16 experts top-2, 4096 → 14336), each beside its
    plain version, ``torch._grouped_mm`` and (``replaced``) the body it
    replaced; and K4 at mamba2-130m's prefill (8 × 1024 steps, 24 heads,
    P 64, N 128, chunk 256, bf16) and jamba's (128 heads, N 16)."""
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    bf = torch.bfloat16
    rows = SERVE_BATCH * PROMPT_LEN
    B_train, S_train = TRAIN_SHAPES[MOE_ARCH]
    launches = []
    for prefix, arch in (("", MOE_ARCH), ("olmoe_", "olmoe_1b_7b"),
                         ("jamba_", HYBRID_ARCH)):
        cfg = served_config(arch)
        d, f = cfg.d_model, cfg.expert_d_ff
        launches += [(cfg, f"{prefix}prefill", rows, d, f),
                     (cfg, f"{prefix}prefill_down", rows, f, d),
                     (cfg, f"{prefix}decode", SERVE_BATCH, d, f)]
        if arch == MOE_ARCH:
            launches.append((cfg, "train", B_train * S_train, d, f))
    out = {}
    for cfg, label, tokens, K, N in launches:
        E = cfg.moe_experts
        sizes = routed_sizes(gen, tokens * cfg.moe_top_k, E, device)
        xs = _randn(gen, (int(sizes.sum()), K), bf, device)
        w = (torch.randn((E, K, N), generator=gen, device=device)
             / K ** 0.5).to(bf)
        lib, lib_name = grouped_mm_library(xs, w, sizes)

        def kernel():
            return moe_gmm.grouped_matmul(xs, w, sizes)
        fns = with_replaced({
            "ms": kernel,
            "plain_ms": lambda: moe_gmm.grouped_matmul_torch(xs, w, sizes),
            "library_ms": lib,
        }, replaced and replaced.body(
            "moe_gmm", lambda: replaced.gmm(xs, w, sizes)), kernel,
            "moe_gmm", GMM_TOL[bf])
        t = measure_fns(fns, flush, rounds=4 if label.endswith("decode")
                        else 2)
        M = int(sizes.sum())
        t.update(rows=M, experts=E, K=K, N=N,
                 active_experts=int((sizes > 0).sum()),
                 largest_group=int(sizes.max()), library=lib_name,
                 rows_per_tile=moe_gmm.tile_rows(M, E),
                 dtype="bfloat16", **gmm_bound(sizes, K, N, bf))
        out[f"moe_gmm_{label}"] = t
        del xs, w
    for key, arch in (("ssd_scan", SSM_ARCH),
                      ("ssd_scan_jamba", HYBRID_ARCH)):
        out[key] = ssd_timing(gen, device, flush, arch, replaced)
    return out


def gmm_backward_case(gen, sizes, K, N, device, label: str,
                      need=(True, True)) -> dict:
    """One K5 backward call on bf16 CUDA tensors (``xs`` N(0, 1), ``w``
    N(0, 1 / K), the output's gradient N(0, 1)) inside
    ``torch.autograd.grad`` under ``set_sync_debug_mode("error")`` (a host
    sync raises): its launches (``BACKWARD_LAUNCHES``: one for each input
    in ``need``, none on zero rows), ``dX`` and ``dW`` against the plain
    forms within ``GMM_BWD_TOL``, and ``dW`` of every empty expert exactly
    zero."""
    bf = torch.bfloat16
    sizes = torch.as_tensor(sizes, dtype=torch.int64, device=device)
    M, E = int(sizes.sum()), sizes.numel()
    xs = _randn(gen, (M, K), bf, device).requires_grad_(need[0])
    w = (torch.randn((E, K, N), generator=gen, device=device)
         / K ** 0.5).to(bf).requires_grad_(need[1])
    g = _randn(gen, (M, N), bf, device)
    y = moe_gmm.grouped_matmul(xs, w, sizes)
    wrt = [t for t in (xs, w) if t.requires_grad]
    torch.cuda.synchronize()
    before = moe_gmm.BACKWARD_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = list(torch.autograd.grad(y, wrt, g))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = moe_gmm.BACKWARD_LAUNCHES - before
    torch.cuda.synchronize()
    want = sum(need) if M else 0
    check(launched == want, f"moe_gmm backward {label}: {launched} "
                            f"launches, expected {want}")
    out = {"kernel": "moe_gmm_backward", "case": label, "rows": M,
           "experts": E, "K": K, "N": N, "launches": launched,
           "empty_experts": int((sizes == 0).sum()),
           "sync_debug_mode": "error"}
    if need[0]:
        out["dx"] = compare(grads.pop(0), moe_gmm.grouped_matmul_dx_torch(
            g, w.detach(), sizes), GMM_BWD_TOL, f"moe_gmm dX {label}")
    if need[1]:
        dw = grads.pop(0)
        out["dw"] = compare(dw, moe_gmm.grouped_matmul_dw_torch(
            xs.detach(), g, sizes), GMM_BWD_TOL, f"moe_gmm dW {label}")
        check(not bool(dw[sizes == 0].any()),
              f"moe_gmm dW {label}: an empty expert's gradient is not zero")
    return out


def gmm_backward_checks(device, seed: int) -> list[dict]:
    """K5's backward at granite-moe-1b-a400m's training launches (8 x 512
    tokens, top 8: 32 768 routed rows over 32 experts; gate/up 1024 → 512
    and down 512 → 1024): uniform routing, skewed routing with five
    experts or more empty, a row count off 64, one expert holding every
    row; then zero rows and each input's gradient alone."""
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    cfg = get_config(MOE_ARCH)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
    B, S = TRAIN_SHAPES[MOE_ARCH]
    rows = B * S * cfg.moe_top_k

    def drawn(n, probs):
        ids = torch.multinomial(probs, n, replacement=True, generator=gen)
        return torch.bincount(ids, minlength=E)

    uniform = torch.full((E,), 1.0 / E, device=device)
    skew = torch.softmax(3 * torch.randn(E, generator=gen, device=device), 0)
    skew[torch.randperm(E, generator=gen, device=device)[:5]] = 0
    routings = {"uniform": drawn(rows, uniform),
                "skewed, 5 or more experts empty": drawn(rows, skew),
                f"uniform, {rows - 37} rows": drawn(rows - 37, uniform),
                "one expert holds every row": [0] * 7 + [rows] + [0] * 24}
    out = []
    for label, sizes in routings.items():
        for proj, K, N in (("gate/up", d, f), ("down", f, d)):
            if label.startswith("one expert") and proj == "down":
                continue
            out.append(gmm_backward_case(gen, sizes, K, N, device,
                                         f"{proj}, {label}"))
    out.append(gmm_backward_case(gen, [0] * E, d, f, device, "no rows"))
    for need in ((True, False), (False, True)):
        out.append(gmm_backward_case(
            gen, routings["uniform"], d, f, device,
            f"gate/up, {'dX' if need[0] else 'dW'} alone", need=need))
    return out


def grouped_mm_backward(xs, w, sizes, g):
    """``torch._grouped_mm``'s backward through autograd, where this torch
    has the op and differentiates it; else None."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    xl, wl = xs.detach().requires_grad_(), w.detach().requires_grad_()
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    try:
        y = torch._grouped_mm(xl, wl, offs=offs)
        torch.autograd.grad(y, (xl, wl), g, retain_graph=True)
    except RuntimeError:
        return None
    return lambda: torch.autograd.grad(y, (xl, wl), g, retain_graph=True)


def gmm_backward_timings(device, seed: int, flush) -> dict:
    """K5's backward at granite-moe-1b-a400m's training launches (32 768
    routed rows over 32 experts, ``routed_sizes``' uneven routing; gate/up
    1024 → 512 and down 512 → 1024, bf16): the ``dX`` and ``dW`` kernels
    alone, both through ``torch.autograd.grad`` (``ms``: one backward
    call), the plain backward (``PlainGradient``: the plain version's
    autograd, as before the kernels) and ``torch._grouped_mm``'s backward
    where this torch differentiates it, by CUDA events with L2 displaced,
    in turns, beside each kernel's bound (``dW`` writes every expert's
    weights)."""
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    bf = torch.bfloat16
    cfg = get_config(MOE_ARCH)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.expert_d_ff
    B, S = TRAIN_SHAPES[MOE_ARCH]
    out = {}
    for label, K, N in (("gate_up", d, f), ("down", f, d)):
        sizes = routed_sizes(gen, B * S * cfg.moe_top_k, E, device)
        M = int(sizes.sum())
        xs = _randn(gen, (M, K), bf, device).requires_grad_()
        w = (torch.randn((E, K, N), generator=gen, device=device)
             / K ** 0.5).to(bf).requires_grad_()
        g = _randn(gen, (M, N), bf, device)
        s32 = sizes.to(torch.int32)
        y = moe_gmm.grouped_matmul(xs, w, sizes)
        y_plain = PlainGradient.apply(
            functools.partial(moe_gmm._launch, rows_per_tile=None),
            moe_gmm.grouped_matmul_torch, xs, w, sizes)
        fns = {
            "dx_ms": lambda: moe_gmm._launch_dx(g, w.detach(), s32),
            "dw_ms": lambda: moe_gmm._launch_dw(xs.detach(), g, s32),
            "ms": lambda: torch.autograd.grad(y, (xs, w), g,
                                              retain_graph=True),
            "plain_ms": lambda: torch.autograd.grad(y_plain, (xs, w), g,
                                                    retain_graph=True),
        }
        lib = grouped_mm_backward(xs, w, sizes, g)
        if lib is not None:
            fns["library_ms"] = lib
        t = measure_fns(fns, flush, rounds=2)
        active = int((sizes > 0).sum())
        dx_b = roofline.work_bound(roofline.gmm_work(M, N, K, active, bf))
        dw_b = roofline.work_bound(roofline.gmm_work(M, K, N, E, bf))
        t.update(rows=M, experts=E, K=K, N=N, active_experts=active,
                 largest_group=int(sizes.max()),
                 library="torch._grouped_mm" if lib else None,
                 dx_bound_ms=dx_b["bound_ms"], dx_bound_by=dx_b["bound_by"],
                 dw_bound_ms=dw_b["bound_ms"], dw_bound_by=dw_b["bound_by"],
                 bound_ms=dx_b["bound_ms"] + dw_b["bound_ms"],
                 dx_share=dx_b["bound_ms"] / t["dx_ms"],
                 dw_share=dw_b["bound_ms"] / t["dw_ms"],
                 share=(dx_b["bound_ms"] + dw_b["bound_ms"]) / t["ms"])
        out[f"moe_gmm_backward_{label}"] = t
        del xs, w, g, y, y_plain, fns, lib
    return out


def ssd_timing(gen, device, flush, arch: str, replaced) -> dict:
    """K4 at ``arch``'s prefill (8 x 1024 steps, P 64, bf16) beside its
    plain version and (``replaced``) the body it replaced."""
    bf = torch.bfloat16
    scfg = get_config(arch)
    H, G, N, Q = scfg.ssm_heads, scfg.ssm_groups, scfg.ssm_state, \
        scfg.ssm_chunk
    x, dt, A, Bm, Cm = ssd_inputs(gen, SERVE_BATCH, PROMPT_LEN, H, G, N, bf,
                                  device)

    def ssd_kernel():
        return ssd_scan.ssd_intra_chunk(x, dt, A, Bm, Cm, Q)
    t = measure_fns(with_replaced({
        "ms": ssd_kernel,
        "plain_ms": lambda: ssd_scan.ssd_intra_chunk_torch(
            x, dt, A, Bm, Cm, Q),
    }, replaced and replaced.body(
        "ssd_scan", lambda: replaced.ssd(x, dt, A, Bm, Cm, Q)), ssd_kernel,
        "ssd_scan", ATTN_TOL[bf]), flush, rounds=2)
    t.update(shape=[SERVE_BATCH, PROMPT_LEN, H, 64], groups=G, state=N,
             chunk=Q, dtype="bfloat16", library_ms=None, path=scfg.name,
             heads_per_block=ssd_scan.head_group_plan(
                 SERVE_BATCH, PROMPT_LEN, H, G, N, Q, sms=sm_count(device)),
             **roofline.work_bound(roofline.ssd_work(
                 SERVE_BATCH, PROMPT_LEN, H, G, N, Q, bf)))
    return t


# -- the serving path ------------------------------------------------------------

class Recorder:
    """Wraps a model's ``prefill`` / ``decode`` to keep each call's input
    tokens and output logits, CUDA events around each call and the host
    time each call takes to enqueue its work."""

    def __init__(self, model) -> None:
        self.tokens: list = []
        self.logits: list = []
        self.events: list = []
        self.host_ms: list = []
        self.counts: list = []
        for name in ("prefill", "decode"):
            fn = getattr(model, name)
            setattr(model, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(params, inputs, cache):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            logits, cache = fn(params, inputs, cache)
            self.host_ms.append((name, (time.perf_counter() - t0) * 1e3))
            end.record()
            tokens = inputs["tokens"] if name == "prefill" else inputs
            self.tokens.append(tokens.clone())
            self.logits.append(logits.clone())
            self.events.append((name, start, end))
            self.counts.append(kernel_counts())
            return logits, cache
        return call

    def reset(self) -> None:
        self.tokens.clear()
        self.logits.clear()
        self.events.clear()
        self.host_ms.clear()
        self.counts.clear()

    def launches_per_call(self) -> list[dict]:
        """Kernel launches of each recorded call (counter differences)."""
        out, prev = [], {k: 0 for k in self.counts[0]}
        for now in self.counts:
            out.append({k: now[k] - prev[k] for k in now})
            prev = now
        return out

    def ms(self, name: str) -> list[float]:
        return [a.elapsed_time(b) for n, a, b in self.events if n == name]

    def enqueue_ms(self, name: str) -> list[float]:
        return [t for n, t in self.host_ms if n == name]


def profile_decode(model, params, tokens: list, extra=None,
                   max_len: int | None = None) -> dict:
    """One decode step of the kernel path under ``torch.profiler``: the
    device time of its kernels against the step's wall time (host clock to
    a synchronisation), after a prefill and one unprofiled step.  ``extra``:
    more inputs of the batch (an encoder-decoder's frame embeddings, a
    VLM's patch embeddings)."""
    from torch.profiler import ProfilerActivity, profile

    batch = {"tokens": tokens[0], **(extra or {})}
    cache = model.init_cache(params, batch, max_len or MAX_LEN)
    _, cache = model.prefill(params, batch, cache)
    _, cache = model.decode(params, tokens[1], cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode(params, tokens[2], cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if not busy:
        return {"device_busy_ms": "not measured", "step_wall_ms": wall_ms}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernel_launches": sum(1 for e in prof.events() if e.device_type
                                   == torch.autograd.DeviceType.CUDA),
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def serve_requests(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [Request(f"r{i}", rng.integers(0, cfg.vocab, PROMPT_LEN).astype(
        np.int32), max_new_tokens=MAX_NEW) for i in range(SERVE_BATCH)]


def teacher_forced(model, params, tokens: list, extra=None,
                   max_len: int | None = None) -> list:
    """Prefill ``tokens[0]``, then decode each later entry; the logits.
    ``extra``: more inputs of the batch (an encoder-decoder's frame
    embeddings, which ``init_cache`` encodes; a VLM's patch embeddings,
    which the prefill puts ahead of the prompt)."""
    batch = {"tokens": tokens[0], **(extra or {})}
    cache = model.init_cache(params, batch, max_len or MAX_LEN)
    logits, cache = model.prefill(params, batch, cache)
    out = [logits]
    for tok in tokens[1:]:
        logits, cache = model.decode(params, tok, cache)
        out.append(logits)
    return out


def logit_errors(got: list, want: list, vocab: int) -> dict:
    """Per-step relative RMS error, max abs error, argmax agreement over the
    first ``vocab`` columns (the padded columns hold the -1e30 mask, which
    bf16 and float32 round differently)."""
    check(len(got) == len(want), f"{len(got)} steps vs {len(want)}")
    rel, max_abs, agree = [], 0.0, []
    for g, w in zip(got, want):
        g, w = g[..., :vocab].float(), w[..., :vocab].float()
        check(bool(torch.isfinite(g).all()), "non-finite logits")
        d = g - w
        rel.append(float(d.norm() / w.norm()))
        max_abs = max(max_abs, float(d.abs().max()))
        agree.append(float((g.argmax(-1) == w.argmax(-1)).float().mean()))
    return {"steps": len(got), "max_rel_rms": max(rel),
            "rel_rms_per_step": rel, "max_abs_err": max_abs,
            "argmax_agreement_min": min(agree)}


def served_config(arch: str):
    """``arch``'s config as served: cut to its ``SERVE_PATHS`` depth (or
    ``VLM_LAYERS``) where one is set, at the published width."""
    cfg = get_config(arch)
    layers = VLM_LAYERS if arch == VLM_ARCH else SERVE_PATHS.get(arch)
    return replace(cfg, n_layers=layers).validate() if layers else cfg


def serve_max_len(cfg) -> int:
    """The cache a served batch fills: its frontend's embeddings (a VLM's
    patches), the prompt, the new tokens and 8 positions spare."""
    return cfg.frontend_tokens + MAX_LEN


def cut_params(params, cfg, layers: int):
    """The first ``layers`` layers of a stacked parameter tree (views), at
    least one whole period of the layer pattern (the slots are stacked per
    period: jamba's variant keeps 8 layers whatever ``layers`` asks); an
    encoder-decoder's encoder and decoder both."""
    period = len(cfg.pattern())
    blocks = -(-layers // period)

    def cut(tree_):
        return {k: {n: t[:blocks] for n, t in slot.items()}
                for k, slot in tree_.items()}
    if cfg.enc_layers:
        return ({**params, "enc_blocks": cut(params["enc_blocks"]),
                 "dec_blocks": cut(params["dec_blocks"])},
                replace(cfg, n_layers=layers, enc_layers=layers))
    return ({**params, "blocks": cut(params["blocks"])},
            replace(cfg, n_layers=blocks * period))


SERVING_KERNELS = (flash_attention, decode_attention, ssd_scan, moe_gmm)
#: The reference's plain forms of the three kernel paths.
PLAIN_FORMS = dict(attention_impl="dense", moe_impl="ragged",
                   ssm_impl="chunked")


def kernel_counts() -> dict:
    return {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES
            for m in SERVING_KERNELS}


def zero_counts() -> None:
    for m in (*SERVING_KERNELS, bigroots_gates):
        m.LAUNCHES = 0


def expected_launches(cfg) -> tuple[dict, dict]:
    """Kernel launches of one prefill and of one decode step: K2 and K3
    once per attention layer, K4 once per SSM layer of the prefill (the
    decode step is the plain recurrent update), K5 three times per MoE
    layer of both."""
    nb, pattern = cfg.n_blocks, cfg.pattern()
    attn = nb * sum(s.mixer == "attn" for s in pattern)
    ssm = nb * sum(s.mixer == "ssm" for s in pattern)
    moe = nb * sum(s.ffn == "moe" for s in pattern)
    prefill = {"flash_attention": attn, "decode_attention": 0,
               "ssd_scan": ssm, "moe_gmm": 3 * moe}
    step = {"flash_attention": 0, "decode_attention": attn, "ssd_scan": 0,
            "moe_gmm": 3 * moe}
    return prefill, step


class Routing:
    """Records one run's routing through ``moe.routing_hook`` and replays
    it in another.  Top-k routing is discontinuous: two runs that differ
    only by rounding pick other experts wherever the k-th and (k+1)-th
    router probabilities nearly tie, and one such token moves every later
    position's logits.  Replayed, both runs route alike, so their logits
    measure the kernels; the replaying run's own top-k choices that differ
    from the recorded ones are counted and held to ``ROUTING_FLIP_SHARE``,
    since a kernel error upstream of a router would move many."""

    def __init__(self) -> None:
        self.recorded: list = []

    def _source(self, call: int) -> int:
        """The recorded call that router call ``call`` replays."""
        return call

    def _keep(self, probs, experts) -> None:
        self.recorded.append(experts)

    def record(self):
        def keep(probs, experts):
            self._keep(probs, experts)
            return experts
        return moe_layer.routing_hook(keep)

    @contextlib.contextmanager
    def replay(self):
        """Yields ``{"routings": slots replayed, "flips": ..., "moved":
        ...}``: ``moved`` counts the replaying run's experts that are not
        among the recorded ones (one changed expert of a top-k moves one
        slot), the count the bf16 limit holds; ``flips`` the positions
        where the two top-k lists, each sorted by expert id, differ (one
        changed expert may shift up to k of them), the count the float32
        limit holds."""
        tally = {"routings": 0, "flips": 0, "moved": 0}
        seen = [0]

        def pin(probs, experts):
            call = seen[0]
            seen[0] += 1
            pinned = (self.recorded[self._source(call)]
                      if call < len(self.recorded) else None)
            check(pinned is not None and pinned.shape == experts.shape,
                  "the replaying run routes other tokens than the recorded")
            tally["routings"] += pinned.numel()
            tally["flips"] += int((experts.sort(-1).values
                                   != pinned.sort(-1).values).sum())
            tally["moved"] += int((experts[..., :, None]
                                   != pinned[..., None, :]).all(-1).sum())
            return pinned
        with moe_layer.routing_hook(pin):
            yield tally
        check(seen[0] == len(self.recorded),
              "the replaying run routed fewer times than the recorded")


def flip_share(tally: dict, dtype: str = "bfloat16") -> float:
    """The share of replayed slots that ``dtype``'s limit holds."""
    return (tally[ROUTING_TALLY[dtype]] / tally["routings"]
            if tally["routings"] else 0.0)


def routing_ok(sound: list, control: dict | None = None) -> bool:
    """The bf16 routing check: every sound run's moved share within
    ``ROUTING_FLIP_SHARE``, and the control's past it (a run that routes
    nothing holds no check)."""
    limit = ROUTING_FLIP_SHARE["bfloat16"]
    if control is not None and control["routings"] and \
            flip_share(control) <= limit:
        return False
    return all(flip_share(t) <= limit for t in sound)


#: Per slot kind, the weights whose products feed the kernels.
CONTROL_WEIGHTS = {"attn": ("wq", "wk", "wv"),
                   "moe": ("w_gate", "w_up", "w_down"), "ssm": ("wx", "wbc")}


def rounded(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` rounded to ``bits`` significant bits (float32 temporaries)."""
    m, e = torch.frexp(t.float())
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e)


def coarsen_in_place(params, bits: int) -> None:
    """``coarse_params`` written into ``params`` itself, 16 M elements at a
    time: a participant's block of jamba's experts leaves no room for a
    rounded copy beside it."""
    for key in ("blocks", "enc_blocks", "dec_blocks"):
        for slot_key, slot in params.get(key, {}).items():
            for name in CONTROL_WEIGHTS.get(slot_key.rsplit("_", 1)[-1], ()):
                for chunk in slot[name].view(-1).split(1 << 24):
                    chunk.copy_(rounded(chunk, bits))


def seeded_block(cfg, seed: int, device, part=None) -> dict:
    """``Model(cfg).init`` from a generator seeded ``seed`` on ``device``,
    as served (``cast_params``: ``cfg.dtype``, the norms kept), drawn leaf
    by leaf (``Model.init``'s ``leaf``): ``part``'s block of every leaf
    (``param_block``), or with no ``part`` the whole tree.  The card holds
    the tree built so far and one float32 leaf at a time, never the
    float32 master (jamba's 8 layers: 53 GB)."""
    def dtype(path, t):
        return served_dtype(cfg, path[-1], t.dtype)
    if part is None:
        leaf = lambda path, t: t.to(dtype(path, t))  # noqa: E731
    else:
        leaf = param_block(cfg, part.mesh, part.coord, dtype)
    return Model(cfg).init(torch.Generator(device=device).manual_seed(seed),
                           leaf=leaf)


def coarse_params(params, bits: int):
    """``params`` with the ``CONTROL_WEIGHTS`` rounded to ``bits``
    significant bits (the rest shared, not copied).  A slot's kind is the
    last word of its key: ``L0_attn``, or an encoder-decoder's ``attn``,
    ``self_attn`` and ``cross_attn``.  Rounded one block at a time: the
    float32 temporaries of a whole stacked leaf (olmoe's 16 layers of 64
    experts) would not fit beside the model."""
    def coarse(t):
        out = torch.empty_like(t)
        for i, blk in enumerate(t):
            out[i] = rounded(blk, bits)
        return out

    def blocks(tree_):
        out = {}
        for key, slot in tree_.items():
            names = CONTROL_WEIGHTS.get(key.rsplit("_", 1)[-1], ())
            out[key] = {n: coarse(t) if n in names else t
                        for n, t in slot.items()}
        return out
    return {**params, **{k: blocks(params[k]) for k in
                         ("blocks", "enc_blocks", "dec_blocks")
                         if k in params}}


def phase_serve(args, card: str, device, arch: str) -> dict:
    """Serve ``arch`` at full width (at its ``SERVE_PATHS`` depth) through
    ``ServeEngine``, with the launch counters zeroed just before the run
    and read after every call; then hold the logits to the plain forms and
    to a float32 model."""
    t_phase = time.perf_counter()
    cfg = served_config(arch)
    check((cfg.attention_impl, cfg.moe_impl, cfg.ssm_impl)
          == ("cuda", "gmm", "cuda"), "the default is not the kernel path")
    def master():
        """The seeded float32 parameters (drawn again, the same values,
        whenever they are needed)."""
        return Model(cfg).init(
            torch.Generator(device=device).manual_seed(args.seed))

    # The engine's bf16 copy is cast from the master leaf by leaf, each
    # float32 leaf freed as it goes: the master and the copy together do not
    # fit one card for jamba at 8 layers (53 + 27 GB).  The master is drawn
    # again for the float32 reference once the engine is gone.
    t0 = time.perf_counter()
    served = cast_params(master(), cfg, device, in_place=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    rec = Recorder(model)
    timeline = ResourceTimeline()
    telem = StepTelemetry("host0", timeline=timeline, window=64,
                          streaming=True)
    t0 = time.perf_counter()
    engine = ServeEngine(
        model, served, max_len=MAX_LEN, batch_size=SERVE_BATCH,
        telemetry=telem, device=device,
        diagnosis=Diagnosis.local(BigRootsAnalyzer(
            JAX_FEATURES, timelines=timeline, device=device)))
    del served                  # the engine holds the same tensors
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0
    # Warm-up (cuBLAS handles, the kernels' libraries): 2 new tokens.
    engine.run([Request(r.request_id, r.prompt, 2)
                for r in serve_requests(cfg, args.seed + 1)])
    rec.reset()

    requests = serve_requests(cfg, args.seed)
    routing = Routing()
    zero_counts()
    t0 = time.perf_counter()
    with routing.record():
        engine.run(requests, step_offset=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    steps = len(rec.ms("decode"))
    check(steps == MAX_NEW, f"{steps} decode steps")
    per_call = rec.launches_per_call()
    want_prefill, want_step = expected_launches(cfg)
    check(per_call[0] == want_prefill,
          f"{arch} prefill launched {per_call[0]}, expected {want_prefill}")
    for n, got in enumerate(per_call[1:]):
        check(got == want_step, f"{arch} decode step {n} launched {got}, "
                                f"expected {want_step}")
    check(list(rec.tokens[0].shape) == [SERVE_BATCH, PROMPT_LEN],
          "prefill batch shape")
    toks = sum(len(r.output) for r in requests)
    check(toks == SERVE_BATCH * MAX_NEW, f"{toks} tokens generated")
    check(all(0 <= t < cfg.vocab for r in requests for t in r.output),
          "a token outside the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    decode_ms = rec.ms("decode")
    run = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "published_layers": get_config(arch).n_layers,
        "d_model": cfg.d_model,
        "pattern": [s.name for s in cfg.pattern()],
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=True),
        "param_dtype": cfg.param_dtype,
        "served_dtype": cfg.dtype, "requests": len(requests),
        "prompt_len": PROMPT_LEN, "new_tokens": MAX_NEW, "max_len": MAX_LEN,
        "gpu": card, "init_s": init_s, "cast_s": cast_s,
        "prefill_ms": rec.ms("prefill")[0],
        "prefill_engine_s": engine.last_prefill_seconds,
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_enqueue_ms_median": statistics.median(
            rec.enqueue_ms("decode")),
        "decode_ms_per_step": decode_ms, "wall_s": wall,
        "tokens_per_s": toks / wall,
        "peak_memory_gb": peak / 1e9, "launches": launches,
        "launches_per_prefill": want_prefill,
        "launches_per_decode_step": want_step,
        "live_root_causes": len(engine.live_root_causes),
    }

    # The reference's plain forms, teacher-forced with the kernel path's
    # own tokens (prompt, then each step's input) and its routing: in bf16
    # on the engine's weights and on the control's, and in float32 on the
    # f32 weights.
    plain = replace(cfg, **PLAIN_FORMS)
    with routing.replay() as flips16:
        plain16 = teacher_forced(Model(plain), engine.params, rec.tokens)
    with routing.replay() as flips_c:
        control16 = teacher_forced(
            Model(plain), coarse_params(engine.params, CONTROL_BITS),
            rec.tokens)
    check(kernel_counts() == launches, "the plain forms launched a kernel")
    run["decode_profile"] = profile_decode(Model(cfg), engine.params,
                                           rec.tokens)
    del engine
    torch.cuda.empty_cache()
    params = master()
    with routing.replay() as flips32:
        ref32 = teacher_forced(Model(replace(plain, dtype="float32")),
                               params, rec.tokens)
    limit = SERVE_BF16_KERNEL_VS_PLAIN[arch]
    bf16 = run["bf16_vs_f32"] = {
        "kernel_path": logit_errors(rec.logits, ref32, cfg.vocab),
        "plain_forms": logit_errors(plain16, ref32, cfg.vocab),
        "kernel_vs_plain": logit_errors(rec.logits, plain16, cfg.vocab),
        "control_vs_plain": logit_errors(control16, plain16, cfg.vocab),
        "control_bits": CONTROL_BITS, "margin": SERVE_BF16_MARGIN,
        "kernel_vs_plain_limit": limit,
        "routing_flips": {"plain_forms": flips16, "float32": flips32,
                          "control": flips_c},
        "routing_flip_limit": ROUTING_FLIP_SHARE["bfloat16"]}
    del plain16, control16, ref32, rec
    torch.cuda.empty_cache()

    # float32, depth cut (to whole periods of the layer pattern): greedy
    # tokens must equal those of the plain forms with float64 activations
    # (the oracle of the kernel path's numerics: the chunked SSD then scans
    # in float64, as K4 does), teacher-forced with the kernel run's tokens
    # and routing; the logits agree to 1e-4.  The plain forms cast each
    # float32 weight per use, as the reference does: a float64 copy of
    # jamba's 8 layers (106 GB) would not fit.
    p32, cfg32 = cut_params(params, replace(cfg, dtype="float32"),
                            args.f32_layers)
    routing = Routing()
    m32 = Model(cfg32)
    r32 = Recorder(m32)
    with routing.record():
        ServeEngine(m32, p32, max_len=MAX_LEN, batch_size=SERVE_BATCH,
                    device=device).run(serve_requests(cfg, args.seed))
    with routing.replay() as tally:
        p64 = teacher_forced(Model(replace(cfg32, dtype="float64",
                                           **PLAIN_FORMS)), p32, r32.tokens)
    f32 = run["f32_variant"] = {
        "layers": cfg32.n_layers,
        "tokens_equal": all(torch.equal(a[:, -1].argmax(-1),
                                        b[:, -1].argmax(-1))
                            for a, b in zip(r32.logits, p64)),
        "tolerance_rel_rms": SERVE_F32_REL_RMS,
        "routing_flips": tally,
        "routing_flip_limit": ROUTING_FLIP_SHARE["float32"],
        **logit_errors(r32.logits, p64, cfg.vocab)}
    del p32, p64, r32, params
    run["seconds"] = time.perf_counter() - t_phase

    # Every reading is taken before any is judged.
    failed = [msg for ok, msg in (
        (bf16["kernel_path"]["max_rel_rms"]
         <= SERVE_BF16_MARGIN * bf16["plain_forms"]["max_rel_rms"],
         "bf16 kernel path further from float32 than the plain forms"),
        (bf16["kernel_vs_plain"]["max_rel_rms"] <= limit,
         "bf16 kernel path further from the plain forms than the limit"),
        (bf16["control_vs_plain"]["max_rel_rms"] > limit,
         "the control lies inside the limit: the check cannot tell"),
        (routing_ok([flips16, flips32]), "bf16 routing: slots moved"),
        (routing_ok([], flips_c), "the routing control lies inside the "
                                  "limit: the check cannot tell"),
        (f32["tokens_equal"], "float32 greedy tokens differ between the "
                              "kernels and the plain forms"),
        (f32["max_rel_rms"] <= SERVE_F32_REL_RMS, "float32 logits differ"),
        (flip_share(f32["routing_flips"], "float32")
         <= ROUTING_FLIP_SHARE["float32"], "float32 routing flips"),
    ) if not ok]
    if failed:
        emit({"phase": "serve_path", "ok": False, **run})
    check(not failed, f"{arch}: " + "; ".join(failed))
    return run


# -- the training path -------------------------------------------------------------

#: The training path: both models at full width and depth through
#: ``launch.train.run``, 8 steps each, an async checkpoint every 4 steps
#: (so the one of step 4), live diagnosis on.  (batch, sequence) per arch;
#: mamba2-130m's chunk is its config's 256.
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
#: The live diagnosis gates stragglers only: a step whose task takes more
#: than 1.5x its window's median.  Left to the card's own timing the run may
#: hold none (the checkpoint step often is one, not always), so the probe
#: holds the host, GPU idle, before step ``TRAIN_STALL_STEP``'s train step
#: for ``TRAIN_STALL_FACTOR`` times the longest task before it.  That task
#: then is a straggler (the window's median is at most that longest task)
#: and the tick that reads it must launch K1.  The hold lies outside the
#: step's CUDA-event marks, so the step times do not hold it.
TRAIN_STALL_STEP = 3
TRAIN_STALL_FACTOR = 2.0
TRAIN_SHAPES = {MOE_ARCH: (8, 512), SSM_ARCH: (8, 1024),
                ENCDEC_ARCH: (8, 512)}
#: Gradients of the kernel path (the kernels forward, their plain versions'
#: autograd backward) against the reference's plain forms on the same
#: parameters and batch, the kernel run's routing replayed.  float32, depth
#: cut to ``--f32-layers``: the loss within ``TRAIN_F32_LOSS_RTOL``
#: relative, every gradient leaf within ``TRAIN_F32_GRAD_REL_RMS``
#: relative RMS; a control (the plain forms on parameters rounded to
#: ``TRAIN_F32_CONTROL_BITS`` significant bits, by arch) must exceed both.
#: The loss of random weights on random tokens sits near ln(vocab) and
#: moves little with the weights, so its limit is 1e-6 (~10 ulp at 11),
#: below the starting point of 1e-5 that only a 5-bit control exceeded.
#: Readings on an H100 (4 layers; sound / control): granite-moe at 8 bits:
#: loss 8.7e-8 / 6.1e-6, worst leaf 2.8e-6 / 7.9e-3; seamless-m4t-medium
#: (ln 256206 ≈ 12.5, its loss moved 6.8e-7 at 8 bits) at 5 bits: loss
#: 7.5e-8 / 2.3e-5, worst leaf 3.2e-6 / 3.4e-2.
TRAIN_F32_LOSS_RTOL = 1e-6
TRAIN_F32_GRAD_REL_RMS = 1e-4
TRAIN_F32_CONTROL_BITS = {MOE_ARCH: 8, SSM_ARCH: 8, ENCDEC_ARCH: 5}
#: bf16 at full depth, by arch: the loss and the global gradient norm,
#: relative, and the worst gradient leaf's relative RMS; a control at
#: ``TRAIN_BF16_CONTROL_BITS`` must exceed each.  Readings on an H100, the
#: same in two runs (sound / control): granite-moe at 5 bits: loss 9.6e-6
#: / 1.1e-4, norm 6.1e-4 / 4.3e-3, leaf 0.053 / 0.165; mamba2-130m at 4
#: bits (at 5 its loss read 2.0e-5, inside the sound 2.1e-5): loss 2.1e-5
#: / 8.0e-5, norm 2.7e-5 / 2.2e-4, leaf 0.033 / 0.225; seamless-m4t-medium
#: at 4 bits (at 5 its norm read 3.3e-4 and its worst leaf 0.059, too near
#: the sound 1.8e-4 and 0.030): loss 5.5e-6 / 4.0e-5, norm 1.8e-4 /
#: 6.3e-4, leaf 0.030 / 0.102 (its limits near the geometric means).
TRAIN_BF16_CONTROL_BITS = {MOE_ARCH: 5, SSM_ARCH: 4, ENCDEC_ARCH: 4}
TRAIN_BF16_LOSS_RTOL = {MOE_ARCH: 3e-5, SSM_ARCH: 4e-5, ENCDEC_ARCH: 1.5e-5}
TRAIN_BF16_GNORM_RTOL = {MOE_ARCH: 2e-3, SSM_ARCH: 1e-4, ENCDEC_ARCH: 3e-4}
TRAIN_BF16_LEAF_REL_RMS = {MOE_ARCH: 0.1, SSM_ARCH: 0.1, ENCDEC_ARCH: 0.055}
#: Controls read beside the held one, by dtype (8 bits is bf16's own
#: precision: rounding to it changes nothing there).
TRAIN_CONTROL_SWEEP = {"float32": (5, 8, 12, 16), "bfloat16": (4, 5, 6)}


class Mark:
    """A point on the device's timeline (a CUDA event) or, off the card, on
    the host clock (rehearsals only)."""

    def __init__(self, device) -> None:
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.t = time.perf_counter()

    def ms_to(self, later: "Mark") -> float:
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return (later.t - self.t) * 1e3

    def ms_to_now(self, device) -> float:
        """Time from this mark to a new one, once the device reaches it."""
        now = Mark(device)
        if now.event is not None:
            now.event.synchronize()
        return self.ms_to(now)


class TrainProbe:
    """Instruments ``launch.train.run`` from outside: each train step's
    marks (start, end of the forward, start and end of the optimizer, end)
    and kernel counts, each step's loss, the last state and step function,
    a host copy of every checkpointed tree as ``save`` was called, K1's
    launches in each live diagnosis tick, and the host hold that makes
    step ``TRAIN_STALL_STEP`` a straggler (see there)."""

    def __init__(self, device) -> None:
        self.device = device
        self.steps: list[dict] = []
        self.saves: list[tuple[int, list]] = []
        self.state = None
        self.step_fn = None
        self.ticks = 0
        self.k1_in_ticks = 0
        self.k1_per_tick: list[int] = []
        self.longest_task_s = 0.0
        self.stall_s = None

    def _mark(self, name: str) -> None:
        self.steps[-1]["marks"].setdefault(name, Mark(self.device))

    @contextlib.contextmanager
    def installed(self):
        probe = self
        make0, loss0 = launch_train.make_train_step, Model.loss
        adamw0, save0 = train_step_mod.adamw_update, CheckpointManager.save
        tick0 = Diagnosis.tick

        def make(*a, **kw):
            inner = make0(*a, **kw)

            def step(state, batch):
                if len(probe.steps) == TRAIN_STALL_STEP:
                    probe.stall_s = TRAIN_STALL_FACTOR * probe.longest_task_s
                    time.sleep(probe.stall_s)
                probe.steps.append({"marks": {}, "counts": [kernel_counts()],
                                    "backward": moe_gmm.BACKWARD_LAUNCHES})
                probe._mark("start")
                state, metrics = inner(state, batch)
                probe._mark("end")
                probe.steps[-1]["counts"].append(kernel_counts())
                probe.steps[-1]["backward"] = (moe_gmm.BACKWARD_LAUNCHES
                                               - probe.steps[-1]["backward"])
                probe.steps[-1]["loss"] = metrics["loss"]
                probe.state, probe.step_fn = state, inner
                return state, metrics
            return step

        def loss(model, params, batch):
            out = loss0(model, params, batch)
            probe._mark("forward_end")
            return out

        def adamw(*a, **kw):
            probe._mark("optimizer_start")
            out = adamw0(*a, **kw)
            probe._mark("optimizer_end")
            return out

        def save(mgr, step, tree_, blocking=True):
            probe.saves.append((step, [t.detach().to("cpu", copy=True)
                                       for t in tree.leaves(tree_)]))
            return save0(mgr, step, tree_, blocking=blocking)

        def tick(diag, telemetry, *a, **kw):
            before = bigroots_gates.LAUNCHES
            try:
                return tick0(diag, telemetry, *a, **kw)
            finally:
                probe.ticks += 1
                probe.k1_per_tick.append(bigroots_gates.LAUNCHES - before)
                probe.k1_in_ticks += probe.k1_per_tick[-1]
                probe.longest_task_s = max(
                    float(stage.durations.max())
                    for stage in telemetry.trace.stages())

        launch_train.make_train_step = make
        Model.loss = loss
        train_step_mod.adamw_update = adamw
        CheckpointManager.save = save
        Diagnosis.tick = tick
        try:
            yield self
        finally:
            Diagnosis.tick = tick0
            launch_train.make_train_step = make0
            Model.loss = loss0
            train_step_mod.adamw_update = adamw0
            CheckpointManager.save = save0

    def step_times(self) -> list[dict]:
        out = []
        for s in self.steps:
            m = s["marks"]
            out.append({
                "step_ms": m["start"].ms_to(m["end"]),
                "forward_ms": m["start"].ms_to(m["forward_end"]),
                "backward_ms": m["forward_end"].ms_to(m["optimizer_start"]),
                "optimizer_ms": m["optimizer_start"].ms_to(
                    m["optimizer_end"]),
                "launches": {k: s["counts"][1][k] - s["counts"][0][k]
                             for k in s["counts"][0]},
                "backward_launches": s["backward"]})
        return out


def expected_train_backward_launches(cfg) -> int:
    """K5's backward kernels in one train step (``BACKWARD_LAUNCHES``):
    ``dX`` and ``dW`` for each of the three grouped products of every MoE
    layer in bfloat16 (each product's rows and weights take a gradient;
    the recompute adds none); float32 keeps the plain backward."""
    if cfg.moe_impl != "gmm" or cfg.dtype != "bfloat16":
        return 0
    return 2 * 3 * cfg.n_blocks * sum(s.ffn == "moe" for s in cfg.pattern())


def expected_train_launches(cfg) -> dict:
    """Kernel launches of one train step: the forward's (K2 once per
    attention layer — an encoder-decoder's encoder layers once, its decoder
    layers twice: self and cross —, K4 once per SSM layer, K5 three times
    per MoE layer), twice with ``remat`` (the backward recomputes every
    block); the backward launches none of these (K2's and K4's is their
    plain versions' autograd, K5's bf16 one its own kernels,
    :func:`expected_train_backward_launches`)."""
    if cfg.enc_layers:
        forward = {"flash_attention": cfg.enc_layers + 2 * cfg.n_layers,
                   "decode_attention": 0, "ssd_scan": 0, "moe_gmm": 0}
    else:
        forward, _ = expected_launches(cfg)
    return {k: (2 if cfg.remat else 1) * v for k, v in forward.items()}


class TrainRouting(Routing):
    """:class:`Routing` for a forward and backward under ``remat``: the
    router runs in the forward (block 0 first) and again in each block's
    recompute (last block first).  Each recompute call replays its forward
    call, and recording checks that it chose the same experts from bitwise
    equal probabilities (``recompute_equal``).  ``shards``: the router
    calls of one layer (the unsharded ep layer's shards, each routing its
    own tokens, in shard order)."""

    def __init__(self, cfg, shards: int = 1) -> None:
        super().__init__()
        self.per_block = sum(s.ffn == "moe" for s in cfg.pattern())
        self.blocks = cfg.n_blocks
        self.shards = shards
        self.probs: list = []
        self.recompute_equal = True

    def _source(self, call: int) -> int:
        group, shard = divmod(call, self.shards)
        r = group - self.per_block * self.blocks
        if r < 0:
            return call
        return ((self.blocks - 1 - r // self.per_block) * self.per_block
                + r % self.per_block) * self.shards + shard

    def _keep(self, probs, experts) -> None:
        f = self._source(len(self.recorded))
        if f != len(self.recorded):
            self.recompute_equal &= bool(
                torch.equal(self.probs[f], probs)
                and torch.equal(self.recorded[f], experts))
        self.probs.append(probs.detach())
        self.recorded.append(experts)


def loss_and_grads(cfg, params, batch):
    """The loss (float) and the gradient of every parameter leaf."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    loss, _ = Model(cfg).loss(tree.unflatten(params, leaves), batch)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


def grad_errors(got, want) -> dict:
    """Relative RMS of every leaf and of the global norm."""
    rel = [float((g.float() - w.float()).norm()
                 / w.float().norm().clamp_min(1e-30))
           for g, w in zip(got, want, strict=True)]
    gn, wn = float(global_norm(list(got))), float(global_norm(list(want)))
    return {"max_leaf_rel_rms": max(rel), "global_norm": gn,
            "global_norm_rel": abs(gn - wn) / wn}


def grad_check(cfg, params, batch, control_bits: int) -> dict:
    """The kernel path (``cfg``) against the plain forms on the same
    parameters and batch, and a control (the plain forms on parameters
    rounded to ``control_bits`` bits) against the plain forms; the kernel
    run's routing replayed in both.  Controls at ``TRAIN_CONTROL_SWEEP``
    bits are read beside it (where the limits could lie)."""
    plain = replace(cfg, **PLAIN_FORMS)
    routing = TrainRouting(cfg)
    before = kernel_counts()
    with routing.record():
        k_loss, k_grads = loss_and_grads(cfg, params, batch)
    launched = {k: v - before[k] for k, v in kernel_counts().items()}
    with routing.replay() as flips:
        p_loss, p_grads = loss_and_grads(plain, params, batch)
    kernel = grad_errors(k_grads, p_grads)
    del k_grads
    sweep = {}
    for bits in (control_bits, *TRAIN_CONTROL_SWEEP[cfg.dtype]):
        if bits in sweep:
            continue
        with routing.replay() as c_flips:
            c_loss, c_grads = loss_and_grads(
                plain, coarse_params(params, bits), batch)
        sweep[bits] = {"loss_rel": abs(c_loss - p_loss) / abs(p_loss),
                       **grad_errors(c_grads, p_grads),
                       "routing_flips": c_flips}
        del c_grads
    control = sweep[control_bits]
    check(kernel_counts() == {k: before[k] + launched[k] for k in before},
          "the plain forms launched a kernel")
    return {"layers": cfg.n_layers, "dtype": cfg.dtype,
            "loss": {"kernel": k_loss, "plain": p_loss,
                     "kernel_rel": abs(k_loss - p_loss) / abs(p_loss),
                     "control_rel": control["loss_rel"]},
            "kernel_vs_plain": kernel, "control_vs_plain": control,
            "control_bits": control_bits, "control_sweep": sweep,
            "launches": launched,
            "routing_flips": flips,
            "recompute_routing_equal": routing.recompute_equal}


def train_batch(cfg, B: int, S: int, seed: int, step: int, device) -> dict:
    """The training run's batch of ``step``, as ``launch.train`` makes it
    (an encoder-decoder's with ``S // 4`` frame embeddings)."""
    loader = HostDataLoader(DataConfig(
        vocab=cfg.vocab, seq_len=S, batch_per_host=B, seed=seed,
        embed_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model if (cfg.frontend_tokens or cfg.enc_layers) else 0,
        enc_frames=S // 4 if cfg.enc_layers else 0), 0, 1)
    return {k: torch.from_numpy(v).to(device)
            for k, v in loader.batch_at(step)[0].items()}


def profile_train_step(fn, state, batch) -> dict:
    """One more train step under ``torch.profiler``: the device time of its
    kernels against the step's wall time (host clock to a
    synchronisation)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    if not busy:
        return {"device_busy_ms": "not measured", "step_wall_ms": wall_ms}
    return {"step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernel_launches": sum(1 for e in prof.events() if e.device_type
                                   == torch.autograd.DeviceType.CUDA)}


def backward_timing(device, arch: str, seed: int) -> dict:
    """Each kernel of ``arch``'s training path at its training shape, bf16:
    the forward (the kernel) and the backward (its plain version's
    autograd) by CUDA events, median of 5 after one warm-up; and whether two
    launches on the same inputs agree bit for bit (the recompute relies on
    it)."""
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    bf = torch.bfloat16
    cfg = get_config(arch)
    B, S = TRAIN_SHAPES[arch]
    cases = {}
    if arch == MOE_ARCH:
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qkv = [_randn(gen, (B, S, h, D), bf, device) for h in (H, KV, KV)]
        cases["flash_attention"] = (
            lambda *t: flash_attention.flash_attention(*t), qkv)
        sizes = routed_sizes(gen, B * S * cfg.moe_top_k, cfg.moe_experts,
                             device)
        xs = _randn(gen, (int(sizes.sum()), cfg.d_model), bf, device)
        w = (torch.randn((cfg.moe_experts, cfg.d_model, cfg.expert_d_ff),
                         generator=gen, device=device)
             / cfg.d_model ** 0.5).to(bf)
        cases["moe_gmm"] = (moe_gmm.grouped_matmul, [xs, w, sizes])
    elif arch == ENCDEC_ARCH:
        # the decoder's causal self-attention and its cross-attention over
        # the S / 4 encoder frames
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        cases["flash_attention"] = (
            lambda *t: flash_attention.flash_attention(*t),
            [_randn(gen, (B, S, h, D), bf, device) for h in (H, KV, KV)])
        cases["flash_attention_cross"] = (
            lambda *t: flash_attention.flash_attention(*t, causal=False),
            [_randn(gen, shape, bf, device) for shape in
             ((B, S, H, D), (B, S // 4, KV, D), (B, S // 4, KV, D))])
    else:
        x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, cfg.ssm_heads,
                                      cfg.ssm_groups, cfg.ssm_state, bf,
                                      device)
        cases["ssd_scan"] = (
            lambda *t: ssd_scan.ssd_intra_chunk(*t, cfg.ssm_chunk),
            [x, dt, A, Bm.contiguous(), Cm.contiguous()])
    out = {}
    for name, (fn, inputs) in cases.items():
        args = [t.requires_grad_() if t.is_floating_point() else t
                for t in inputs]
        first = fn(*args)
        first = first if isinstance(first, tuple) else (first,)
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        equal = all(torch.equal(a, b) for a, b in zip(first, again))
        grads_out = [torch.randn_like(o) for o in first]
        wrt = [a for a in args if a.requires_grad]
        fwd, bwd = [], []
        for rep in range(6):
            a, b, c = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            a.record()
            outs = fn(*args)
            outs = outs if isinstance(outs, tuple) else (outs,)
            b.record()
            torch.autograd.grad(outs, wrt, grads_out)
            c.record()
            c.synchronize()
            if rep:
                fwd.append(a.elapsed_time(b))
                bwd.append(b.elapsed_time(c))
        out[name] = {"shape": list(inputs[0].shape),
                     "forward_ms": statistics.median(fwd),
                     "backward_ms": statistics.median(bwd),
                     "deterministic": equal}
        check(equal, f"{name}: two launches on the same inputs differ")
    return out


def phase_train(args, card: str, device, arch: str) -> dict:
    """Train ``arch`` at full width and depth through ``launch.train.run``
    with the launch counters zeroed just before and read after every step;
    then the checkpoint, one profiled step, the gradients against the plain
    forms and the kernels' backward times."""
    cfg = get_config(arch)
    check((cfg.attention_impl, cfg.moe_impl, cfg.ssm_impl, cfg.remat)
          == ("cuda", "gmm", "cuda", True),
          "the default is not the kernel path under remat")
    B, S = TRAIN_SHAPES[arch]
    want = expected_train_launches(cfg)
    probe = TrainProbe(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch", str(B),
            "--seq", str(S), "--seed", str(args.seed), "--ckpt-every",
            str(TRAIN_CKPT_EVERY), "--async-ckpt", "--device", str(device)]
    with tempfile.TemporaryDirectory() as ckdir, probe.installed(), \
            gate_calls() as gates:
        zero_counts()
        t0 = time.perf_counter()
        out = launch_train.run(launch_train.build_argparser().parse_args(
            argv + ["--ckpt-dir", ckdir]))
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        k1 = bigroots_gates.LAUNCHES
        mgr = CheckpointManager(ckdir)
        saved_step, snapshot = probe.saves[-1]
        t1 = time.perf_counter()
        restored = mgr.restore(snapshot)
        restore_s = time.perf_counter() - t1
        ckpt_equal = mgr.latest_step() == saved_step and all(
            r.tobytes() == s.numpy().tobytes()
            for r, s in zip(tree.leaves(restored), snapshot, strict=True))
        del restored, snapshot
    probe.saves.clear()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    steps = probe.step_times()
    losses = [float(s["loss"]) for s in probe.steps]
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} train steps")
    want_bwd = expected_train_backward_launches(cfg)
    for n, s in enumerate(steps):
        check(s["launches"] == want,
              f"{arch} train step {n} launched {s['launches']}, "
              f"expected {want}")
        check(s["backward_launches"] == want_bwd,
              f"{arch} train step {n} launched {s['backward_launches']} "
              f"K5 backward kernels, expected {want_bwd}")
    steady = steps[1:]
    step_ms = statistics.median(s["step_ms"] for s in steady)
    run = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "batch": B, "seq": S,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.dtype,
        "remat": cfg.remat, "steps": TRAIN_STEPS, "gpu": card,
        "wall_s": wall, "driver_wall_s": out["wall_seconds"],
        "step_ms_median": step_ms,
        **{f"{k}_ms_median": statistics.median(s[f"{k}_ms"] for s in steady)
           for k in ("forward", "backward", "optimizer")},
        "tokens_per_s": B * S / (step_ms / 1e3),
        "step_ms": [s["step_ms"] for s in steps],
        "peak_memory_gb": peak / 1e9,
        "launches": launches, "launches_per_step": want,
        "backward_launches_per_step": want_bwd,
        "k1_launches": k1, "packed_sweeps": len(gates["calls"]),
        "diagnosis_ticks": probe.ticks, "k1_in_ticks": probe.k1_in_ticks,
        "k1_per_tick": probe.k1_per_tick, "stall_step": TRAIN_STALL_STEP,
        "stall_s": probe.stall_s,
        "losses": losses, "loss_decreased": out["loss_decreased"],
        "live_causes": out["live_causes_count"],
        "stragglers": out["num_stragglers"],
        "checkpoint": {"step": saved_step, "equal": ckpt_equal,
                       "restore_s": restore_s},
    }
    check(all(np.isfinite(losses)), f"{arch}: a loss is not finite: "
                                    f"{losses}")
    check(out["loss_decreased"], f"{arch}: the loss did not decrease")
    check(ckpt_equal, f"{arch}: the checkpoint restored other bytes")
    check(probe.ticks == TRAIN_STEPS, f"{probe.ticks} diagnosis ticks")
    check(k1 == len(gates["calls"]) and probe.k1_in_ticks >= 1
          and probe.k1_per_tick[TRAIN_STALL_STEP] >= 1,
          f"{arch}: K1 launched {k1} times over {len(gates['calls'])} "
          f"packed sweeps, {probe.k1_in_ticks} in the live ticks "
          f"{probe.k1_per_tick} (step {TRAIN_STALL_STEP} held "
          f"{probe.stall_s} s)")
    if device.type == "cuda":
        batch = train_batch(cfg, B, S, args.seed, TRAIN_STEPS, device)
        run["profile"] = profile_train_step(probe.step_fn, probe.state, batch)
    probe.state = probe.step_fn = None
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # Gradients: the first batch of the run and the run's initial
    # parameters (the same seed), float32 cut in depth, then bf16 at full
    # depth.
    batch = train_batch(cfg, B, S, args.seed, 0, device)
    params = Model(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed))
    p32, cfg32 = cut_params(params, replace(cfg, dtype="float32"),
                            args.f32_layers)
    f32 = run["grad_f32"] = grad_check(cfg32, p32, batch,
                                       TRAIN_F32_CONTROL_BITS[arch])
    del p32
    bf16 = run["grad_bf16"] = grad_check(cfg, params, batch,
                                         TRAIN_BF16_CONTROL_BITS[arch])
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
        run["kernels"] = backward_timing(device, arch, args.seed)
    loss_lim, gnorm_lim, leaf_lim = TRAIN_BF16_LOSS_RTOL[arch], \
        TRAIN_BF16_GNORM_RTOL[arch], TRAIN_BF16_LEAF_REL_RMS[arch]
    run["limits"] = {"f32_loss_rtol": TRAIN_F32_LOSS_RTOL,
                     "f32_grad_rel_rms": TRAIN_F32_GRAD_REL_RMS,
                     "bf16_loss_rtol": loss_lim, "bf16_gnorm_rtol": gnorm_lim,
                     "bf16_leaf_rel_rms": leaf_lim}
    failed = [msg for ok, msg in (
        (f32["loss"]["kernel_rel"] <= TRAIN_F32_LOSS_RTOL,
         "float32 loss differs from the plain forms'"),
        (f32["kernel_vs_plain"]["max_leaf_rel_rms"]
         <= TRAIN_F32_GRAD_REL_RMS,
         "a float32 gradient leaf differs from the plain forms'"),
        (f32["loss"]["control_rel"] > TRAIN_F32_LOSS_RTOL
         and f32["control_vs_plain"]["max_leaf_rel_rms"]
         > TRAIN_F32_GRAD_REL_RMS,
         "the float32 control lies inside a limit: the check cannot tell"),
        (bf16["loss"]["kernel_rel"] <= loss_lim,
         "bf16 loss further from the plain forms' than the limit"),
        (bf16["kernel_vs_plain"]["global_norm_rel"] <= gnorm_lim,
         "bf16 gradient norm further from the plain forms' than the limit"),
        (bf16["kernel_vs_plain"]["max_leaf_rel_rms"]
         <= leaf_lim,
         "a bf16 gradient leaf further from the plain forms' than the limit"),
        (bf16["loss"]["control_rel"] > loss_lim
         and bf16["control_vs_plain"]["global_norm_rel"] > gnorm_lim
         and bf16["control_vs_plain"]["max_leaf_rel_rms"]
         > leaf_lim,
         "the bf16 control lies inside a limit: the check cannot tell"),
        (f32["recompute_routing_equal"] and bf16["recompute_routing_equal"],
         "a recompute routed other than its forward"),
        (f32["launches"] == expected_train_launches(cfg32)
         and bf16["launches"] == want,
         "the gradient checks' kernel path launched other counts"),
        (flip_share(f32["routing_flips"], "float32")
         <= ROUTING_FLIP_SHARE["float32"]
         and routing_ok([bf16["routing_flips"]]), "routing flips"),
        (routing_ok([], bf16["control_vs_plain"]["routing_flips"]),
         "the bf16 routing control lies inside the limit"),
    ) if not ok]
    if failed:
        emit({"phase": "train_path", "ok": False, **run})
    check(not failed, f"{arch}: " + "; ".join(failed))
    return run


# -- the encoder-decoder and the VLM through Model ---------------------------

def model_requests(cfg, seed: int, device) -> dict:
    """``SERVE_BATCH`` prompts of ``PROMPT_LEN`` tokens and what the arch's
    frontend stub gives beside them: an encoder-decoder's ``ENC_FRAMES``
    frame embeddings (``enc_embeds``), a VLM's ``frontend_tokens`` patch
    embeddings (``embeds``)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN))
    key, n = (("enc_embeds", ENC_FRAMES) if cfg.enc_layers
              else ("embeds", cfg.frontend_tokens))
    frames = rng.normal(0, 1, (SERVE_BATCH, n, cfg.d_model))
    return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device),
            key: torch.from_numpy(frames.astype(np.float32)).to(device)}


def generate(model, params, batch: dict, new_tokens: int, device,
             max_len: int | None = None) -> dict:
    """Serve one batch through ``Model.init_cache`` / ``prefill`` /
    ``decode``, greedy: each call's device time (``Mark``), host enqueue
    time, kernel launches and logits, the tokens fed (prompt first) and the
    host-clock wall time."""
    calls = []

    def call(name, fn, *a):
        before = kernel_counts()
        start = Mark(device)
        t0 = time.perf_counter()
        out = fn(*a)
        host = (time.perf_counter() - t0) * 1e3
        calls.append({"name": name, "marks": (start, Mark(device)),
                      "host_ms": host,
                      "launches": {k: v - before[k]
                                   for k, v in kernel_counts().items()}})
        return out
    t0 = time.perf_counter()
    cache = call("init_cache", model.init_cache, params, batch,
                 max_len or MAX_LEN)
    logits, cache = call("prefill", model.prefill, params, batch, cache)
    fed, out = [batch["tokens"]], [logits]
    for _ in range(new_tokens):
        nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        fed.append(nxt)
        logits, cache = call("decode", model.decode, params, nxt, cache)
        out.append(logits)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"calls": calls, "tokens": fed, "logits": out,
            "wall_s": time.perf_counter() - t0,
            "generated": torch.cat(fed[1:], dim=1)}


def _call_ms(calls: list, name: str) -> list[float]:
    return [c["marks"][0].ms_to(c["marks"][1]) for c in calls
            if c["name"] == name]


def expected_model_launches(cfg) -> dict:
    """Kernel launches of each ``Model`` call.  An encoder-decoder:
    ``init_cache`` K2 once per encoder layer, ``prefill`` K2 twice per
    decoder layer (self and cross), a decode step K3 twice per decoder
    layer (the self and the cross cache).  A decoder-only model (the VLM):
    none in ``init_cache``, then ``expected_launches``."""
    zero = {m.__name__.rsplit(".", 1)[-1]: 0 for m in SERVING_KERNELS}
    if cfg.enc_layers:
        return {"init_cache": {**zero, "flash_attention": cfg.enc_layers},
                "prefill": {**zero, "flash_attention": 2 * cfg.n_layers},
                "decode": {**zero, "decode_attention": 2 * cfg.n_layers}}
    prefill, step = expected_launches(cfg)
    return {"init_cache": zero, "prefill": prefill, "decode": step}


def phase_model_serve(args, card: str, device, arch: str) -> dict:
    """Serve ``arch`` (seamless-m4t-medium, or internvl2-26b with its patch
    embeddings) at full width through ``Model``: launches of every call
    checked, the bf16 logits held to the plain forms and to a float32
    model, a float32 variant cut in depth held to the plain forms with
    float64 activations."""
    t_phase = time.perf_counter()
    cfg = served_config(arch)
    check(cfg.attention_impl == "cuda"
          and bool(cfg.enc_layers or cfg.frontend_tokens),
          "the default is not the kernel path")
    max_len = serve_max_len(cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = Model(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed))
    bparams = cast_params(params, cfg, device)
    model = Model(cfg)
    batch = model_requests(cfg, args.seed, device)
    frames = {k: v for k, v in batch.items() if k != "tokens"}
    # Warm-up (cuBLAS handles, the kernels' libraries): 2 new tokens.
    generate(model, bparams, model_requests(cfg, args.seed + 1, device), 2,
             device, max_len)
    routing = Routing()          # records nothing where no layer routes
    zero_counts()
    with routing.record():
        gen = generate(model, bparams, batch, MAX_NEW, device, max_len)
    launches = kernel_counts()
    want = expected_model_launches(cfg)
    calls = gen["calls"]
    check([c["name"] for c in calls]
          == ["init_cache", "prefill"] + ["decode"] * MAX_NEW, "calls")
    for n, c in enumerate(calls):
        check(c["launches"] == want[c["name"]],
              f"{cfg.name} call {n} ({c['name']}) launched {c['launches']}, "
              f"expected {want[c['name']]}")
    toks = gen["generated"]
    check(tuple(toks.shape) == (SERVE_BATCH, MAX_NEW), "generated shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "a token outside the vocabulary")
    decode_ms = _call_ms(calls, "decode")
    run = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "published_layers": get_config(arch).n_layers,
        "enc_layers": cfg.enc_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "vocab_padded": cfg.vocab_padded,
        "params": sum(t.numel() for t in tree.leaves(params)),
        "param_dtype": cfg.param_dtype, "served_dtype": cfg.dtype,
        "requests": SERVE_BATCH,
        "frontend": {k: list(v.shape[1:]) for k, v in frames.items()},
        "prompt_len": PROMPT_LEN, "new_tokens": MAX_NEW, "max_len": max_len,
        "gpu": card,
        "init_cache_ms": _call_ms(calls, "init_cache")[0],
        "prefill_ms": _call_ms(calls, "prefill")[0],
        "decode_ms_per_step_median": statistics.median(decode_ms),
        "decode_enqueue_ms_median": statistics.median(
            c["host_ms"] for c in calls if c["name"] == "decode"),
        "decode_ms_per_step": decode_ms, "wall_s": gen["wall_s"],
        "tokens_per_s": SERVE_BATCH * MAX_NEW / gen["wall_s"],
        "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if device.type == "cuda" else None),
        "launches": launches, "launches_per_call": want,
    }

    plain = replace(cfg, **PLAIN_FORMS)
    with routing.replay() as flips16:
        plain16 = teacher_forced(Model(plain), bparams, gen["tokens"],
                                 frames, max_len)
    with routing.replay() as flips_c:
        control16 = teacher_forced(Model(plain),
                                   coarse_params(bparams, CONTROL_BITS),
                                   gen["tokens"], frames, max_len)
    check(kernel_counts() == launches, "the plain forms launched a kernel")
    if device.type == "cuda":
        run["decode_profile"] = profile_decode(model, bparams, gen["tokens"],
                                               frames, max_len)
    del bparams
    with routing.replay() as flips32:
        ref32 = teacher_forced(Model(replace(plain, dtype="float32")),
                               params, gen["tokens"], frames, max_len)
    limit = SERVE_BF16_KERNEL_VS_PLAIN[arch]
    bf16 = run["bf16_vs_f32"] = {
        "kernel_path": logit_errors(gen["logits"], ref32, cfg.vocab),
        "plain_forms": logit_errors(plain16, ref32, cfg.vocab),
        "kernel_vs_plain": logit_errors(gen["logits"], plain16, cfg.vocab),
        "control_vs_plain": logit_errors(control16, plain16, cfg.vocab),
        "control_bits": CONTROL_BITS, "margin": SERVE_BF16_MARGIN,
        "kernel_vs_plain_limit": limit,
        "routing_flips": {"plain_forms": flips16, "float32": flips32,
                          "control": flips_c},
        "routing_flip_limit": ROUTING_FLIP_SHARE["bfloat16"]}
    del plain16, control16, ref32, gen
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # float32, depth cut (an encoder-decoder's encoder and decoder): greedy
    # tokens equal to the plain forms' with float64 activations, logits
    # within 1e-4.
    p32, cfg32 = cut_params(params, replace(cfg, dtype="float32"),
                            args.f32_layers)
    k32 = generate(Model(cfg32), p32, batch, MAX_NEW, device, max_len)
    p64 = generate(Model(replace(cfg32, dtype="float64", **PLAIN_FORMS)),
                   p32, batch, MAX_NEW, device, max_len)
    f32 = run["f32_variant"] = {
        "layers": cfg32.n_layers,
        "tokens_equal": torch.equal(k32["generated"], p64["generated"]),
        "tolerance_rel_rms": SERVE_F32_REL_RMS,
        "launches": [c["launches"] for c in k32["calls"][:3]],
        **logit_errors(k32["logits"], p64["logits"], cfg.vocab)}
    del k32, p64, p32, params
    run["seconds"] = time.perf_counter() - t_phase
    failed = [msg for ok, msg in (
        (bf16["kernel_path"]["max_rel_rms"]
         <= SERVE_BF16_MARGIN * bf16["plain_forms"]["max_rel_rms"],
         "bf16 kernel path further from float32 than the plain forms"),
        (bf16["kernel_vs_plain"]["max_rel_rms"] <= limit,
         "bf16 kernel path further from the plain forms than the limit"),
        (bf16["control_vs_plain"]["max_rel_rms"] > limit,
         "the control lies inside the limit: the check cannot tell"),
        (routing_ok([flips16, flips32], flips_c),
         "bf16 routing: slots moved, or the control inside the limit"),
        (f32["tokens_equal"], "float32 greedy tokens differ between the "
                              "kernels and the plain forms"),
        (f32["max_rel_rms"] <= SERVE_F32_REL_RMS, "float32 logits differ"),
    ) if not ok]
    if failed:
        emit({"phase": model_phase(cfg), "part": "serve", "ok": False,
              **run})
    check(not failed, f"{cfg.name}: " + "; ".join(failed))
    return run


def model_phase(cfg) -> str:
    """The phase name of a ``phase_model_serve`` run's JSON line."""
    return "encdec_path" if cfg.enc_layers else "vlm_path"


# -- expert parallelism -------------------------------------------------------

@contextlib.contextmanager
def expert_ffn(replacement):
    """``moe._gmm_ffn`` (the expert FFN that ``ep_moe`` runs through K5)
    replaced inside the block."""
    orig, moe_layer._gmm_ffn = moe_layer._gmm_ffn, replacement
    try:
        yield
    finally:
        moe_layer._gmm_ffn = orig


@contextlib.contextmanager
def ep_aux(record: list):
    """Each ep MoE layer's ``MoeAux`` appended to ``record`` inside the
    block (``moe.moe_apply`` looks ``ep_moe_apply`` up at every call)."""
    inner = ep_moe.ep_moe_apply

    def apply(*a, **kw):
        y, aux = inner(*a, **kw)
        record.append(aux)
        return y, aux
    ep_moe.ep_moe_apply = apply
    try:
        yield
    finally:
        ep_moe.ep_moe_apply = inner


def ep_to_gmm_routing(ep: Routing, shards: int, B: int, S: int) -> Routing:
    """The routing of an ep run (one router call per shard per layer, each
    over the shard's ``[B, S / M]`` tokens) as the token-sorted MoE routes
    (one call per layer over ``[B, S]``)."""
    out = Routing()
    for i in range(0, len(ep.recorded), shards):
        parts = torch.stack(ep.recorded[i:i + shards])     # [M, B·S/M, k]
        k = parts.shape[-1]
        out.recorded.append(parts.view(shards, B, S // shards, k)
                            .permute(1, 0, 2, 3).reshape(B * S, k))
    return out


def ep_shard_timing(xs, sizes, layer: dict, device) -> dict:
    """K5 at the rows one ep shard received (its ``E / M`` experts, the
    invalid slots as zero rows in the last group), gate/up and down, bf16,
    beside its plain version and ``torch._grouped_mm``."""
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=device)
    e_local = sizes.numel()
    gen = torch.Generator(device=device).manual_seed(11)
    out = {}
    for label, w in (("gate_up", layer["w_gate"][:e_local]),
                     ("down", layer["w_down"][:e_local])):
        x = xs if label == "gate_up" else _randn(
            gen, (xs.shape[0], w.shape[1]), xs.dtype, device)
        lib, lib_name = grouped_mm_library(x, w, sizes)
        t = measure_fns({
            "ms": lambda: moe_gmm.grouped_matmul(x, w, sizes),
            "plain_ms": lambda: moe_gmm.grouped_matmul_torch(x, w, sizes),
            "library_ms": lib}, flush, rounds=2)
        K, N = w.shape[1], w.shape[2]
        t.update(rows=int(sizes.sum()), experts=e_local, K=K, N=N,
                 group_sizes=sizes.tolist(), library=lib_name,
                 rows_per_tile=moe_gmm.tile_rows(x.shape[0], e_local),
                 dtype=str(x.dtype).removeprefix("torch."),
                 **gmm_bound(sizes, K, N, x.dtype))
        out[label] = t
    return out


def ep_low_capacity(layer: dict, cfg, B: int, S: int, seed: int,
                    device) -> dict:
    """One ep MoE layer (granite's first, bf16) at ``EP_LOW_CF`` on random
    hidden states, so that slots drop: the experts through K5 against its
    plain version (``GMM_TOL``), with the same kept slots."""
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=device).to(layer["w_gate"].dtype)
    runs = {}
    for name, ffn in (("kernel", moe_layer._gmm_ffn),
                      ("plain", moe_layer._ragged_ffn)):
        kept = []
        with expert_ffn(ffn), ep_moe.dispatch_hook(kept.append):
            y, _ = ep_moe.ep_moe_apply(layer, x, cfg,
                                       capacity_factor=EP_LOW_CF)
        runs[name] = (y, kept)
    (y, kept), (y_plain, kept_plain) = runs["kernel"], runs["plain"]
    slots = sum(k.numel() for k in kept)
    return {"capacity_factor": EP_LOW_CF, "shape": [B, S, cfg.d_model],
            "kept_equal": all(torch.equal(a, b)
                              for a, b in zip(kept, kept_plain, strict=True)),
            "dropped_share": sum(int((~k).sum()) for k in kept) / slots,
            **compare(y, y_plain, GMM_TOL[y.dtype], "ep layer at low capacity")}


def phase_ep(args, card: str, device) -> tuple[dict, dict]:
    """granite-moe-1b-a400m's prefill with ``moe_impl="ep"`` over
    ``EP_SHARDS`` virtual model shards: K5's launches, its logits against
    the same ep function with K5's plain version (routing replayed; its
    control on ``CONTROL_BITS`` weights), the kept and dropped slots of
    both runs, the distance to the token-sorted MoE (reported, no limit),
    and a decode step, which raises as the reference asserts (S = 1 is not
    a multiple of M).  Returns the phase's line and, for ``dist_path``,
    the list form's logits, kept masks, ``MoeAux`` and observed
    collectives."""
    cfg = replace(get_config(MOE_ARCH), moe_impl="ep")
    params = Model(cfg).init(
        torch.Generator(device=device).manual_seed(args.seed))
    bparams = cast_params(params, cfg, device)
    del params
    ep_moe.set_mesh(make_mesh((1, EP_SHARDS), ("data", "model")))
    tokens = torch.from_numpy(np.stack(
        [r.prompt for r in serve_requests(cfg, args.seed)])).to(device)
    batch = {"tokens": tokens}
    B, S = tokens.shape

    def prefill(model, params=None):
        params = bparams if params is None else params
        cache = model.init_cache(params, batch, MAX_LEN)
        a = Mark(device)
        logits, cache = model.prefill(params, batch, cache)
        return logits, cache, a.ms_to_now(device)

    model = Model(cfg)
    first = []
    inner = moe_layer._gmm_ffn

    def keep_first(p, xs, sizes, cdt):
        if not first:
            first.append((xs.clone(), sizes.clone()))
        return inner(p, xs, sizes, cdt)
    with expert_ffn(keep_first):                           # warm-up
        prefill(model)
    routing, kept, kept_plain, aux, observed = Routing(), [], [], [], []
    zero_counts()
    with routing.record(), ep_moe.dispatch_hook(kept.append), \
            ep_aux(aux), collectives.observe(
                lambda kind, n: observed.append((kind, n))):
        logits, cache, ms = prefill(model)
    launches = kernel_counts()
    moe_layers = cfg.n_blocks * sum(s.ffn == "moe" for s in cfg.pattern())
    want = {"flash_attention": cfg.n_layers, "decode_attention": 0,
            "ssd_scan": 0, "moe_gmm": 3 * EP_SHARDS * moe_layers}
    check(launches == want, f"ep prefill launched {launches}, expected {want}")
    try:
        model.decode(bparams, tokens[:, :1], cache)
        decode_error = None
    except ValueError as exc:
        decode_error = str(exc)
    check(decode_error is not None, "an ep decode step at M = 4 ran")
    del cache
    with expert_ffn(moe_layer._ragged_ffn), routing.replay() as flips, \
            ep_moe.dispatch_hook(kept_plain.append):
        plain, _, plain_ms = prefill(model)
    with expert_ffn(moe_layer._ragged_ffn), routing.replay() as flips_c:
        prefill(model, coarse_params(bparams, CONTROL_BITS))
    check(kernel_counts()["moe_gmm"] == launches["moe_gmm"],
          "the plain expert FFN launched K5")
    slots = sum(k.numel() for k in kept)
    dropped = sum(int((~k).sum()) for k in kept)
    kept_equal = len(kept) == len(kept_plain) == EP_SHARDS * moe_layers \
        and all(torch.equal(a, b) for a, b in zip(kept, kept_plain))
    with ep_to_gmm_routing(routing, EP_SHARDS, B, S).replay():
        token_sorted, _, gmm_ms = prefill(Model(replace(cfg, moe_impl="gmm")))
    run = {
        "arch": cfg.name, "moe_impl": cfg.moe_impl, "gpu": card,
        "mesh": {"data": 1, "model": EP_SHARDS}, "batch": B, "prompt_len": S,
        "experts_per_shard": cfg.moe_experts // EP_SHARDS,
        "capacity_per_destination": ep_moe.capacity(
            B * S // EP_SHARDS, cfg.moe_top_k, EP_SHARDS, 1.25),
        "prefill_ms": ms, "plain_expert_ffn_prefill_ms": plain_ms,
        "token_sorted_gmm_prefill_ms": gmm_ms,
        "launches": launches, "launches_expected": want,
        "kernel_vs_plain": logit_errors([logits], [plain], cfg.vocab),
        "kernel_vs_plain_limit": EP_KERNEL_VS_PLAIN,
        "routing_flips": flips, "routing_flips_control": flips_c,
        "routing_flip_limit": ROUTING_FLIP_SHARE["bfloat16"],
        "kept_equal": kept_equal, "dispatches": len(kept),
        "slots": slots, "dropped_slots": dropped,
        "dropped_share": dropped / slots,
        "ep_vs_token_sorted": logit_errors([logits], [token_sorted],
                                           cfg.vocab),
        "decode_raises": decode_error,
    }
    layer = {n: t[0] for n, t in bparams["blocks"]["L0_moe"].items()}
    run["low_capacity"] = ep_low_capacity(layer, cfg, B, S, args.seed,
                                          device)
    if device.type == "cuda":
        xs, sizes = first[0]
        run["k5_shard"] = ep_shard_timing(xs, sizes, layer, device)
    ep_moe.set_mesh(None)
    del bparams, first
    run["collectives"] = collective_counts(observed)
    failed = [msg for ok, msg in (
        (run["kernel_vs_plain"]["max_rel_rms"] <= EP_KERNEL_VS_PLAIN,
         "ep logits further from K5's plain version than the limit"),
        (kept_equal, "the kept slots differ between the two runs"),
        (run["low_capacity"]["kept_equal"]
         and run["low_capacity"]["dropped_share"] > 0,
         "at the low capacity the kept slots differ, or none dropped"),
        (routing_ok([flips], flips_c),
         "routing: slots moved, or the control inside the limit"),
    ) if not ok]
    if failed:
        emit({"phase": "ep_path", "ok": False, **run})
    check(not failed, "ep: " + "; ".join(failed))
    ref = {"logits": logits.cpu(), "kept": [k.cpu() for k in kept],
           "aux": [[t.cpu() for t in a] for a in aux], "observed": observed,
           "prefill_ms": ms}
    return run, ref


def collective_counts(observed: list) -> dict:
    """Calls and one participant's bytes by kind, from an ``observe``
    record."""
    out: dict = {}
    for kind, n in observed:
        c = out.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += n
    return out


# -- the parallel layers on one card ------------------------------------------

#: The 4-stage pipeline of ``parallel`` and ``dist_path``: microbatches of
#: granite's width through tanh-linear stages.
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 4, 8, 64


def parallel_inputs(seed: int, device, rank: int | None = None):
    """The inputs of ``parallel``, drawn from the run's seed in one order:
    the int8 all-reduce's ``EP_SHARDS`` participants (granite's ``embed``
    shape, participant ``i`` scaled by ``1 + i``; with ``rank`` only that
    one is kept, the others None), then the pipeline's stage weights and
    microbatches."""
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    shape = (cfg.vocab_padded, cfg.d_model)
    xs = []
    for i in range(EP_SHARDS):
        x = torch.randn(shape, generator=gen, device=device) * (1 + i)
        xs.append(x if rank in (None, i) else None)
    d = cfg.d_model
    ws = torch.randn((PIPE_STAGES, d, d), generator=gen, device=device) \
        / d ** 0.5
    x = torch.randn((PIPE_MICRO, PIPE_MB, d), generator=gen, device=device)
    return xs, ws, x


def tanh_stage(w, h):
    return torch.tanh(h @ w)


def sha(t: torch.Tensor) -> str:
    """The SHA-256 of a tensor's bytes (on the host)."""
    return hashlib.sha256(t.contiguous().cpu().reshape(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def observed_by(fn, *a):
    """``(fn(*a), [(kind, bytes), ...])``: the collectives it ran."""
    rec = []
    with collectives.observe(lambda kind, n: rec.append((kind, n))):
        out = fn(*a)
    return out, rec


def phase_parallel(args, device) -> tuple[dict, dict]:
    """``compressed_allreduce_mean`` over ``EP_SHARDS`` participants of
    granite's ``embed``-sized leaf against the mean of the participants'
    dequantized values, and ``pipeline_apply`` over 4 stages against the
    sequential composition, both in the list form.  Returns the phase's
    line and, for ``dist_path``, the list form's results (hashes of the
    all-reduce's mean and gathered wire, the pipeline's output) and their
    observed collectives."""
    xs, ws, x = parallel_inputs(args.seed, device)
    shape = tuple(xs[0].shape)
    a = Mark(device)
    got, ar_observed = observed_by(compressed_allreduce_mean, xs)
    ms = a.ms_to_now(device)
    want = torch.stack([dequantize(quantize(x), x.shape) for x in xs]).mean(0)
    err = float((got - want).abs().max() / want.abs().max())
    exact = float((got - torch.stack(xs).mean(0)).abs().max()
                  / torch.stack(xs).mean(0).abs().max())
    qts = [quantize(t) for t in xs]
    qt = qts[0]
    allreduce = {"participants": len(xs), "shape": list(shape), "ms": ms,
                 "rel_err_vs_dequantized_mean": err,
                 "rel_err_vs_exact_mean": exact,
                 "wire_bytes_per_participant": qt.q.numel()
                 + 4 * qt.scale.numel(),
                 "float32_bytes_per_participant": 4 * xs[0].numel(),
                 "collectives": collective_counts(ar_observed)}
    ref = {"allreduce": {
        "mean": sha(got), "observed": ar_observed,
        "payloads": sha(collectives.all_gather([q.q for q in qts])),
        "scales": sha(collectives.all_gather([q.scale for q in qts]))}}
    del xs, got, want, qts, qt

    a = Mark(device)
    out, pipe_observed = observed_by(
        pipeline_apply, tanh_stage, ws, x,
        make_mesh((PIPE_STAGES,), ("pipe",)))
    pipe_ms = a.ms_to_now(device)
    seq = []
    for m in range(PIPE_MICRO):
        h = x[m]
        for w in ws:
            h = tanh_stage(w, h)
        seq.append(h)
    seq = torch.stack(seq)
    pipe_err = float((out - seq).abs().max() / seq.abs().max())
    pipe = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
            "microbatch": [PIPE_MB, x.shape[-1]],
            "ticks": PIPE_MICRO + PIPE_STAGES - 1, "ms": pipe_ms,
            "rel_err_vs_sequential": pipe_err,
            "bitwise_equal": bool(torch.equal(out, seq)),
            "collectives": collective_counts(pipe_observed)}
    ref["pipeline"] = {"out": out.cpu(), "observed": pipe_observed}
    check(err <= 1e-7, f"compressed all-reduce differs by {err}")
    check(pipe_err <= 1e-6, f"pipeline differs by {pipe_err}")
    return {"compressed_allreduce_mean": allreduce,
            "pipeline_apply": pipe}, ref


# -- the parallel layers over process groups ------------------------------------

#: ``dist_path``: ``EP_SHARDS`` rank processes share the one card, each
#: with its shard on ``cuda:0``; one card cannot host several NCCL ranks,
#: so gloo carries the collectives through pinned host buffers.  The run
#: fails if a rank raises or all have not returned within this.
DIST_TIMEOUT_S = 600.0


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and sha(a) == sha(b))


def dist_rank(rank: int, store: str, seed: int, t_spawn: float,
              device: str) -> dict:
    """One rank of ``dist_path`` (a process of its own): granite-moe's
    parameters drawn on the card from the run's seed and cast to bf16 as
    ``phase_ep`` does, the serving batch's ep prefill with this rank's
    shard of a (data 1, model 4) mesh (counted launches, kept slots,
    ``MoeAux``, observed collectives), a decode step (which must raise),
    then its part of ``parallel``'s int8 all-reduce and pipeline.  Returns
    what the parent compares, on the host."""
    started_s = time.time() - t_spawn
    device = torch.device(device)
    on_card = device.type == "cuda"
    dm = init_ranks(make_mesh((1, EP_SHARDS), ("data", "model")), rank,
                    store)
    cfg = replace(get_config(MOE_ARCH), moe_impl="ep")
    bparams = cast_params(Model(cfg).init(
        torch.Generator(device=device).manual_seed(seed)), cfg, device)
    ep_moe.set_mesh(dm)
    model = Model(cfg)
    batch = {"tokens": torch.from_numpy(np.stack(
        [r.prompt for r in serve_requests(cfg, seed)])).to(device)}
    cache = model.init_cache(bparams, batch, MAX_LEN)
    model.prefill(bparams, batch, cache)                   # warm-up
    if on_card:
        torch.cuda.synchronize()
    ready_s = time.time() - t_spawn
    del cache
    kept, aux, observed = [], [], []
    cache = model.init_cache(bparams, batch, MAX_LEN)
    zero_counts()
    with ep_moe.dispatch_hook(kept.append), ep_aux(aux), \
            collectives.observe(lambda kind, n: observed.append((kind, n))):
        a = Mark(device)
        logits, cache = model.prefill(bparams, batch, cache)
        prefill_ms = a.ms_to_now(device)
    launches = kernel_counts()
    free, total = torch.cuda.mem_get_info() if on_card else (0, 0)
    try:
        model.decode(bparams, batch["tokens"][:, :1], cache)
        decode_error = None
    except ValueError as exc:
        decode_error = str(exc)
    ep_moe.set_mesh(None)
    del cache, bparams
    if on_card:
        torch.cuda.empty_cache()

    xs, ws, x = parallel_inputs(seed, device, rank)
    group = RankShards.of_group(dist.group.WORLD)
    qt = quantize(xs[rank])
    mean, ar_observed = observed_by(compressed_allreduce_mean, xs[rank],
                                    dist.group.WORLD)
    allreduce = {"mean": sha(mean), "observed": ar_observed,
                 "payloads": sha(group.all_gather([qt.q], "group")[0]),
                 "scales": sha(group.all_gather([qt.scale], "group")[0])}
    del xs, mean, qt
    pipe_dm = make_mesh((PIPE_STAGES,), ("pipe",)).device_mesh()
    out, pipe_observed = observed_by(
        pipeline_apply, tanh_stage, ws[rank:rank + 1], x, pipe_dm)
    return {"rank": rank, "form": type(collectives.shards(dm)).__name__,
            "started_s": started_s, "ready_s": ready_s,
            "prefill_ms": prefill_ms, "launches": launches,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if on_card else None),
            "card_used_gb_after_prefill": (total - free) / 1e9,
            "logits": logits.cpu(), "kept": [k.cpu() for k in kept],
            "aux": [[t.cpu() for t in a_] for a_ in aux],
            "observed": observed, "decode_raises": decode_error,
            "allreduce": allreduce,
            "pipeline": {"out": out.cpu(), "observed": pipe_observed}}


def phase_dist(args, card: str, device, ep_ref: dict,
               par_ref: dict) -> dict:
    """The rank form of the parallel layers on the card: ``EP_SHARDS``
    spawned rank processes (``dist_rank``) on ``cuda:0``, gloo over a file
    store in a temporary directory, each held against the list form's run
    of ``ep_path`` and ``parallel`` with the same seed and inputs: the
    prefill's logits, kept slots, ``MoeAux`` and observed collectives
    byte for byte, K2 once per layer and K5 three times per MoE layer on
    every rank, a decode step raising on every rank, and the int8
    all-reduce and the pipeline byte for byte."""
    cfg = replace(get_config(MOE_ARCH), moe_impl="ep")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(dist_rank, EP_SHARDS, os.path.join(tmp, "store"),
                          args.seed, t0, device.type,
                          timeout_s=DIST_TIMEOUT_S)
    seconds = time.time() - t0
    moe_layers = cfg.n_blocks * sum(s.ffn == "moe" for s in cfg.pattern())
    want = {"flash_attention": cfg.n_layers, "decode_attention": 0,
            "ssd_scan": 0, "moe_gmm": 3 * moe_layers}
    M = EP_SHARDS
    checks = {
        "rank_form": all(r["form"] == "RankShards" for r in ranks),
        "launches": all(r["launches"] == want for r in ranks),
        "logits_equal": all(same_bytes(r["logits"], ep_ref["logits"])
                            for r in ranks),
        "kept_equal": all(
            len(r["kept"]) == moe_layers and all(
                torch.equal(k, ep_ref["kept"][layer * M + r["rank"]])
                for layer, k in enumerate(r["kept"])) for r in ranks),
        "aux_equal": all(
            len(r["aux"]) == len(ep_ref["aux"]) and all(
                same_bytes(a, b) for got, ref in zip(r["aux"], ep_ref["aux"])
                for a, b in zip(got, ref)) for r in ranks),
        "collectives_equal": all(r["observed"] == ep_ref["observed"]
                                 for r in ranks),
        "decode_raises": all(r["decode_raises"] for r in ranks),
        "allreduce_equal": all(r["allreduce"] == par_ref["allreduce"]
                               for r in ranks),
        "pipeline_equal": all(
            same_bytes(r["pipeline"]["out"], par_ref["pipeline"]["out"])
            and r["pipeline"]["observed"] == par_ref["pipeline"]["observed"]
            for r in ranks),
    }
    run = {
        "arch": cfg.name, "moe_impl": cfg.moe_impl, "gpu": card,
        "ranks": M, "device": f"{device.type}:0 in every rank",
        "backend": "gloo, CUDA tensors staged through pinned host buffers",
        "mesh": {"data": 1, "model": M}, "batch": SERVE_BATCH,
        "prompt_len": PROMPT_LEN, "seconds": seconds,
        "started_s": [r["started_s"] for r in ranks],
        "spawn_to_ready_s": [r["ready_s"] for r in ranks],
        "prefill_ms_rank0": ranks[0]["prefill_ms"],
        "prefill_ms": [r["prefill_ms"] for r in ranks],
        "prefill_note": "four processes share one card and gloo copies "
                        "through the host: not a multi-card time",
        "list_form_prefill_ms": ep_ref["prefill_ms"],
        "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
        "peak_memory_gb_sum": (sum(r["peak_memory_gb"] for r in ranks)
                               if device.type == "cuda" else None),
        "card_used_gb_after_prefill": max(
            r["card_used_gb_after_prefill"] for r in ranks),
        "launches_per_rank": ranks[0]["launches"],
        "launches_expected_per_rank": want,
        "collectives_per_rank": collective_counts(ranks[0]["observed"]),
        "decode_raises": ranks[0]["decode_raises"],
        "allreduce_collectives": collective_counts(
            ranks[0]["allreduce"]["observed"]),
        "pipeline_collectives": collective_counts(
            ranks[0]["pipeline"]["observed"]),
        "checks": checks,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        emit({"phase": "dist_path", "ok": False, **run})
    check(not failed, "dist: " + ", ".join(failed))
    return run


# -- the sharded train step ---------------------------------------------------

#: ``shard_path``: the sharded train step (``make_train_step(..., shards=,
#: shardings=state_shardings(..., zero_opt=))``), one participant a rank
#: process, ``SHARD_RANKS`` of them on the one card as in ``dist_path``
#: (gloo through pinned host buffers; not a multi-card time).  Per case:
#: the (data, model) mesh, the depth of its bf16 steps (None: the
#: config's), the batch, ZeRO-1, and the depth of its float32 check.
#: granite-moe-1b-a400m shards its kv heads (8 over 4) and experts (32 over
#: 4): K2 at ``[8, 512, 4, 64]`` over 2 kv heads, K5 over 8 local experts;
#: glm4-9b replicates its 2 kv heads: 8 query heads a participant over one
#: kv head (n_rep 8); mamba2-130m runs 12 of its 24 SSD heads on 4 of the 8
#: rows, its ``inner_norm`` summed over ``"model"``, its moments under
#: ZeRO-1.  The cuts are the phase's time (the whole run may add 90 s):
#: every model-region end moves an activation through the host (gloo,
#: ~0.6 GB/s), so on an H100 (NVIDIA H100 80GB HBM3, 700.00 W) granite's
#: 24 layers at 8 x 512 took 7.9 s a step and 8 layers 3.0 s, glm4 at 8 x
#: 512 3.2 s, mamba2's 24 layers 2.5 s; with the float32 checks (glm4's
#: gathers of its 2.5 GB embedding and head ~15 s) the phase read 80-89 s.
#: granite and mamba2 run 4 and 8 layers, glm4 4 x 512.
#: seamless-m4t-medium (the encoder-decoder) on (1, 4):
#: 4 of 16 heads over 4 of 16 kv heads, 64 064 of its 256 256 vocabulary
#: columns a participant, 4 + 4 of its 12 + 12 layers, 4 x 512 tokens and
#: 128 frames, its float32 check at 2 + 2.  It has no partial leaf on
#: (1, 4) (its kv heads shard; every leaf read inside a region is
#: sharded), so its float32 control (``f32_control``) is the encoder's
#: output entering the decoder's cross-attention outside the model region:
#: its gradient, and every encoder leaf's, not summed over ``"model"``.
#: ``UNEVEN_KEY``: mamba2-130m on (1, 16), the production cut of its 24 SSD
#: heads (96 channels, 1.5 heads a participant), in a pool of its own of
#: ``UNEVEN_RANKS`` rank processes on the one card (``uneven_path``),
#: 4 of 24 layers in bf16 and in float32, 2 x 512, 2 steps; its float32
#: control is the partial leaves', its serving case's ``unoffset``.  Cut
#: for the phase's time: at 8 layers a step read 4.5-6.1 s a rank, the
#: float32 check with an ``unoffset`` gradient run 30 s, and the whole
#: script 1036 s (NVIDIA H100 80GB HBM3, 700.00 W).  ``ranks``: the pool a
#: case runs in.
#: ``bf16_loss_against: "float32"``: step 1's bf16 loss is held to the
#: unsharded float32 loss at the case's depth and batch instead of the
#: unsharded bf16 one.  For seamless the unsharded bf16 loss is itself
#: 1.4e-5-1.9e-5 from the float32 one at 4 + 4 layers, 4 x 512 (seeds 0
#: and 1, NVIDIA H100 80GB HBM3, 700.00 W), and the sharded step, whose
#: region ends sum float32 partials, 4.0e-6 (seed 0): its distance to the
#: unsharded bf16 loss (1.54e-5) read the reference's own rounding.
SHARD_RANKS = 4
SHARD_STEPS = 3
SHARD_TIMEOUT_S = 900.0
UNEVEN_RANKS = 16
UNEVEN_KEY = f"{SSM_ARCH}/uneven"
#: The ep cases (``shard_path`` and ``shard_serve_path``): granite-moe
#: with ``moe_impl="ep"`` inside the sharded step and prefill on (2, 2),
#: so that both the aux terms' psum over the data axes and the all_to_all
#: over ``"model"`` run; 4 of its 24 layers (float32 at 2) for the phase's
#: time.  A participant routes 4 rows x 256 positions at top-8 (8192
#: slots), sends ``cap`` = 5120 a destination and receives 10 240 rows
#: over its 16 of 32 experts (20 480 in the 8 x 1024 prefill).  Held to
#: the unsharded ep step over the same mesh (the list form in one
#: process), its routing replayed on each participant's calls; the
#: float32 controls: the entry's backward keeping the participant's own
#: block of ``dx``, the aux terms' gradient whole on every model
#: participant, the router unsummed over ``"model"`` (the partial leaves'
#: control), and in serving every block of the output the participant's
#: own.  The prefill's decode step must raise ``ValueError`` on every rank.
EP_KEY = f"{MOE_ARCH}/ep"
EP_CONTROLS = ("own_block_entry", "aux_on_every_model_participant")
SHARD_CASES = {
    MOE_ARCH: {"arch": MOE_ARCH, "mesh": (1, 4), "layers": 4,
               "batch": (8, 512), "zero_opt": False, "f32_layers": 4},
    SERVE_ARCH: {"arch": SERVE_ARCH, "mesh": (1, 4), "layers": 2,
                 "batch": (4, 512), "zero_opt": False, "f32_layers": 2},
    SSM_ARCH: {"arch": SSM_ARCH, "mesh": (2, 2), "layers": 8,
               "batch": (8, 1024), "zero_opt": True, "f32_layers": 4},
    ENCDEC_ARCH: {"arch": ENCDEC_ARCH, "mesh": (1, 4), "layers": 4,
                  "batch": (4, 512), "zero_opt": False, "f32_layers": 2,
                  "f32_control": "unentered_encoder_output",
                  "bf16_loss_against": "float32"},
    UNEVEN_KEY: {"arch": SSM_ARCH, "mesh": (1, 16), "layers": 4,
                 "batch": (2, 512), "zero_opt": False, "f32_layers": 4,
                 "steps": 2, "ranks": UNEVEN_RANKS},
    EP_KEY: {"arch": MOE_ARCH, "mesh": (2, 2), "layers": 4,
             "batch": (8, 512), "zero_opt": False, "f32_layers": 2,
             "moe_impl": "ep", "f32_control": EP_CONTROLS},
}
#: bf16: step 1's loss and global gradient norm against the unsharded bf16
#: step on the same parameters and batch (routing replayed), relative, at
#: ``train_path``'s ``grad_bf16`` limits; glm4-9b has no ``train_path``
#: reading and takes granite-moe's (its loss read 2.02e-5 / 5.39e-5 at
#: seeds 0 / 1 with each region end's bf16 partials summed, 1.33e-5 /
#: 2.47e-5 with them formed in float32 and rounded once: NVIDIA H100 80GB
#: HBM3, 700.00 W).  float32: the loss and every gathered
#: gradient leaf against the unsharded step at ``grad_f32``'s limits, and
#: the same gradients without the sum over ``"model"`` of the partial
#: leaves (the control) must lie past the leaf limit.
SHARD_BF16_LIMITS = {
    arch: (TRAIN_BF16_LOSS_RTOL[src], TRAIN_BF16_GNORM_RTOL[src])
    for arch, src in ((MOE_ARCH, MOE_ARCH), (SERVE_ARCH, MOE_ARCH),
                      (SSM_ARCH, SSM_ARCH), (ENCDEC_ARCH, ENCDEC_ARCH))}
SHARD_OPT = AdamWConfig()
#: ``shard_path``'s compressed case: ``make_train_step(..., compress=True,
#: shards=)`` on the three-axis mesh ``COMPRESS_AXES`` (pod 2, data 1,
#: model 2; the batch over pod x data), bf16, ``SHARD_STEPS`` steps, and
#: its float32 check at ``f32_layers``.  olmoe-1b-7b runs K2 (8 of 16
#: heads a participant) and K5 (32 of 64 experts), and its ``head``
#: (2048 x 50304, cut by columns: 25 152 a participant) has int8 blocks
#: that straddle the model cut, where the scales need the max over
#: ``"model"``.  Cut to one of its 16 layers for the card's memory: at a
#: model axis of 2 every rank holds half of every leaf, so the four
#: ranks on one card hold two whole states; glm4-9b at 2 layers (1.65 B
#: parameters, 1.24 B of them its embedding and head) needs ~40 GB a rank
#: with its moments and residual, and granite-moe's blocks all fall on
#: whole int8 blocks at model 2.
SHARD_COMPRESS = {"arch": "olmoe_1b_7b", "mesh": (2, 1, 2), "layers": 1,
                  "batch": (4, 512), "f32_layers": 1}
COMPRESS_AXES = ("pod", "data", "model")
#: ``tests/test_torch_train.py``'s three-step rule: params, moments and
#: the residual (on its gradient's scale, 127 x its own) within 1e-5 of
#: each leaf's scale on all but 1 % of the elements, and the losses within
#: 1e-5 relative; step 1's loss also within ``TRAIN_F32_LOSS_RTOL``.
COMPRESS_STEP_TOL = 1e-5
COMPRESS_OUTLIER_SHARE = 0.01
#: K3's statistics form at the JAX package's ``long_500k`` decode:
#: jamba-v0.1-52b's attention width (32 heads over 8 kv heads of 128)
#: against a cache of ``LONG_CACHE`` positions cut into ``LONG_BLOCKS``
#: blocks (its sequence over a data axis of 4), the token in block 2.
LONG_CACHE = 524_288
LONG_BLOCKS = 4
LONG_CACHE_LEN = 2 * LONG_CACHE // LONG_BLOCKS + 54_321
#: ``shard_serve_path``: sharded prefill and decode (``Model.init_cache`` /
#: ``prefill`` / ``decode`` with ``shards=``) in ``shard_path``'s rank
#: processes, bf16, ``SERVE_BATCH`` x ``PROMPT_LEN`` prompts and
#: ``SHARD_SERVE_NEW`` greedy tokens into a cache of ``SHARD_SERVE_LEN``
#: positions: granite-moe head-sharded (K2, K3, K5), glm4-9b hd-sharded
#: (K2; K3 never), mamba2 with the batch over dp and its SSD heads over
#: model (K4), at ``layers`` (cut for the phase's time: at 8 / 4 layers
#: the whole run read 703.7 s on an H100; mamba2's cases and granite's
#: fully-seq one, at 24 layers until the ep cases came, at 8 for theirs;
#: the two fully-seq ones at 4 since the encoder-decoder's and jamba's
#: fully-seq cases came: with them the whole script read 1143.3 s on an
#: NVIDIA H100 80GB HBM3, 700.00 W, against its limit of 1200),
#: the float32 check at
#: ``f32_layers``; ``layout`` is the attention cache's layout the case
#: must take (``lm.serve_layout``; None: no attention).  The fully-seq
#: cases (keys ``arch/fully_seq``) take a batch of 1 that no data axis of
#: more than one divides, with ``FS_PROMPT_LEN`` prompts into the same
#: cache: on dp 4 its blocks are 262 positions long, so the 16 steps write
#: 512-527 and cross from rank 1's block into rank 2's at 524, and rank
#: 3's holds no valid position; on dp 2 (blocks of 524) they cross at 524
#: too.  ``full_cache``: the case decodes into a full cache (re-prefilled
#: to ``SHARD_SERVE_LEN - 8`` positions where its steps end short of
#: that).
SHARD_SERVE_NEW = 16
SHARD_SERVE_LEN = PROMPT_LEN + SHARD_SERVE_NEW + 8
FS_PROMPT_LEN = 512
#: ``shard_serve_path``'s encoder-decoder case: seamless-m4t-medium on
#: (1, 4) at 4 + 4 layers (float32 too), 8 x 1024 prompts and
#: ``ENC_FRAMES`` frames, the head-sharded self and cross caches, its
#: control every participant's cross K/V projected from participant 0's kv
#: heads; and ``uneven_path``'s serving case: mamba2-130m on (1, 16) at 4
#: layers (float32 too), 2 x 512 prompts, 8 steps into a cache of 528,
#: its SSD state whole on every rank, its control ``unoffset``.  ``new`` and
#: ``max_len`` default to ``SHARD_SERVE_NEW`` and ``SHARD_SERVE_LEN``.
UNEVEN_SERVE_NEW = 8
UNEVEN_SERVE_LEN = 512 + UNEVEN_SERVE_NEW + 8
#: The fully-seq encoder-decoder (keys ``seamless_m4t_medium/fully_seq``
#: and ``/fully_seq_hd``): seamless at batch 1, 4 + 4 layers (float32
#: too), ``FS_PROMPT_LEN`` prompts and ``ENC_FRAMES`` frames, on (4, 1)
#: (``"seq"``: 16 kv heads whole, self blocks of 262 positions, cross
#: blocks of 64 encoder positions, K3's statistics form over both) and on
#: (2, 2) (``"seq_hd"``: ``head_dim`` 32 a participant, K3 never); the
#: float32 check runs each of its ``controls``: the layout's, and the
#: cross cache cut at encoder position 0 on every participant.
#: jamba-v0.1-52b fully-seq (keys ``jamba_v0_1_52b/fully_seq`` and
#: ``/fully_seq_hd``), the JAX package's ``long_500k`` decode: batch 1
#: into a cache of ``LONG_CACHE`` positions (the cell's cache; its prompt
#: cut to ``FS_PROMPT_LEN``), bf16 at 8 layers (one period of its
#: pattern), every width whole: on (2, 1) (``"seq"``: blocks of 262 144
#: positions, K3's statistics form at jamba's width on rank 0's block and
#: on rank 1's empty one, K5 over all 16 experts a rank; its own pool of
#: ``LONG_RANKS`` rank processes, ``long_path``) and on (2, 2) (``"seq_hd"``,
#: the production meshes' layout of that cell: K3 never, K5 over 8
#: experts, K4 over 64 of 128 SSD heads).  No float32 check
#: (``f32_layers`` None): a float32 master of 8 layers is 53 GB, and the
#: data participants would each hold one.  The bf16 run builds each rank's
#: block leaf by leaf (``seeded_block``) and adds a control: the block's
#: ``CONTROL_WEIGHTS`` rounded to ``CONTROL_BITS`` bits, whose prefill and
#: first step must leave ``serve_path``'s limit.
LONG_RANKS = 2
SHARD_SERVE_CASES = {
    MOE_ARCH: {"arch": MOE_ARCH, "mesh": (1, 4), "layers": 4,
               "f32_layers": 4, "layout": "head", "batch": SERVE_BATCH,
               "prompt": PROMPT_LEN, "full_cache": True},
    SERVE_ARCH: {"arch": SERVE_ARCH, "mesh": (1, 4), "layers": 2,
                 "f32_layers": 2, "layout": "hd", "batch": SERVE_BATCH,
                 "prompt": PROMPT_LEN, "full_cache": True},
    SSM_ARCH: {"arch": SSM_ARCH, "mesh": (2, 2), "layers": 8,
               "f32_layers": 4, "layout": None, "batch": SERVE_BATCH,
               "prompt": PROMPT_LEN, "full_cache": False},
    f"{MOE_ARCH}/fully_seq": {
        "arch": MOE_ARCH, "mesh": (4, 1), "layers": 4, "f32_layers": 4,
        "layout": "seq", "batch": 1, "prompt": FS_PROMPT_LEN,
        "full_cache": True},
    f"{SERVE_ARCH}/fully_seq": {
        "arch": SERVE_ARCH, "mesh": (2, 2), "layers": 2, "f32_layers": 2,
        "layout": "seq_hd", "batch": 1, "prompt": FS_PROMPT_LEN,
        "full_cache": False},
    f"{SSM_ARCH}/fully_seq": {
        "arch": SSM_ARCH, "mesh": (2, 2), "layers": 4, "f32_layers": 4,
        "layout": None, "batch": 1, "prompt": FS_PROMPT_LEN,
        "full_cache": False},
    ENCDEC_ARCH: {"arch": ENCDEC_ARCH, "mesh": (1, 4), "layers": 4,
                  "f32_layers": 4, "layout": "head", "batch": SERVE_BATCH,
                  "prompt": PROMPT_LEN, "frames": ENC_FRAMES,
                  "full_cache": True, "control": "cross_from_participant_0"},
    UNEVEN_KEY: {"arch": SSM_ARCH, "mesh": (1, 16), "layers": 4,
                 "f32_layers": 4, "layout": None, "batch": 2, "prompt": 512,
                 "new": UNEVEN_SERVE_NEW, "max_len": UNEVEN_SERVE_LEN,
                 "full_cache": False, "control": "unoffset",
                 "ranks": UNEVEN_RANKS},
    EP_KEY: {"arch": MOE_ARCH, "mesh": (2, 2), "layers": 4,
             "f32_layers": 2, "layout": "head", "batch": SERVE_BATCH,
             "prompt": PROMPT_LEN, "full_cache": False, "moe_impl": "ep",
             "prefill_only": True, "control": "own_block_exit"},
    f"{ENCDEC_ARCH}/fully_seq": {
        "arch": ENCDEC_ARCH, "mesh": (4, 1), "layers": 4, "f32_layers": 4,
        "layout": "seq", "batch": 1, "prompt": FS_PROMPT_LEN,
        "frames": ENC_FRAMES, "full_cache": False,
        "controls": ("unoffset_cache_len", "cross_cut_at_0")},
    f"{ENCDEC_ARCH}/fully_seq_hd": {
        "arch": ENCDEC_ARCH, "mesh": (2, 2), "layers": 4, "f32_layers": 4,
        "layout": "seq_hd", "batch": 1, "prompt": FS_PROMPT_LEN,
        "frames": ENC_FRAMES, "full_cache": False,
        "controls": ("equal_block_weights", "cross_cut_at_0")},
    f"{HYBRID_ARCH}/fully_seq_hd": {
        "arch": HYBRID_ARCH, "mesh": (2, 2), "layers": 8, "f32_layers": None,
        "layout": "seq_hd", "batch": 1, "prompt": FS_PROMPT_LEN,
        "max_len": LONG_CACHE, "full_cache": False},
    f"{HYBRID_ARCH}/fully_seq": {
        "arch": HYBRID_ARCH, "mesh": (2, 1), "layers": 8, "f32_layers": None,
        "layout": "seq", "batch": 1, "prompt": FS_PROMPT_LEN,
        "max_len": LONG_CACHE, "full_cache": False, "ranks": LONG_RANKS},
}
#: The float32 check's control per layout: one step of the sharded decode
#: broken (``serve_control``), which must leave the limit.
SHARD_SERVE_CONTROLS = {"head": "exclusive_mask", "hd": "unsummed_scores",
                        "seq": "unoffset_cache_len",
                        "seq_hd": "equal_block_weights",
                        None: "per_block_norm"}


def shard_config(arch: str, layers: int | None, **kw):
    """``arch`` at full width, cut to ``layers`` (None: its depth; an
    encoder-decoder's encoder too)."""
    cfg = get_config(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers, **(
            {"enc_layers": layers} if cfg.enc_layers else {})).validate()
    return replace(cfg, **kw)


def case_config(case: dict, layers: int | None, **kw):
    """A ``SHARD_CASES`` / ``SHARD_SERVE_CASES`` entry's config: its arch
    at ``layers`` (``shard_config``), with the case's ``moe_impl`` where it
    names one."""
    if "moe_impl" in case:
        kw = {"moe_impl": case["moe_impl"], **kw}
    return shard_config(case["arch"], layers, **kw)


@contextlib.contextmanager
def unsharded_mesh(case: dict):
    """Around the unsharded run that a case's sharded run is held to:
    under ``moe_impl="ep"`` the case's mesh published for it
    (``ep_moe.set_mesh``: every shard in this process, the list form).
    Yields the router calls a routing makes (the shards: one each)."""
    if case.get("moe_impl") != "ep":
        yield 1
        return
    mesh = make_mesh(case["mesh"], ("data", "model"))
    ep_moe.set_mesh(mesh)
    try:
        yield mesh.size
    finally:
        ep_moe.set_mesh(None)


def own_calls(recorded: list, case: dict, part) -> list:
    """The unsharded run's router calls that ``part`` replays: all of
    them, or under ``moe_impl="ep"`` (every shard's call in shard order,
    call after call) its own shard's."""
    if case.get("moe_impl") != "ep":
        return recorded
    return recorded[part.di * part.m + part.mi::part.mesh.size]


class WholeMean(torch.autograd.Function):
    """``tensor.mean_over_mesh`` with its gradient whole on every model
    participant (the ep aux control)."""

    @staticmethod
    def forward(ctx, x, part):
        return part.pmean_mesh(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def pool_cases(table: dict, ranks: int) -> dict:
    """The entries of ``SHARD_CASES`` or ``SHARD_SERVE_CASES`` that run in
    the pool of ``ranks`` rank processes."""
    return {k: c for k, c in table.items()
            if c.get("ranks", SHARD_RANKS) == ranks}


def shard_control(name: str, part=None):
    """A named control of the sharded runs, as a context: ``unoffset``
    (each block of the SSD's channels mapped to heads as if it began at a
    head boundary: a straddled head reads the wrong ``dt``, ``A`` and
    ``D``), ``unentered_encoder_output`` (the encoder's output read by the
    cross-attention outside the model region: its gradient not summed over
    ``"model"``), the ep layer's ``own_block_entry`` (its entry's gradient
    only the participant's own block of ``dx``: plain slicing),
    ``aux_on_every_model_participant`` (the aux means' gradient whole on
    every model participant: ``m`` times the reference's) and
    ``own_block_exit`` (every block of its output the participant's own);
    any other name is ``serve_control``'s."""
    from unittest import mock

    from repro_torch.models import encdec, ssd

    if name == "unoffset":
        return mock.patch.object(ssd, "slot_offset", lambda c0, P: 0)
    if name == "unentered_encoder_output":
        return mock.patch.object(encdec, "enter_model_region",
                                 lambda x, part: x)
    if name == "own_block_entry":
        def own(x, part):
            n = x.shape[1] // part.m
            return x[:, part.mi * n:(part.mi + 1) * n]
        return mock.patch.object(ep_moe, "enter_sequence_block", own)
    if name == "aux_on_every_model_participant":
        return mock.patch.object(ep_moe, "mean_over_mesh",
                                 lambda x, part: WholeMean.apply(x, part))
    if name == "own_block_exit":
        return mock.patch.object(ep_moe, "leave_sequence_block",
                                 lambda x, part: x.repeat(1, part.m, 1))
    return serve_control(name)


def local_heads(cfg, m: int) -> tuple[int, int]:
    """Query and kv heads one participant's K2 launch takes at a model axis
    of ``m`` (``models/layers.py``'s ``_attention_sharded``, participant
    0): the kv heads its query heads read."""
    from repro_torch.parallel.sharding import kv_shardable

    H, KV = cfg.n_heads // m, cfg.n_kv_heads
    if kv_shardable(cfg, m):
        return H, KV // m
    n_rep = cfg.n_heads // KV
    return H, (H - 1) // n_rep + 1


def shard_kernel_shapes(gen, device) -> dict:
    """The kernels' launches at the sharded shapes of ``SHARD_CASES``
    (participant 0): K2 at granite's and glm4's, K4 at mamba2's, K5 at
    granite's local experts (their group sizes from a random router over
    all experts: about a quarter of the routed rows)."""
    out = {}
    for key, arch in (("granite", MOE_ARCH), ("glm4", SERVE_ARCH)):
        cfg, case = get_config(arch), SHARD_CASES[arch]
        (dp, m), (B, S) = case["mesh"], case["batch"]
        H, KV = local_heads(cfg, m)
        out[f"flash_attention_{key}"] = (B // dp, S, H, KV, cfg.head_dim)
    cfg, case = get_config(SSM_ARCH), SHARD_CASES[SSM_ARCH]
    (dp, m), (B, S) = case["mesh"], case["batch"]
    out["ssd_scan"] = (B // dp, S, cfg.ssm_heads // m, cfg.ssm_groups,
                       cfg.ssm_state, cfg.ssm_chunk)
    cfg, case = get_config(MOE_ARCH), SHARD_CASES[MOE_ARCH]
    (dp, m), (B, S) = case["mesh"], case["batch"]
    E = cfg.moe_experts
    sizes = routed_sizes(gen, B // dp * S * cfg.moe_top_k, E, device)
    out["moe_gmm"] = (sizes[:E // m], cfg.d_model, cfg.expert_d_ff)
    # shard_serve_path's: K2 at the prefills' local heads, K3 at granite's
    # local cache at the last step, K5 at granite's local experts' share
    # of a prefill's and of a step's routed slots
    for key, arch in (("granite", MOE_ARCH), ("glm4", SERVE_ARCH)):
        cfg = get_config(arch)
        dp, m = SHARD_SERVE_CASES[arch]["mesh"]
        H, KV = local_heads(cfg, m)
        out[f"serve_flash_attention_{key}"] = (SERVE_BATCH // dp, PROMPT_LEN,
                                               H, KV, cfg.head_dim)
    cfg = get_config(MOE_ARCH)
    dp, m = SHARD_SERVE_CASES[MOE_ARCH]["mesh"]
    H, KV = local_heads(cfg, m)
    out["serve_decode_attention_granite"] = (
        SERVE_BATCH // dp, SHARD_SERVE_LEN, H, KV, cfg.head_dim,
        PROMPT_LEN + SHARD_SERVE_NEW - 1)
    for key, tokens in (("prefill", PROMPT_LEN), ("decode", 1)):
        sizes = routed_sizes(gen, SERVE_BATCH // dp * tokens * cfg.moe_top_k,
                             E, device)
        out[f"serve_moe_gmm_{key}"] = (sizes[:E // m], cfg.d_model,
                                       cfg.expert_d_ff)
    # the fully-seq cases' (batch 1 x FS_PROMPT_LEN): K2 over granite's
    # (4, 1) and glm4's (2, 2) local heads, K3's statistics form over
    # granite's block of positions, K4 over mamba2's (2, 2) heads, K5 over
    # granite's local experts (all of them at a model axis of one) for a
    # prefill's and a step's slots
    for key, arch in (("granite", MOE_ARCH), ("glm4", SERVE_ARCH)):
        cfg = get_config(arch)
        dp, m = SHARD_SERVE_CASES[f"{arch}/fully_seq"]["mesh"]
        H, KV = local_heads(cfg, m)
        out[f"fs_flash_attention_{key}"] = (1, FS_PROMPT_LEN, H, KV,
                                            cfg.head_dim)
    cfg = get_config(MOE_ARCH)
    dp, m = SHARD_SERVE_CASES[f"{MOE_ARCH}/fully_seq"]["mesh"]
    H, KV = local_heads(cfg, m)
    n = -(-SHARD_SERVE_LEN // dp)
    out["fs_decode_stats_granite"] = (1, n, H, KV, cfg.head_dim, n - 1)
    for key, tokens in (("prefill", FS_PROMPT_LEN), ("decode", 1)):
        sizes = routed_sizes(gen, tokens * cfg.moe_top_k, E, device)
        out[f"fs_moe_gmm_{key}"] = (sizes[:E // m], cfg.d_model,
                                    cfg.expert_d_ff)
    cfg = get_config(SSM_ARCH)
    dp, m = SHARD_SERVE_CASES[f"{SSM_ARCH}/fully_seq"]["mesh"]
    out["fs_ssd_scan"] = (1, FS_PROMPT_LEN, cfg.ssm_heads // m,
                          cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk)
    # the encoder-decoder on (1, 4) (participant 0's 4 heads over 4 kv
    # heads, head_dim 64): K2 at the encoder (non-causal over the frames),
    # the decoder's causal self-attention and its cross-attention (1024
    # queries over 256 frames), K3 over the self cache at the last step and
    # over the cross cache; ``(B, Sq, Sk, H, KV, D, causal)`` and ``(B, S,
    # H, KV, D, cache_len)``
    cfg = get_config(ENCDEC_ARCH)
    H, KV = local_heads(cfg, SHARD_SERVE_CASES[ENCDEC_ARCH]["mesh"][1])
    D, B = cfg.head_dim, SHARD_SERVE_CASES[ENCDEC_ARCH]["batch"]
    out["encdec_flash_encoder"] = (B, ENC_FRAMES, ENC_FRAMES, H, KV, D,
                                   False)
    out["encdec_flash_self"] = (B, PROMPT_LEN, PROMPT_LEN, H, KV, D, True)
    out["encdec_flash_cross"] = (B, PROMPT_LEN, ENC_FRAMES, H, KV, D, False)
    out["encdec_decode_self"] = (B, SHARD_SERVE_LEN, H, KV, D,
                                 PROMPT_LEN + SHARD_SERVE_NEW - 1)
    out["encdec_decode_cross"] = (B, ENC_FRAMES, H, KV, D, ENC_FRAMES - 1)
    # mamba2 on (1, 16): participant 1's 96 channels from channel 96, laid
    # into the two head slots they touch at offset 32 (the other channels
    # zero); ``(B, S, H, G, N, Q, (off, n))``
    cfg, case = get_config(SSM_ARCH), SHARD_CASES[UNEVEN_KEY]
    P, m = cfg.ssm_head_dim, case["mesh"][1]
    n = cfg.d_inner // m
    off = n % P
    out["uneven_ssd_scan"] = (*case["batch"], -(-(off + n) // P),
                              cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk,
                              (off, n))
    # the fully-seq encoder-decoder (seamless on (4, 1), batch 1, every
    # head whole): K2 at the encoder, the decoder's self-attention and its
    # cross-attention (512 queries over 256 frames), K3's statistics form
    # over a full self block (262 of the 1048 positions) and a cross block
    # (64 of the 256 frames); ``(B, Sq, Sk, H, KV, D, causal)`` and ``(B,
    # S, H, KV, D, cache_len)``
    cfg = get_config(ENCDEC_ARCH)
    dp, m = SHARD_SERVE_CASES[f"{ENCDEC_ARCH}/fully_seq"]["mesh"]
    H, KV = local_heads(cfg, m)
    D = cfg.head_dim
    out["fs_encdec_flash_encoder"] = (1, ENC_FRAMES, ENC_FRAMES, H, KV, D,
                                      False)
    out["fs_encdec_flash_self"] = (1, FS_PROMPT_LEN, FS_PROMPT_LEN, H, KV,
                                   D, True)
    out["fs_encdec_flash_cross"] = (1, FS_PROMPT_LEN, ENC_FRAMES, H, KV, D,
                                    False)
    for key, n in (("self", -(-SHARD_SERVE_LEN // dp)),
                   ("cross", -(-ENC_FRAMES // dp))):
        out[f"fs_encdec_stats_{key}"] = (1, n, H, KV, D, n - 1)
    # jamba's fully-seq cases, (2, 1) and (2, 2) (``_hd``): K2 over the
    # prefill's local heads, K4 over its local SSD heads, K5 over its
    # local experts' share of a prefill's (1024) and a step's (2) slots;
    # K3's statistics form over rank 0's block of the (2, 1) cache at the
    # last step
    cfg = get_config(HYBRID_ARCH)
    E = cfg.moe_experts
    for key, suffix in ((f"{HYBRID_ARCH}/fully_seq", "jamba"),
                        (f"{HYBRID_ARCH}/fully_seq_hd", "jamba_hd")):
        dp, m = SHARD_SERVE_CASES[key]["mesh"]
        H, KV = local_heads(cfg, m)
        out[f"fs_flash_attention_{suffix}"] = (1, FS_PROMPT_LEN, H, KV,
                                               cfg.head_dim)
        out[f"fs_ssd_scan_{suffix}"] = (1, FS_PROMPT_LEN, cfg.ssm_heads // m,
                                        cfg.ssm_groups, cfg.ssm_state,
                                        cfg.ssm_chunk)
        for call, tokens in (("prefill", FS_PROMPT_LEN), ("decode", 1)):
            sizes = routed_sizes(gen, tokens * cfg.moe_top_k, E, device)
            while not int(sizes[:E // m].sum()):
                # a step routing none of its 2 slots to the local experts
                # launches no K5 there: the shape is a step's that does
                sizes = routed_sizes(gen, tokens * cfg.moe_top_k, E, device)
            out[f"fs_moe_gmm_{suffix}_{call}"] = (sizes[:E // m], cfg.d_model,
                                                  cfg.expert_d_ff)
    dp = SHARD_SERVE_CASES[f"{HYBRID_ARCH}/fully_seq"]["mesh"][0]
    out["fs_decode_stats_jamba"] = (1, LONG_CACHE // dp, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim,
                                    FS_PROMPT_LEN + SHARD_SERVE_NEW - 1)
    # the ep cases' (2, 2): participant 0's received rows in a train step
    # (8 x 512) and in the prefill (8 x 1024)
    cfg, case = get_config(MOE_ARCH), SHARD_CASES[EP_KEY]
    (dp, m), (B, S) = case["mesh"], case["batch"]
    for key, t_loc in (("ep_moe_gmm", B // dp * S // m),
                       ("ep_serve_moe_gmm", SERVE_BATCH // dp * PROMPT_LEN
                        // m)):
        out[key] = (ep_received_sizes(gen, t_loc, cfg, m, device),
                    cfg.d_model, cfg.expert_d_ff)
    return out


def ep_received_sizes(gen, t_loc: int, cfg, m: int, device) -> torch.Tensor:
    """K5's group sizes on participant 0 of the sharded ep layer: the
    ``m · cap`` rows it receives over its ``E / m`` experts.  From each of
    the ``m`` sources the slots a random router sends its experts
    (``routed_sizes`` over ``t_loc · k`` slots), cut at ``cap`` a
    destination; the rest of the buffer zero rows in the last group, as
    ``ep_moe._expert_ffn`` lays them out."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    cap = ep_moe.capacity(t_loc, k, m, 1.25)
    valid = torch.zeros(E // m, dtype=torch.int64, device=device)
    for _ in range(m):
        sizes = routed_sizes(gen, t_loc * k, E, device)[:E // m]
        kept = torch.cumsum(sizes, 0).clamp(max=cap)
        valid += torch.diff(kept, prepend=kept.new_zeros(1))
    valid[-1] += m * cap - valid.sum()
    return valid


#: The fully-seq cases' kernel shapes (``shard_kernel_shapes``), checked
#: and timed: K2 over a prefill's local heads (``(B, S, H, KV, D)``) and
#: the encoder-decoder's (``(B, Sq, Sk, H, KV, D, causal)``), K3's
#: statistics form over a block (``(B, S, H, KV, D, cache_len)``), K4, K5.
FS_FLASH = ("fs_flash_attention_granite", "fs_flash_attention_glm4",
            "fs_flash_attention_jamba", "fs_flash_attention_jamba_hd")
ENCDEC_FLASH = ("encdec_flash_encoder", "encdec_flash_self",
                "encdec_flash_cross", "fs_encdec_flash_encoder",
                "fs_encdec_flash_self", "fs_encdec_flash_cross")
FS_STATS = ("fs_decode_stats_granite", "fs_encdec_stats_self",
            "fs_encdec_stats_cross", "fs_decode_stats_jamba")
FS_SSD = ("fs_ssd_scan", "fs_ssd_scan_jamba", "fs_ssd_scan_jamba_hd")
FS_GMM = ("fs_moe_gmm_prefill", "fs_moe_gmm_decode",
          "fs_moe_gmm_jamba_prefill", "fs_moe_gmm_jamba_decode",
          "fs_moe_gmm_jamba_hd_prefill", "fs_moe_gmm_jamba_hd_decode")


def shard_kernel_checks(device, seed: int) -> list[dict]:
    """K2, K4 and K5 against their plain versions at the sharded shapes, in
    bf16 and float32, with the tolerances of the other checks."""
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    shapes = shard_kernel_shapes(gen, device)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        for key in ("flash_attention_granite", "flash_attention_glm4"):
            B, S, H, KV, D = shapes[key]
            out.append({**flash_case(gen, B, S, H, KV, D, dtype, True,
                                     device), "sharded": key})
        B, S, H, G, N, Q = shapes["ssd_scan"]
        out.append({**ssd_case(gen, B, S, H, G, N, Q, dtype, device),
                    "sharded": "ssd_scan_mamba2"})
        sizes, d, f = shapes["moe_gmm"]
        out.append({**gmm_case(gen, sizes, d, f, dtype, device,
                               "sharded gate/up"), "sharded": "moe_gmm"})
        out.append({**gmm_case(gen, sizes, f, d, dtype, device,
                               "sharded down"), "sharded": "moe_gmm"})
        for key in ("serve_flash_attention_granite",
                    "serve_flash_attention_glm4"):
            B, S, H, KV, D = shapes[key]
            out.append({**flash_case(gen, B, S, H, KV, D, dtype, True,
                                     device), "sharded": key})
        B, S, H, KV, D, last = shapes["serve_decode_attention_granite"]
        for n in sorted({last, *decode_corners(B, S, H, KV, device)}):
            out.append({**decode_case(gen, B, S, H, KV, D, dtype, n, device),
                        "sharded": "serve_decode_attention_granite"})
        for key in ("prefill", "decode"):
            sizes, d, f = shapes[f"serve_moe_gmm_{key}"]
            for label, K, N in (("gate/up", d, f), ("down", f, d)):
                out.append({**gmm_case(gen, sizes, K, N, dtype, device,
                                       f"sharded {key} {label}"),
                            "sharded": f"serve_moe_gmm_{key}"})
        for key in FS_FLASH:
            B, S, H, KV, D = shapes[key]
            out.append({**flash_case(gen, B, S, H, KV, D, dtype, True,
                                     device), "sharded": key})
        for key in FS_STATS:
            B, S, H, KV, D, last = shapes[key]
            for n in sorted({-1, 0, S // 2, last, S - 1}):
                out.append({**decode_stats_case(gen, B, S, H, KV, D, dtype,
                                                n, device)[0],
                            "sharded": key})
        for key in FS_SSD:
            B, S, H, G, N, Q = shapes[key]
            out.append({**ssd_case(gen, B, S, H, G, N, Q, dtype, device),
                        "sharded": key})
        for key in ENCDEC_FLASH:
            B, Sq, Sk, H, KV, D, causal = shapes[key]
            out.append({**flash_case(gen, B, Sq, H, KV, D, dtype, causal,
                                     device, Sk=Sk), "sharded": key})
        for key in ("encdec_decode_self", "encdec_decode_cross"):
            B, S, H, KV, D, last = shapes[key]
            for n in sorted({last, *decode_corners(B, S, H, KV, device)}):
                out.append({**decode_case(gen, B, S, H, KV, D, dtype, n,
                                          device), "sharded": key})
        B, S, H, G, N, Q, channels = shapes["uneven_ssd_scan"]
        out.append({**ssd_case(gen, B, S, H, G, N, Q, dtype, device,
                               channels=channels),
                    "sharded": "uneven_ssd_scan"})
        for key in FS_GMM:
            sizes, d, f = shapes[key]
            for label, K, N in (("gate/up", d, f), ("down", f, d)):
                out.append({**gmm_case(gen, sizes, K, N, dtype, device,
                                       f"{key} {label}"), "sharded": key})
        for key in ("ep_moe_gmm", "ep_serve_moe_gmm"):
            sizes, d, f = shapes[key]
            for label, K, N in (("gate/up", d, f), ("down", f, d)):
                out.append({**gmm_case(gen, sizes, K, N, dtype, device,
                                       f"ep received rows {label}"),
                            "sharded": key})
    return out


def long_stats(device, seed: int, flush) -> dict:
    """K3's statistics form at the ``long_500k`` decode (``LONG_CACHE``):
    each of the ``LONG_BLOCKS`` blocks against its plain version, their
    ``combine_blocks`` against the default K3 over the whole cache within
    K3's bf16 tolerance, the last block (past the token) empty; then one
    full block's launch timed beside its plain version and SDPA, with its
    bound from ``roofline.decode_work``."""
    F = torch.nn.functional
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    cfg = get_config(HYBRID_ARCH)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf = torch.bfloat16
    q = _randn(gen, (1, H, D), bf, device)
    k = _randn(gen, (1, LONG_CACHE, KV, D), bf, device)
    v = _randn(gen, (1, LONG_CACHE, KV, D), bf, device)
    blk = LONG_CACHE // LONG_BLOCKS
    checks, stats, wants = [], [], []
    for i in range(LONG_BLOCKS):
        lo = i * blk
        local = max(-1, min(LONG_CACHE_LEN - lo, blk - 1))
        res, got, want = decode_stats_case(
            gen, 1, blk, H, KV, D, bf, local, device, q=q,
            kv=(k[:, lo:lo + blk], v[:, lo:lo + blk]))
        checks.append({**res, "block": i})
        stats.append(got)
        wants.append(want)
    o, m, l = (torch.stack(t) for t in zip(*stats))
    combined = decode_attention.combine_blocks(o, m, l)
    whole = decode_attention.decode_attention(
        q, k, v, torch.tensor(LONG_CACHE_LEN, dtype=torch.int32,
                              device=device))
    combine = compare(combined, whole, ATTN_TOL[bf],
                      "the blocks' combine against K3 over the whole cache")
    combine["rel_rms"] = rel_rms(combined, whole)
    # The controls, which must leave STATS_REL_RMS: block 1's o read as
    # block 0's, and the blocks that hold a position averaged with equal
    # weights (l · exp(m − M) dropped).
    controls = {
        "another_block_o": rel_rms(o[1], wants[0]),
        "equal_block_weights": rel_rms(decode_attention.combine_blocks(
            o, torch.zeros_like(m), (l > 0).float()), whole)}
    combine["controls_rel_rms"] = controls
    check(combine["rel_rms"] <= STATS_REL_RMS,
          f"the blocks' combine past {STATS_REL_RMS} relative RMS: {combine}")
    check(min(controls.values()) > STATS_REL_RMS,
          f"a statistics-form control within {STATS_REL_RMS}: {controls}")
    check(LONG_CACHE_LEN // blk == 2 and LONG_BLOCKS == 4,
          "the token must lie in block 2 of 4")
    del o, m, l, stats, wants, combined, whole
    kb, vb = k[:, :blk], v[:, :blk]
    nb = torch.tensor(blk - 1, dtype=torch.int32, device=device)
    q4, kt, vt = q[:, :, None, :], kb.transpose(1, 2), vb.transpose(1, 2)
    t = measure_fns({
        "ms": lambda: decode_attention.decode_attention(q, kb, vb, nb,
                                                        stats=True),
        "plain_ms": lambda: decode_attention.decode_attention_stats_torch(
            q, kb, vb, nb),
        "library_ms": lambda: F.scaled_dot_product_attention(
            q4, kt, vt, enable_gqa=True)}, flush, rounds=2)
    t.update(cache=[1, blk, KV, D], heads=H, cache_len=blk - 1,
             whole_cache=[1, LONG_CACHE, KV, D],
             whole_cache_len=LONG_CACHE_LEN, dtype="bfloat16",
             splits=decode_attention.split_plan(1, KV, H // KV, blk,
                                                sm_count(device)),
             **roofline.work_bound(roofline.decode_work(
                 1, H, KV, D, blk, bf, stats=True)))
    del q, k, v, kb, vb, q4, kt, vt
    torch.cuda.empty_cache()
    return {"checks": checks, "combine": combine, "timing": t,
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "o_rel_rms": max(c.get("o_rel_rms", 0.0) for c in checks)}


def fs_rounds(key: str) -> int:
    """Rounds of ``measure_fns`` for a sharded shape: one for the fully-seq
    cases' (``fs_*``: fifteen shapes, whose second round cost the whole
    script ~13 s of its time limit), two for the others."""
    return 1 if key.startswith("fs_") else 2


def shard_kernel_timings(device, seed: int, flush) -> dict:
    """K2, K4 and K5 (gate/up and down) at ``shard_path``'s sharded shapes,
    bf16, beside their plain versions and library calls, with their
    bounds; K2, K3 and K5 (gate/up) at ``shard_serve_path``'s beside their
    library calls only (every function timed costs a quarter-second
    warm-up a round, and the phase's time is held); K2, K3 and K4 at the
    encoder-decoder's and ``uneven_path``'s beside their plain versions
    and (K2, K3) SDPA; the same at the fully-seq encoder-decoder's and
    jamba's (K3's statistics form at seamless's full self and cross
    blocks and at jamba's (2, 1) block at the last step, its bound over
    the positions that step holds; K5's gate/up and down of jamba's
    prefill and gate/up of a step beside ``torch._grouped_mm``)."""
    F = torch.nn.functional
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    shapes = shard_kernel_shapes(gen, device)
    bf = torch.bfloat16
    out = {}
    flash = []
    for key in ("flash_attention_granite", "flash_attention_glm4",
                "serve_flash_attention_granite",
                "serve_flash_attention_glm4", "fs_flash_attention_jamba",
                "fs_flash_attention_jamba_hd"):
        B, S, H, KV, D = shapes[key]
        flash.append((key, B, S, S, H, KV, D, True))
    flash += [(key, *shapes[key]) for key in ENCDEC_FLASH]
    for key, B, Sq, Sk, H, KV, D, causal in flash:
        q = _randn(gen, (B, Sq, H, D), bf, device)
        k = _randn(gen, (B, Sk, KV, D), bf, device)
        v = _randn(gen, (B, Sk, KV, D), bf, device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"ms": lambda: flash_attention.flash_attention(q, k, v,
                                                             causal=causal),
               "library_ms": lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True)}
        if not key.startswith("serve_"):
            fns["plain_ms"] = lambda: flash_attention.flash_attention_torch(
                q, k, v, causal=causal)
        t = measure_fns(fns, flush, rounds=fs_rounds(key))
        t.update(shape=[B, Sq, H, D], keys=Sk, kv_heads=KV, causal=causal,
                 dtype="bfloat16", **roofline.work_bound(
                     roofline.flash_work(B, Sq, Sk, H, KV, D, bf, causal)))
        out[key] = t
        del q, k, v, qt, kt, vt
    for key, stats in (("encdec_decode_self", False),
                       ("encdec_decode_cross", False),
                       ("fs_encdec_stats_self", True),
                       ("fs_encdec_stats_cross", True),
                       ("fs_decode_stats_jamba", True)):
        B, S, H, KV, D, last = shapes[key]
        q = _randn(gen, (B, H, D), bf, device)
        kc = _randn(gen, (B, S, KV, D), bf, device)
        vc = _randn(gen, (B, S, KV, D), bf, device)
        n = torch.tensor(last, dtype=torch.int32, device=device)
        valid = (torch.arange(S, device=device) <= n)[None, None, None, :]
        q4, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        plain = (decode_attention.decode_attention_stats_torch if stats
                 else decode_attention.decode_attention_torch)
        t = measure_fns({
            "ms": lambda: decode_attention.decode_attention(q, kc, vc, n,
                                                            stats=stats),
            "plain_ms": lambda: plain(q, kc, vc, n),
            "library_ms": lambda: F.scaled_dot_product_attention(
                q4, kt, vt, attn_mask=valid, enable_gqa=True)},
            flush, rounds=fs_rounds(key))
        t.update(cache=[B, S, KV, D], heads=H, cache_len=last,
                 dtype="bfloat16", form="statistics" if stats else "default",
                 splits=decode_attention.split_plan(B, KV, H // KV, S,
                                                    sm_count(device)),
                 **roofline.work_bound(roofline.decode_work(
                     B, H, KV, D, last + 1, bf, stats=stats)))
        out[key] = t
        del q, kc, vc, q4, kt, vt, valid
    B, S, H, G, N, Q, channels = shapes["uneven_ssd_scan"]
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, H, G, N, bf, device)
    x, _ = owned_channels(x, channels)
    t = measure_fns({
        "ms": lambda: ssd_scan.ssd_intra_chunk(x, dt, A, Bm, Cm, Q),
        "plain_ms": lambda: ssd_scan.ssd_intra_chunk_torch(
            x, dt, A, Bm, Cm, Q)}, flush, rounds=2)
    t.update(shape=[B, S, H, 64], groups=G, state=N, chunk=Q,
             owned_channels=list(channels), dtype="bfloat16",
             library_ms=None,
             heads_per_block=ssd_scan.head_group_plan(
                 B, S, H, G, N, Q, sms=sm_count(device)),
             **roofline.work_bound(roofline.ssd_work(B, S, H, G, N, Q, bf)))
    out["uneven_ssd_scan"] = t
    del x, dt, A, Bm, Cm
    for key in ("ssd_scan", "fs_ssd_scan_jamba", "fs_ssd_scan_jamba_hd"):
        B, S, H, G, N, Q = shapes[key]
        x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, H, G, N, bf, device)
        t = measure_fns({
            "ms": lambda: ssd_scan.ssd_intra_chunk(x, dt, A, Bm, Cm, Q),
            "plain_ms": lambda: ssd_scan.ssd_intra_chunk_torch(
                x, dt, A, Bm, Cm, Q)}, flush, rounds=fs_rounds(key))
        t.update(shape=[B, S, H, 64], groups=G, state=N, chunk=Q,
                 dtype="bfloat16", library_ms=None,
                 heads_per_block=ssd_scan.head_group_plan(
                     B, S, H, G, N, Q, sms=sm_count(device)),
                 **roofline.work_bound(roofline.ssd_work(B, S, H, G, N, Q,
                                                         bf)))
        out[key] = t
        del x, dt, A, Bm, Cm
    B, S, H, KV, D, last = shapes["serve_decode_attention_granite"]
    q = _randn(gen, (B, H, D), bf, device)
    kc = _randn(gen, (B, S, KV, D), bf, device)
    vc = _randn(gen, (B, S, KV, D), bf, device)
    n = torch.tensor(last, dtype=torch.int32, device=device)
    valid = (torch.arange(S, device=device) <= n)[None, None, None, :]
    q4, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    t = measure_fns({
        "ms": lambda: decode_attention.decode_attention(q, kc, vc, n),
        "library_ms": lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=valid, enable_gqa=True)},
        flush, rounds=2)
    t.update(cache=[B, S, KV, D], heads=H, cache_len=last, dtype="bfloat16",
             splits=decode_attention.split_plan(B, KV, H // KV, S,
                                                sm_count(device)),
             **roofline.work_bound(roofline.decode_work(B, H, KV, D,
                                                        last + 1, bf)))
    out["serve_decode_attention_granite"] = t
    del q, kc, vc, q4, kt, vt
    gmm_keys = [("moe_gmm_gate_up", "moe_gmm", 0), ("moe_gmm_down",
                                                     "moe_gmm", 1)]
    gmm_keys += [(f"serve_moe_gmm_{key}_gate_up", f"serve_moe_gmm_{key}", 0)
                 for key in ("prefill", "decode")]
    gmm_keys += [("ep_moe_gmm_gate_up", "ep_moe_gmm", 0),
                 ("ep_moe_gmm_down", "ep_moe_gmm", 1),
                 ("ep_serve_moe_gmm_gate_up", "ep_serve_moe_gmm", 0)]
    gmm_keys += [(f"{key}_gate_up", key, 0) for key in FS_GMM[2:]]
    gmm_keys.append(("fs_moe_gmm_jamba_prefill_down",
                     "fs_moe_gmm_jamba_prefill", 1))
    for key, shape_key, down in gmm_keys:
        sizes, d, f = shapes[shape_key]
        K, N_ = (f, d) if down else (d, f)
        E = sizes.numel()
        xs = _randn(gen, (int(sizes.sum()), K), bf, device)
        w = (torch.randn((E, K, N_), generator=gen, device=device)
             / K ** 0.5).to(bf)
        lib, lib_name = grouped_mm_library(xs, w, sizes)
        fns = {"ms": lambda: moe_gmm.grouped_matmul(xs, w, sizes),
               "library_ms": lib}
        if not key.startswith("serve_"):
            fns["plain_ms"] = lambda: moe_gmm.grouped_matmul_torch(xs, w,
                                                                   sizes)
        t = measure_fns(fns, flush, rounds=fs_rounds(key))
        M = int(sizes.sum())
        t.update(rows=M, experts=E, K=K, N=N_, library=lib_name,
                 active_experts=int((sizes > 0).sum()),
                 rows_per_tile=moe_gmm.tile_rows(M, E), dtype="bfloat16",
                 **gmm_bound(sizes, K, N_, bf))
        out[key] = t
        del xs, w
    return out


def fingerprint(t: torch.Tensor) -> int:
    """A 64-bit checksum of a tensor's bits, on its device: its 4-byte (or
    2-byte) words times odd multipliers by position, summed with
    wrap-around; any changed bit changes it (but by a collision, 2^-64)."""
    word = {4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()]
    flat = t.contiguous().reshape(-1).view(word)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    step = 1 << 24
    for lo in range(0, flat.numel(), step):
        x = flat[lo:lo + step].to(torch.int64)
        idx = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                           device=t.device)
        total += (x * (idx * 0x9E3779B1 | 1)).sum()
    return int(total)


def zero_blocks(shardings, abstract, device):
    """Float32 zeros of one participant's blocks: ``abstract``'s leaves'
    shapes cut by ``shardings``."""
    from repro_torch.parallel.sharding import shard_shape

    return tree.map(lambda sh, leaf: torch.zeros(
        shard_shape(leaf.shape, sh), dtype=torch.float32, device=device),
        shardings, abstract)


def zero_moments(shardings, abstract, device):
    """Zero AdamW moments of one participant's blocks."""
    return AdamWState(m=zero_blocks(shardings.m, abstract.m, device),
                      v=zero_blocks(shardings.v, abstract.v, device),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def shard_reference(args, device, key: str) -> dict:
    """The unsharded bf16 step of case ``key`` (its depth, its first
    batch, seeded parameters): loss, global gradient norm, and the
    routing it recorded (forward and recompute, on the host), which step
    1 of the sharded run replays."""
    case = SHARD_CASES[key]
    cfg = case_config(case, case["layers"])
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(
        args.seed))
    B, S = case["batch"]
    batch = train_batch(cfg, B, S, args.seed, 0, device)
    with unsharded_mesh(case) as shards:
        routing = TrainRouting(cfg, shards)
        with routing.record():
            _, metrics = train_step_mod.make_train_step(model, SHARD_OPT)(
                {"params": params, "opt": train_step_mod.adamw_init(params)},
                batch)
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "recompute_routing_equal": routing.recompute_equal,
           "routing": [t.cpu() for t in routing.recorded]}
    if case.get("bf16_loss_against") == "float32":
        del params
        cfg32 = case_config(case, case["layers"], dtype="float32")
        model32 = Model(cfg32)
        params = model32.init(torch.Generator(device=device).manual_seed(
            args.seed))
        with torch.no_grad():
            out["f32_loss"] = float(model32.loss(params, train_batch(
                cfg32, B, S, args.seed, 0, device))[0])
    return out


def shard_f32_check(seed: int, device, key: str, part) -> dict:
    """Case ``key`` in float32 at its check's depth: rank 0 takes the
    unsharded loss and gradients (routing recorded), every rank the
    sharded ones on its block with that routing replayed (under
    ``moe_impl="ep"`` the unsharded ep step over the case's mesh, each
    participant replaying its shard's calls); each gathered leaf, with and
    without the sum over ``"model"`` of the partial ones, and (where the
    case names them, ``f32_control``: a name or several) under each
    control, is held to rank 0's.  Errors are rank 0's (None
    elsewhere)."""
    from repro_torch.parallel.sharding import (
        gather_tree,
        param_shardings,
        shard_tree,
    )

    case = SHARD_CASES[key]
    cfg = case_config(case, case["f32_layers"], dtype="float32")
    model = Model(cfg)
    full = model.init(torch.Generator(device=device).manual_seed(seed))
    sh = param_shardings(full, cfg, part.mesh)
    local = shard_tree(full, sh, part.coord)
    B, S = case["batch"]
    batch = train_batch(cfg, B, S, seed, 0, device)
    lead = dist.get_rank() == 0
    ref_routing = None
    ref_loss = ref_grads = None
    marks = [time.time()]
    if lead:
        with unsharded_mesh(case) as shards:
            ref_routing = TrainRouting(cfg, shards)
            with ref_routing.record():
                ref_loss, ref_grads = loss_and_grads(cfg, full, batch)
    del full
    recorded = [[t.cpu() for t in ref_routing.recorded] if lead else None]
    dist.broadcast_object_list(recorded, src=0)
    routing = TrainRouting(cfg)
    routing.recorded = [t.to(device)
                        for t in own_calls(recorded[0], case, part)]

    def replayed():
        return (routing.replay() if routing.recorded
                else contextlib.nullcontext(None))
    marks.append(time.time())
    zero_counts()
    with replayed() as flips:
        metrics, grads = train_step_mod.sharded_grads(model, local, batch,
                                                      part)
    launches = kernel_counts()
    controls = case.get("f32_control") or ()
    controls = (controls,) if isinstance(controls, str) else controls
    partial = train_step_mod.partial_grad_leaves(sh)
    named = {}
    for name in controls:
        with replayed(), shard_control(name):
            _, g = train_step_mod.sharded_grads(model, local, batch, part)
        named[name] = tree.leaves(train_step_mod.psum_partial(g, partial,
                                                              part))
    marks.append(time.time())
    whole = train_step_mod.psum_partial(grads, partial, part)
    like = model.abstract_params()
    leaf_rel, control_rel = [], []
    named_rel: dict = {name: [] for name in named}

    def rel(t, i):
        w = ref_grads[i].float()
        return float((t.float() - w).norm() / w.norm().clamp_min(1e-30))
    for i, (g, c, s, m) in enumerate(zip(
            tree.leaves(whole), tree.leaves(grads), tree.leaves(sh),
            tree.leaves(like), strict=True)):
        gw = gather_tree(g, s, part.shards, m)
        cw = gather_tree(c, s, part.shards, m) if partial[i] else gw
        nws = {name: gather_tree(leaves[i], s, part.shards, m)
               for name, leaves in named.items()}
        if lead:
            leaf_rel.append(rel(gw, i))
            control_rel.append(rel(cw, i))
            for name, nw in nws.items():
                named_rel[name].append(rel(nw, i))
        del gw, cw, nws
    marks.append(time.time())
    loss = float(metrics["loss"])
    return {"layers": cfg.n_layers, "launches": launches,
            "seconds": dict(zip(("unsharded", "sharded", "gathers"),
                                np.diff(marks).tolist())),
            "launches_expected": expected_train_launches(cfg),
            "loss": loss, "unsharded_loss": ref_loss,
            "loss_rel": (abs(loss - ref_loss) / abs(ref_loss) if lead
                         else None),
            "max_leaf_rel_rms": max(leaf_rel) if lead else None,
            "control_max_leaf_rel_rms": max(control_rel) if lead else None,
            "partial_leaves": sum(partial),
            "control_past_limit_in_every_partial_leaf": (
                all(e > TRAIN_F32_GRAD_REL_RMS
                    for e, p in zip(control_rel, partial) if p)
                if lead else None),
            "named_control": list(controls) or None,
            "named_control_max_leaf_rel_rms": (
                {name: max(v) for name, v in named_rel.items()}
                if lead and named_rel else None),
            "routing_flips": flips,
            "recompute_routing_equal": (ref_routing.recompute_equal if lead
                                        else None)}


def shard_steps(seed: int, device, key: str, part, routing_rec: list
                ) -> dict:
    """The sharded bf16 steps of case ``key`` (``SHARD_STEPS``, or its
    ``steps``) on this participant's block of the seeded state (ZeRO-1
    where the case says),
    the batches of ``launch.train``'s pipeline, step 1 replaying the
    unsharded step's routing: per step its time (CUDA events), launches,
    collectives, peak memory, loss, gradient norm and every leaf's
    fingerprint.  Under ZeRO-1, step 1 also runs without it from the same
    state: its moments' slices and parameters against ZeRO-1's."""
    from repro_torch.parallel.sharding import shard_slices, shard_tree

    case = SHARD_CASES[key]
    cfg = case_config(case, case["layers"])
    model = Model(cfg)
    abstract = train_step_mod.abstract_state(model, SHARD_OPT)
    sh = train_step_mod.state_shardings(abstract, cfg, part.mesh,
                                        zero_opt=case["zero_opt"])
    full = model.init(torch.Generator(device=device).manual_seed(seed))
    params = shard_tree(full, sh["params"], part.coord)
    del full
    state = {"params": params,
             "opt": zero_moments(sh["opt"], abstract["opt"], device)}
    step = train_step_mod.make_train_step(model, SHARD_OPT, shards=part,
                                          shardings=sh)
    routing = TrainRouting(cfg)
    routing.recorded = [t.to(device)
                        for t in own_calls(routing_rec, case, part)]
    B, S = case["batch"]
    on_card = device.type == "cuda"
    runs, zero = [], None
    for i in range(case.get("steps", SHARD_STEPS)):
        batch = train_batch(cfg, B, S, seed, i, device)
        if i == 0 and case["zero_opt"]:
            plain_sh = train_step_mod.state_shardings(abstract, cfg,
                                                      part.mesh)
            plain, _ = train_step_mod.make_train_step(
                model, SHARD_OPT, shards=part, shardings=plain_sh)(
                {"params": params, "opt": zero_moments(
                    plain_sh["opt"], abstract["opt"], device)}, batch)
        observed = []
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        replay = routing.replay() if i == 0 and routing.recorded else \
            contextlib.nullcontext(None)
        with replay as flips, collectives.observe(
                lambda kind, n: observed.append((kind, n))):
            a = Mark(device)
            state, metrics = step(state, batch)
            ms = a.ms_to_now(device)
        launches = kernel_counts()
        runs.append({
            "step_ms": ms, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "launches": launches, "collectives": collective_counts(observed),
            "record": observed if i == 0 else None,
            "routing_flips": flips,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if on_card else None),
            "fingerprints": [fingerprint(t) for t in tree.leaves(state)]})
        if i == 0 and case["zero_opt"]:
            def within(zs, ps, t):
                """The ZeRO-1 block ``zs`` inside ``t``, the block ``ps``."""
                return t[tuple(slice(z.start - p.start, z.stop - p.start)
                               for z, p in zip(zs, ps))]
            equal = []
            for part_name in ("m", "v"):
                for zt, pt, zsh, psh, leaf in zip(
                        tree.leaves(getattr(state["opt"], part_name)),
                        tree.leaves(getattr(plain["opt"], part_name)),
                        tree.leaves(getattr(sh["opt"], part_name)),
                        tree.leaves(getattr(plain_sh["opt"], part_name)),
                        tree.leaves(getattr(abstract["opt"], part_name)),
                        strict=True):
                    equal.append(torch.equal(zt, within(
                        shard_slices(leaf.shape, zsh, part.coord),
                        shard_slices(leaf.shape, psh, part.coord), pt)))
            rel = [float((a_.float() - b_.float()).norm()
                         / b_.float().norm().clamp_min(1e-30))
                   for a_, b_ in zip(tree.leaves(state["params"]),
                                     tree.leaves(plain["params"]))]
            zero = {"moment_slices_equal": all(equal),
                    "moment_leaves": len(equal),
                    "zero_sharded_leaves": sum(
                        s.spec != p.spec for s, p in zip(
                            tree.leaves(sh["opt"].m),
                            tree.leaves(plain_sh["opt"].m))),
                    "params_max_rel_rms": max(rel),
                    "params_bitwise_equal": all(
                        torch.equal(a_, b_) for a_, b_ in zip(
                            tree.leaves(state["params"]),
                            tree.leaves(plain["params"])))}
            del plain
    specs = [s.spec for s in tree.leaves(sh)]
    del state
    return {"layers": cfg.n_layers, "launches_expected":
            expected_train_launches(cfg), "runs": runs, "zero": zero,
            "specs": specs}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same dtype, shape and bytes, compared on the device."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def straddling(like, shardings, mesh) -> list[str]:
    """The leaves whose 256-element int8 blocks (``parallel/compress.py``,
    over each whole flattened leaf) hold elements of more than one
    participant of ``mesh``: there the scales need the max over
    ``"model"``."""
    import itertools

    from repro_torch.parallel.compress import BLOCK, block_runs
    from repro_torch.parallel.sharding import shard_slices

    coords = [dict(zip(mesh.axis_names, c)) for c in itertools.product(
        *(range(mesh.shape[a]) for a in mesh.axis_names))]
    out = []
    for (path, leaf), sh in zip(tree.leaves_with_path(like),
                                tree.leaves(shardings)):
        shape, n = tuple(leaf.shape), leaf.numel()
        for c in coords:
            offsets, length = block_runs(shape, shard_slices(shape, sh, c))
            if 0 < length < n and any(
                    o % BLOCK or ((o + length) % BLOCK and o + length != n)
                    for o in offsets):
                out.append("/".join(str(k) for k in path))
                break
    return out


def compress_check(part, call, names: list) -> dict:
    """One step's sharded compression (``call``: the arguments and result
    of its ``ef_compress_sharded``) against ``ef_compress`` of each leaf's
    gradient and residual gathered for the check, cut to this
    participant's block, byte for byte; and the same with the scales
    taken per shard (no max over ``"model"``, the control): the leaves
    where that breaks the equality."""
    import copy

    from repro_torch.parallel.compress import ef_compress, ef_compress_sharded
    from repro_torch.parallel.sharding import gather_tree, shard_slices

    (grads, residual, p_sh, like, _part), (deq, res) = call
    per_shard = copy.copy(part)
    per_shard.max_model = lambda x: x
    c_deq, _ = ef_compress_sharded(grads, residual, p_sh, like, per_shard)
    equal, broken = [], []
    for name, g, r, d, rr, cd, sh, w in zip(
            names, tree.leaves(grads), tree.leaves(residual),
            tree.leaves(deq), tree.leaves(res), tree.leaves(c_deq),
            tree.leaves(p_sh), tree.leaves(like), strict=True):
        (wd,), (wr,) = ef_compress([gather_tree(g, sh, part.shards, w)],
                                   [gather_tree(r, sh, part.shards, w)])
        cut = shard_slices(tuple(w.shape), sh, part.coord)
        equal.append(bits_equal(d, wd[cut]) and bits_equal(rr, wr[cut]))
        if not bits_equal(cd, wd[cut]):
            broken.append(name)
        del wd, wr
    return {"leaves": len(equal), "equal": all(equal),
            "unequal": [n for n, e in zip(names, equal) if not e],
            "control_broken": broken}


def compress_f32(seed: int, device, part) -> dict:
    """The compressed case in float32 at ``f32_layers``: rank 0 runs
    ``SHARD_STEPS`` unsharded compressed steps (routing recorded), every
    rank the sharded ones on its block of the same state and batches, the
    routing replayed on its rows; rank 0 holds each step's loss and, after
    the last, every gathered leaf of the parameters, moments and residual
    to its own by the three-step rule.  Readings are rank 0's (None
    elsewhere)."""
    from repro_torch.parallel.compress import ef_init
    from repro_torch.parallel.sharding import gather_tree, shard_tree

    case = SHARD_COMPRESS
    cfg = case_config(case, case["f32_layers"], dtype="float32")
    model = Model(cfg)
    B, S = case["batch"]
    batches = [train_batch(cfg, B, S, seed, i, device)
               for i in range(SHARD_STEPS)]
    full = model.init(torch.Generator(device=device).manual_seed(seed))
    abstract = train_step_mod.abstract_state(model, SHARD_OPT, compress=True)
    sh = train_step_mod.state_shardings(abstract, cfg, part.mesh)
    local = {"params": shard_tree(full, sh["params"], part.coord),
             "opt": zero_moments(sh["opt"], abstract["opt"], device),
             "ef": zero_blocks(sh["ef"], abstract["ef"], device)}
    lead = dist.get_rank() == 0
    routing = Routing()
    ref_losses, ref_state = None, None
    if lead:
        step = train_step_mod.make_train_step(model, SHARD_OPT,
                                              compress=True)
        state = {"params": full, "opt": train_step_mod.adamw_init(full),
                 "ef": ef_init(full)}
        ref_losses = []
        with routing.record():
            for b in batches:
                state, metrics = step(state, b)
                ref_losses.append(float(metrics["loss"]))
        ref_state = tree.map(lambda t: t.cpu(), state)
        del state
    del full
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shared = [[r.cpu() for r in routing.recorded] if lead else None]
    dist.broadcast_object_list(shared, src=0)
    rows = RowRouting([r.to(device) for r in shared[0]], part, cfg, B)
    step = train_step_mod.make_train_step(model, SHARD_OPT, compress=True,
                                          shards=part, shardings=sh)
    losses = []
    zero_counts()
    with rows.replay() as flips:
        for b in batches:
            local, metrics = step(local, b)
            losses.append(float(metrics["loss"]))
    launches = kernel_counts()
    groups = {"params": ("params", 1.0), "m": ("m", 1.0), "v": ("v", 1.0),
              "ef": ("ef", 127.0)}

    def part_of(state, name):
        return state["opt"]._asdict()[name] if name in ("m", "v") else \
            state[name]
    outliers = {}
    for name, (key, factor) in groups.items():
        off = total = 0
        wants = tree.leaves(part_of(ref_state, key)) if lead else None
        for i, (loc, s, w_) in enumerate(zip(
                tree.leaves(part_of(local, key)),
                tree.leaves(part_of(sh, key)),
                tree.leaves(part_of(abstract, key)), strict=True)):
            got = gather_tree(loc, s, part.shards, w_)
            if lead:
                want = wants[i].to(device)
                scale = factor * want.abs().max().clamp_min(1e-30)
                off += int(((got - want).abs() > COMPRESS_STEP_TOL * scale)
                           .sum())
                total += want.numel()
            del got
        outliers[name] = {"outside": off, "elements": total}
    out = {"layers": cfg.n_layers, "losses": losses, "launches": launches,
           "launches_expected": {k: v * SHARD_STEPS for k, v in
                                 expected_train_launches(cfg).items()},
           "routing_flips": flips}
    if lead:
        out.update(unsharded_losses=ref_losses,
                   loss_rel=[abs(a - b) / abs(b)
                             for a, b in zip(losses, ref_losses)],
                   outliers=outliers)
    return out


def compress_steps(seed: int, device, part) -> dict:
    """``SHARD_STEPS`` sharded bf16 compressed steps of the compressed
    case, from seeded parameters, zero moments and residual: per step its
    launches, loss, :func:`compress_check` of the step's own compression
    and its time (CUDA events) without the check's.  The check runs inside
    the step, as soon as its compression returns, so that no step's
    gradient, compressed gradient or residual outlives it: four ranks of
    the case fill most of the card."""
    from unittest import mock

    from repro_torch.parallel import compress as compress_mod
    from repro_torch.parallel.sharding import shard_tree

    case = SHARD_COMPRESS
    cfg = case_config(case, case["layers"])
    model = Model(cfg)
    abstract = train_step_mod.abstract_state(model, SHARD_OPT, compress=True)
    sh = train_step_mod.state_shardings(abstract, cfg, part.mesh)
    full = model.init(torch.Generator(device=device).manual_seed(seed))
    state = {"params": shard_tree(full, sh["params"], part.coord),
             "opt": zero_moments(sh["opt"], abstract["opt"], device),
             "ef": zero_blocks(sh["ef"], abstract["ef"], device)}
    del full
    like = model.abstract_params()
    names = ["/".join(str(k) for k in path)
             for path, _ in tree.leaves_with_path(like)]
    step = train_step_mod.make_train_step(model, SHARD_OPT, compress=True,
                                          shards=part, shardings=sh)
    checks = []

    def checked(*a):
        out = compress_mod.ef_compress_sharded(*a)
        mark = Mark(device)
        checks.append(compress_check(part, (a, out), names))
        checks[-1]["ms"] = mark.ms_to_now(device)
        return out
    B, S = case["batch"]
    on_card = device.type == "cuda"
    runs = []
    for i in range(SHARD_STEPS):
        batch = train_batch(cfg, B, S, seed, i, device)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with mock.patch.object(train_step_mod, "ef_compress_sharded",
                               checked):
            a = Mark(device)
            state, metrics = step(state, batch)
            ms = a.ms_to_now(device)
        launches = kernel_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
        check_ = checks.pop()
        runs.append({"step_ms": ms - check_["ms"],
                     "loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "launches": launches, "peak_memory_gb": peak,
                     "compress": check_})
    del state
    return {"layers": cfg.n_layers, "runs": runs,
            "launches_expected": expected_train_launches(cfg),
            "straddling": straddling(like, sh["params"], part.mesh)}


def compress_rank(seed: int, device, part) -> dict:
    t0 = time.time()
    f32 = compress_f32(seed, device, part)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.time()
    steps = compress_steps(seed, device, part)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"coord": part.coord, "f32": f32, **steps, "f32_s": t1 - t0,
            "steps_s": time.time() - t1}


def phase_compress(ranks: list, card: str) -> dict:
    """The compressed case's checks over every rank's readings."""
    case = SHARD_COMPRESS
    per = [r["compress"] for r in ranks]
    lead = per[0]
    f32 = lead["f32"]
    straddle = set(lead["straddling"])
    share = {k: v["outside"] / v["elements"] for k, v in
             f32["outliers"].items()}
    checks = {
        "launches": all(r_["launches"] == p["launches_expected"]
                        for p in per for r_ in p["runs"]),
        "f32_launches": all(p["f32"]["launches"]
                            == p["f32"]["launches_expected"] for p in per),
        "compressed_gradient_bytes_equal": all(
            r_["compress"]["equal"] for p in per for r_ in p["runs"]),
        "control_breaks_a_straddling_leaf": bool(straddle) and all(
            r_["compress"]["control_broken"]
            and set(r_["compress"]["control_broken"]) <= straddle
            for p in per for r_ in p["runs"]),
        "f32_step1_loss": f32["loss_rel"][0] <= TRAIN_F32_LOSS_RTOL,
        "f32_losses": max(f32["loss_rel"]) <= COMPRESS_STEP_TOL,
        "f32_state_three_step_rule": all(
            v <= COMPRESS_OUTLIER_SHARE for v in share.values()),
        "f32_routing": flip_share(f32["routing_flips"], "float32")
        <= ROUTING_FLIP_SHARE["float32"],
        "metrics_equal_on_every_rank": all(
            len({(p["runs"][n]["loss"], p["runs"][n]["grad_norm"])
                 for p in per}) == 1 for n in range(SHARD_STEPS)),
        "losses_finite": all(np.isfinite(r_["loss"]) for r_ in
                             lead["runs"]),
    }
    steady = [r_["step_ms"] for p in per for r_ in p["runs"][1:]]
    out = {"arch": get_config(case["arch"]).name,
           "mesh": dict(zip(COMPRESS_AXES, case["mesh"])),
           "layers": lead["layers"], "batch": case["batch"][0],
           "seq": case["batch"][1], "steps": SHARD_STEPS, "gpu": card,
           "step_ms_per_rank": [[r_["step_ms"] for r_ in p["runs"]]
                                for p in per],
           "step_ms_median_steps_2_on": statistics.median(steady),
           "peak_memory_gb_per_rank": [max(r_["peak_memory_gb"] or 0
                                           for r_ in p["runs"])
                                       for p in per],
           "losses": [r_["loss"] for r_ in lead["runs"]],
           "launches_per_rank_step": lead["runs"][0]["launches"],
           "leaves": lead["runs"][0]["compress"]["leaves"],
           "straddling_leaves": sorted(straddle),
           "control_broken_rank0": [r_["compress"]["control_broken"]
                                    for r_ in lead["runs"]],
           "f32": {"layers": f32["layers"], "loss_rel": f32["loss_rel"],
                   "losses": f32["losses"],
                   "outside_share": share,
                   "routing_flips": f32["routing_flips"]},
           "f32_s_rank0": lead["f32_s"], "steps_s_rank0": lead["steps_s"],
           "checks": checks}
    return out


def meta_train_record(key: str, coord: dict) -> list:
    """``shard_steps``' step of case ``key`` run on ``meta`` over
    ``MetaShards`` at ``coord``: each ``(kind, operand bytes)``."""
    from repro_torch.parallel.collectives import MetaShards
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.parallel.tensor import Participant

    case = SHARD_CASES[key]
    cfg = case_config(case, case["layers"])
    model = Model(cfg)
    mesh = make_mesh(case["mesh"], ("data", "model"))
    abstract = train_step_mod.abstract_state(model, SHARD_OPT)
    sh = train_step_mod.state_shardings(abstract, cfg, mesh,
                                        zero_opt=case["zero_opt"])
    part = Participant(MetaShards(mesh, coord))
    step = train_step_mod.make_train_step(model, SHARD_OPT, shards=part,
                                          shardings=sh)
    B, S = case["batch"]
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    if cfg.enc_layers:                   # train_batch's frames: S // 4
        batch["enc_embeds"] = torch.empty((B, S // 4, cfg.d_model),
                                          dtype=torch.float32, device="meta")
    record: list = []
    with collectives.observe(lambda kind, n: record.append((kind, n))):
        step(shard_tree(abstract, sh, coord), batch)
    return record


def meta_serve_records(key: str, coord: dict) -> tuple[list, list]:
    """``shard_serve_bf16``'s prefill and first decode step of case
    ``key`` run on ``meta`` over ``MetaShards`` at ``coord``: each call's
    ``(kind, operand bytes)`` (the cache, an input of the calls, built
    outside the count, as on the card); a prefill-only case's decode
    record is None."""
    from repro_torch.parallel.collectives import MetaShards
    from repro_torch.parallel.sharding import param_shardings, shard_tree
    from repro_torch.parallel.tensor import Participant

    case = SHARD_SERVE_CASES[key]
    cfg = case_config(case, case["layers"])
    model = Model(cfg)
    mesh = make_mesh(case["mesh"], ("data", "model"))
    whole = cast_params(model.abstract_params(), cfg, torch.device("meta"))
    params = shard_tree(whole, param_shardings(whole, cfg, mesh), coord)
    part = Participant(MetaShards(mesh, coord))
    batch = {"tokens": torch.empty((case["batch"], case["prompt"]),
                                   dtype=torch.int32, device="meta")}
    if cfg.enc_layers:
        batch["enc_embeds"] = torch.empty(
            (case["batch"], case["frames"], cfg.d_model),
            dtype=torch.float32, device="meta")
    cache = model.init_cache(params, batch, case.get("max_len",
                                                     SHARD_SERVE_LEN),
                             shards=part)
    prefill, decode = [], []
    with collectives.observe(lambda kind, n: prefill.append((kind, n))):
        _, cache = model.prefill(params, batch, cache, shards=part)
    if case.get("prefill_only"):                 # its decode step raises
        return prefill, None
    with collectives.observe(lambda kind, n: decode.append((kind, n))):
        model.decode(params, batch["tokens"][:, :1], cache, shards=part)
    return prefill, decode


def phase_collective_count(ranks: list, pool: int = SHARD_RANKS,
                           name: str = "collective_count") -> dict:
    """Every rank's record of one train step of each ``SHARD_CASES``
    entry of the pool of ``pool`` ranks and of the prefill and first
    decode step of each of its ``SHARD_SERVE_CASES`` entries, against the
    same call run on ``meta`` over ``MetaShards`` at the rank's coordinate
    (the dry run's count; ``meta_records``, run in each rank's process so
    that the ranks take them in parallel): equal call for call, kind,
    order and bytes."""
    out, failed = {}, []
    for key in pool_cases(SHARD_CASES, pool):
        out[f"train/{key}"] = [(r["cases"][key]["runs"][0]["record"],
                                r["meta"][f"train/{key}"]) for r in ranks]
    for key, case in pool_cases(SHARD_SERVE_CASES, pool).items():
        calls = (("prefill", 0),) if case.get("prefill_only") else (
            ("prefill", 0), ("decode", 1))
        for r in ranks:
            records = r["serve"][key]["bf16"]["records"]
            for call, i in calls:
                out.setdefault(f"{call}/{key}", []).append(
                    (records[i]["record"], r["meta"][f"{call}/{key}"]))
    summary = {}
    for call, calls in out.items():
        equal = [card == meta for card, meta in calls]
        card0 = calls[0][0]
        summary[call] = {"calls": len(card0),
                         "bytes": sum(n for _, n in card0),
                         "by_kind": collective_counts(card0),
                         "equal_on_ranks": equal}
        if not all(equal):
            failed.append(call)
    emit({"phase": name, "ok": not failed,
          "records_rank0": {call: calls[0][0]
                            for call, calls in out.items()}})
    check(not failed, f"{name}: the meta count differs from the "
          f"card's record in {failed}")
    return summary


def meta_records(out: dict, pool: int) -> dict:
    """The meta counts of this rank's calls (``out``: its readings, whose
    cases carry its coordinate): ``meta_train_record`` of each train case
    of the pool and ``meta_serve_records`` of each serving case, keyed as
    ``phase_collective_count`` reads them."""
    meta = {}
    for key in pool_cases(SHARD_CASES, pool):
        meta[f"train/{key}"] = meta_train_record(key,
                                                 out["cases"][key]["coord"])
    for key in pool_cases(SHARD_SERVE_CASES, pool):
        prefill, decode = meta_serve_records(key, out["serve"][key]["coord"])
        meta[f"prefill/{key}"], meta[f"decode/{key}"] = prefill, decode
    return meta


def shard_rank(rank: int, store: str, seed: int, t_spawn: float,
               device_type: str, routings: dict,
               pool: int = SHARD_RANKS) -> dict:
    """One participant of ``shard_path`` (a process of its own): joins the
    group of ``pool`` ranks, then for each of the pool's cases its float32
    check and its bf16 steps, the compressed case (in the 4-rank pool) and
    the pool's serving cases."""
    from repro_torch.parallel.tensor import Participant

    started_s = time.time() - t_spawn
    device = torch.device(device_type)
    if pool == SHARD_RANKS:
        dm = init_ranks(make_mesh((2, 2), ("data", "model")), rank, store)
        meshes = {(2, 2): dm, **{
            shape: make_mesh(shape, ("data", "model")).device_mesh()
            for shape in ((1, 4), (4, 1))}}
    else:                   # a pool of its own: its cases' one mesh
        (mesh,) = {c["mesh"] for table in (SHARD_CASES, SHARD_SERVE_CASES)
                   for c in pool_cases(table, pool).values()}
        meshes = {mesh: init_ranks(make_mesh(mesh, ("data", "model")),
                                   rank, store)}
    # what every process pays once before its first step: the device's
    # context and its first product, and the import of torch._dynamo
    # that torch.utils.checkpoint makes on its first call
    importlib.import_module("torch._dynamo")
    torch.ones((8, 8), device=device) @ torch.ones((8, 8), device=device)
    ready_s = time.time() - t_spawn
    out = {"rank": rank, "started_s": started_s, "ready_s": ready_s,
           "cases": {}}
    for key, case in pool_cases(SHARD_CASES, pool).items():
        part = Participant(meshes[case["mesh"]])
        t0 = time.time()
        f32 = shard_f32_check(seed, device, key, part)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.time()
        steps = shard_steps(seed, device, key, part, routings[key])
        out["cases"][key] = {"coord": part.coord, "f32": f32, **steps,
                             "f32_check_s": t1 - t0,
                             "steps_s": time.time() - t1}
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if pool == SHARD_RANKS:
        three_axis = make_mesh(SHARD_COMPRESS["mesh"],
                               COMPRESS_AXES).device_mesh()
        t0 = time.time()
        out["compress"] = compress_rank(seed, device, Participant(three_axis))
        out["compress_seconds"] = time.time() - t0
    t0 = time.time()
    out["serve"] = {key: shard_serve_rank(seed, device, Participant(
        meshes[case["mesh"]]), key) for key, case in
        pool_cases(SHARD_SERVE_CASES, pool).items()}
    out["serve_seconds"] = time.time() - t0
    t0 = time.time()
    out["meta"] = meta_records(out, pool)
    out["meta_seconds"] = time.time() - t0
    out["seconds"] = time.time() - t_spawn
    return out


def shard_pool(args, device, pool: int) -> tuple[list, dict, dict]:
    """The unsharded bf16 references of the pool's train cases in this
    process, then ``pool`` spawned participants (``shard_rank``) on
    ``cuda:0``: their readings, the references, and the times."""
    refs = {}
    t_ref = time.time()
    for key in pool_cases(SHARD_CASES, pool):
        refs[key] = shard_reference(args, device, key)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(shard_rank, pool, os.path.join(tmp, "store"),
                          args.seed, t0, device.type,
                          {k: r["routing"] for k, r in refs.items()}, pool,
                          timeout_s=SHARD_TIMEOUT_S)
    return ranks, refs, {"references_s": t0 - t_ref,
                         "seconds": time.time() - t0}


def train_case_checks(key: str, ranks: list, ref: dict,
                      card: str) -> dict:
    """Case ``key``'s readings and checks over every rank's run (module
    doc, phase 13)."""
    case = SHARD_CASES[key]
    arch = case["arch"]
    per = [r["cases"][key] for r in ranks]
    lead = per[0]
    f32 = lead["f32"]
    loss_lim, gnorm_lim = SHARD_BF16_LIMITS[arch]
    step1 = lead["runs"][0]
    steps = case.get("steps", SHARD_STEPS)
    against = ref.get("f32_loss", ref["loss"])
    bf16 = {"loss": step1["loss"], "unsharded_loss": ref["loss"],
            "unsharded_f32_loss": ref.get("f32_loss"),
            "loss_against": case.get("bf16_loss_against", "bfloat16"),
            "loss_rel": abs(step1["loss"] - against) / abs(against),
            "loss_rel_to_unsharded_bf16": abs(step1["loss"] - ref["loss"])
            / abs(ref["loss"]),
            "unsharded_bf16_loss_rel": abs(ref["loss"] - against)
            / abs(against),
            "grad_norm": step1["grad_norm"],
            "unsharded_grad_norm": ref["grad_norm"],
            "grad_norm_rel": abs(step1["grad_norm"] - ref["grad_norm"])
            / ref["grad_norm"],
            "limits": {"loss_rtol": loss_lim, "gnorm_rtol": gnorm_lim}}
    # every participant holding a block holds its bits, after each step
    held: dict = {}
    for p in per:
        for n, run in enumerate(p["runs"]):
            for i, (s, fp) in enumerate(zip(p["specs"],
                                            run["fingerprints"])):
                axes = sorted({a for e in s if e is not None
                               for a in (e if isinstance(e, tuple)
                                         else (e,))})
                held.setdefault((n, i, tuple(p["coord"][a] for a in axes)),
                                set()).add(fp)
    partial_ok = (f32["control_max_leaf_rel_rms"] > TRAIN_F32_GRAD_REL_RMS
                  and f32["control_past_limit_in_every_partial_leaf"])
    checks = {
        "launches": all(r_["launches"] == p["launches_expected"]
                        for p in per for r_ in p["runs"]),
        "f32_launches": all(p["f32"]["launches"]
                            == p["f32"]["launches_expected"] for p in per),
        "f32_loss": f32["loss_rel"] <= TRAIN_F32_LOSS_RTOL,
        "f32_leaves": f32["max_leaf_rel_rms"] <= TRAIN_F32_GRAD_REL_RMS,
        # the sum over "model" of the partial leaves, where there are any
        # (seamless on (1, 4) has none), and the case's named control
        "f32_control_past_limit": (partial_ok or not f32["partial_leaves"])
        and (f32["named_control"] is None
             or all(e > TRAIN_F32_GRAD_REL_RMS for e in
                    f32["named_control_max_leaf_rel_rms"].values()))
        and bool(f32["partial_leaves"] or f32["named_control"]),
        "f32_losses_equal_on_every_rank": len(
            {p["f32"]["loss"] for p in per}) == 1,
        "bf16_loss": bf16["loss_rel"] <= loss_lim,
        "bf16_grad_norm": bf16["grad_norm_rel"] <= gnorm_lim,
        "metrics_equal_on_every_rank": all(
            len({(p["runs"][n]["loss"], p["runs"][n]["grad_norm"])
                 for p in per}) == 1 for n in range(steps)),
        "losses_finite": all(np.isfinite(r_["loss"]) for r_ in
                             lead["runs"]),
        "block_bits_equal_across_ranks": all(
            len(v) == 1 for v in held.values()),
        "routing": (flip_share(f32["routing_flips"], "float32")
                    <= ROUTING_FLIP_SHARE["float32"]
                    and routing_ok([step1["routing_flips"]])
                    and f32["recompute_routing_equal"]
                    and ref["recompute_routing_equal"])
        if ref["routing"] else True,
    }
    if case["zero_opt"]:
        checks["zero1_moment_slices_equal"] = all(
            p["zero"]["moment_slices_equal"]
            and p["zero"]["zero_sharded_leaves"] > 0 for p in per)
        checks["zero1_params"] = all(
            p["zero"]["params_max_rel_rms"] <= TRAIN_F32_GRAD_REL_RMS
            for p in per)
    steady = [r_["step_ms"] for p in per for r_ in p["runs"][1:]]
    cfg = get_config(arch)
    return {
        "arch": cfg.name, "moe_impl": case.get("moe_impl"), "mesh": {
            "data": case["mesh"][0], "model": case["mesh"][1]},
        "layers": lead["layers"], "batch": case["batch"][0],
        "seq": case["batch"][1], "zero_opt": case["zero_opt"],
        "steps": steps, "gpu": card,
        "f32_check_s": lead["f32_check_s"], "steps_s": lead["steps_s"],
        "step_ms_per_rank": [[r_["step_ms"] for r_ in p["runs"]]
                             for p in per],
        "step_ms_median_steps_2_on": statistics.median(steady),
        "step_note": f"{len(per)} processes share one card and gloo copies "
                     "through the host: not a multi-card time",
        "peak_memory_gb_per_rank": [max(r_["peak_memory_gb"] or 0
                                        for r_ in p["runs"]) for p in per],
        "losses": [r_["loss"] for r_ in lead["runs"]],
        "launches_per_rank_step": lead["runs"][0]["launches"],
        "launches_expected": lead["launches_expected"],
        "collectives_per_rank_step": lead["runs"][1]["collectives"]
        if steps > 1 else lead["runs"][0]["collectives"],
        "f32": f32, "bf16": bf16,
        "routing_flips_step1": step1["routing_flips"],
        "zero": lead["zero"], "checks": checks}


def phase_shard(args, card: str, device) -> dict:
    """The sharded train step on the card: the unsharded bf16 references
    in this process, then ``SHARD_RANKS`` spawned participants
    (``shard_rank``) on ``cuda:0``; every case's checks (module doc, phase
    13) on every rank."""
    ranks, refs, times = shard_pool(args, device, SHARD_RANKS)
    out, failed = {}, []
    for key in pool_cases(SHARD_CASES, SHARD_RANKS):
        out[key] = train_case_checks(key, ranks, refs[key], card)
        failed += [f"{key}: {k}" for k, ok in out[key]["checks"].items()
                   if not ok]
    compressed = phase_compress(ranks, card)
    failed += [f"compress: {k}" for k, ok in compressed["checks"].items()
               if not ok]
    run = {"ranks": SHARD_RANKS, "device": f"{device.type}:0 in every rank",
           "backend": "gloo, CUDA tensors staged through pinned host "
                      "buffers", **times,
           "started_s": [r["started_s"] for r in ranks],
           "spawn_to_ready_s": [r["ready_s"] for r in ranks],
           "rank_seconds": [r["seconds"] for r in ranks],
           "compress_seconds_rank0": ranks[0]["compress_seconds"],
           "cases": out, "compressed": compressed}
    if failed:
        emit({"phase": "shard_path", "ok": False, **run})
        # the serving cases ran in the same ranks: their checks and
        # readings too, before the run fails
        emit({"phase": "shard_serve_path", "ok": True,
              **phase_shard_serve(ranks, card)})
    check(not failed, "shard: " + ", ".join(failed))
    run["collective_count"] = phase_collective_count(ranks)
    return run, phase_shard_serve(ranks, card)


def uneven_summary(shard: dict, shard_serve: dict, uneven: dict) -> str:
    """One line: the encoder-decoder's and ``uneven_path``'s sharded
    readings (step, prefill and decode ms a rank, spawn seconds, peak GB)."""
    enc, enc_serve = shard["cases"][ENCDEC_ARCH], shard_serve["cases"][
        ENCDEC_ARCH]
    train, serve = uneven["train"], uneven["serve"]
    return (
        f"sharded: seamless-m4t-medium (1, 4) step "
        f"{enc['step_ms_median_steps_2_on']:.1f} ms, prefill "
        f"{max(enc_serve['prefill_ms_per_rank']):.1f} ms, decode "
        f"{max(enc_serve['decode_ms_per_step_median_per_rank']):.1f} ms a "
        f"rank; mamba2-130m ({train['mesh']['data']}, "
        f"{train['mesh']['model']}) in {uneven['ranks']} ranks (ready in "
        f"{uneven['spawn_to_ready_s_max']:.1f} s) step "
        f"{train['step_ms_median_steps_2_on']:.1f} ms, prefill "
        f"{max(serve['prefill_ms_per_rank']):.1f} ms, decode "
        f"{max(serve['decode_ms_per_step_median_per_rank']):.1f} ms, peak "
        f"{max(g or 0 for g in serve['peak_memory_gb_per_rank']):.2f} GB a "
        f"rank")


def phase_long(args, card: str, device) -> dict:
    """``long_path``: jamba-v0.1-52b's fully-seq case on (2, 1) in a pool of
    its own of ``LONG_RANKS`` rank processes on the one card (after the
    other pools have exited: each rank holds the whole bf16 model), held
    as ``shard_serve_path``'s cases are, and its collective count."""
    ranks, _, times = shard_pool(args, device, LONG_RANKS)
    serve = phase_shard_serve(ranks, card, LONG_RANKS)
    run = {"ranks": LONG_RANKS, "device": f"{device.type}:0 in every rank",
           **times, "spawn_to_ready_s": [r["ready_s"] for r in ranks],
           "rank_seconds": [r["seconds"] for r in ranks], **serve}
    run["collective_count"] = phase_collective_count(
        ranks, LONG_RANKS, "long_collective_count")
    return run


def phase_uneven(args, card: str, device) -> dict:
    """``uneven_path``: mamba2-130m at the production cut of its SSD heads,
    (1, 16), in ``UNEVEN_RANKS`` rank processes on the one card (after the
    4-rank pool has exited): its train case and its serving case held as
    ``shard_path``'s and ``shard_serve_path``'s are, and its collective
    count (module doc, phase 13)."""
    ranks, refs, times = shard_pool(args, device, UNEVEN_RANKS)
    out = train_case_checks(UNEVEN_KEY, ranks, refs[UNEVEN_KEY], card)
    serve = phase_shard_serve(ranks, card, UNEVEN_RANKS)
    run = {"ranks": UNEVEN_RANKS, "device": f"{device.type}:0 in every rank",
           "backend": "gloo, CUDA tensors staged through pinned host "
                      "buffers", **times,
           "spawn_to_ready_s": [r["ready_s"] for r in ranks],
           "spawn_to_ready_s_max": max(r["ready_s"] for r in ranks),
           "rank_seconds": [r["seconds"] for r in ranks],
           "train": out, "serve": serve["cases"][UNEVEN_KEY]}
    failed = [k for k, ok in out["checks"].items() if not ok]
    if failed:
        emit({"phase": "uneven_path", "ok": False, **run})
    check(not failed, "uneven: " + ", ".join(failed))
    run["collective_count"] = phase_collective_count(
        ranks, UNEVEN_RANKS, "uneven_collective_count")
    return run


# -- sharded prefill and decode ------------------------------------------------

def serve_control(name: str):
    """The patch of one ``shard_serve_path`` control, for the decode
    steps: the hd layout's partial scores not summed over ``"model"``
    (``unsummed_scores``), K3 read with an exclusive mask, ``cache_len -
    1`` (``exclusive_mask``: the off-by-one that passes most random tests),
    the fully-seq block's ``cache_len`` not offset by the block's start
    (``unoffset_cache_len``: the off-by-a-block that layout invites), the
    fully-seq blocks averaged with equal weights (``equal_block_weights``:
    ``l · exp(m − M)`` dropped), ``inner_norm`` per block in the recurrent
    step (``per_block_norm``), the encoder-decoder's fully-seq cross cache
    cut at encoder position 0 on every participant (``cross_cut_at_0``, a
    control of the cache: each block's offset dropped; a step's cross
    offset alone changes nothing, every encoder position being valid)."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.models import encdec, layers, ssd

    if name == "unsummed_scores":
        return mock.patch.object(layers, "sum_partial_scores",
                                 lambda scores, part: scores)
    if name == "exclusive_mask":
        mha_decode = ops.mha_decode
        return mock.patch.object(
            ops, "mha_decode",
            lambda q, k, v, cache_len: mha_decode(q, k, v, cache_len - 1))
    if name == "unoffset_cache_len":
        block_len = layers.block_cache_len
        return mock.patch.object(layers, "block_cache_len",
                                 lambda c, s_lo, n: block_len(c, 0, n))
    if name == "equal_block_weights":
        return mock.patch.object(layers, "combine_blocks",
                                 lambda o, m, l: o.mean(dim=0))
    if name == "cross_cut_at_0":
        block = encdec.cross_block

        def at_0(part, frames):
            lo, hi = block(part, frames)
            return 0, hi - lo
        return mock.patch.object(encdec, "cross_block", at_0)
    return mock.patch.object(
        ssd, "sharded_rmsnorm", lambda x, scale, n, part, eps=1e-5:
        layers.rmsnorm(x, scale, eps))


class RowRouting(Routing):
    """A recorded routing of the whole batch replayed on one participant's
    rows (its data block of every router call's slots, or every slot where
    the batch does not divide over the data axes); ``local_rows``: each
    call's slots routed to the participant's experts, the rows its K5
    launches take."""

    def __init__(self, recorded: list, part, cfg, batch: int) -> None:
        super().__init__()
        split = lm.rows_part(part, batch).rows_split
        self.recorded = [r.reshape(part.dp, -1, r.shape[-1])[part.di]
                         if split else r for r in recorded]
        e0, e1 = part.block(max(cfg.moe_experts, 1))
        self.local_rows = [int(((r >= e0) & (r < e1)).sum())
                           for r in self.recorded]


def expected_shard_serve_launches(cfg, layout, local_rows: list,
                                  calls: int) -> list[dict]:
    """Kernel launches of each call on one participant (the prefill, then
    the steps; an encoder-decoder's as ``expected_model_launches``): K2
    once per attention layer of the prefill, K3 once per
    attention layer of a step in the head-sharded and the fully-seq
    whole-head layouts (its statistics form there, on every participant's
    block, an empty one too) and never in the ``head_dim`` ones, K4 once
    per SSM layer of the prefill, K5 three times
    per MoE layer of every call whose local slots (``local_rows``, one
    entry a router call) are not none: the grouped-matmul wrapper does
    not launch on zero rows."""
    if cfg.enc_layers:
        model = expected_model_launches(cfg)
        prefill, step = model["prefill"], model["decode"]
    else:
        prefill, step = expected_launches(cfg)
    n_moe = prefill["moe_gmm"] // 3
    out = []
    for c in range(calls):
        want = dict(prefill if c == 0 else step)
        if layout in ("hd", "seq_hd"):
            want["decode_attention"] = 0
        if n_moe:
            want["moe_gmm"] = 3 * sum(
                n > 0 for n in local_rows[c * n_moe:(c + 1) * n_moe])
        out.append(want)
    return out


def serve_prompts(cfg, seed: int, device, batch: int = SERVE_BATCH,
                  length: int = PROMPT_LEN) -> torch.Tensor:
    """The first ``length`` tokens of the first ``batch`` of
    ``serve_path``'s prompts of ``cfg``, as one batch."""
    return torch.from_numpy(np.stack([r.prompt for r in serve_requests(
        cfg, seed)])[:batch, :length]).to(device)


def serve_frames(cfg, seed: int, device, case: dict) -> dict:
    """What a case's batch holds beside its prompts: an encoder-decoder's
    first ``batch`` frame embeddings of ``model_requests`` (``ENC_FRAMES``
    of them), nothing for a decoder-only model."""
    if not cfg.enc_layers:
        return {}
    frames = model_requests(cfg, seed, device)["enc_embeds"]
    return {"enc_embeds": frames[:case["batch"], :case["frames"]]}


def cache_state(cache: dict) -> dict:
    """The tensors of a cache that the checks compare: a decoder-only
    cache's slots, an encoder-decoder's self and cross caches."""
    if "slots" in cache:
        return cache["slots"]
    return {"self": cache["self"], "cross": cache["cross"]}


def copy_cache(cache: dict) -> dict:
    """A cache whose tensors are copies (the steps write in place)."""
    out = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in cache.items()}
    for k in ("slots", "self", "cross"):
        if k in cache:
            out[k] = tree.map(torch.clone, cache[k])
    return out


def greedy_unsharded(model, params, prompts, device, extra=None,
                     new: int = SHARD_SERVE_NEW,
                     max_len: int = SHARD_SERVE_LEN) -> dict:
    """The unsharded prefill (``extra``: the batch's frames) and ``new``
    greedy steps into a cache of ``max_len``: each call's logits, the
    tokens fed (the prompt, then each step's input), and the cache after
    the prefill (a copy) and after the last step."""
    batch = {"tokens": prompts, **(extra or {})}
    cache = model.init_cache(params, batch, max_len)
    logits, cache = model.prefill(params, batch, cache)
    out, tokens = [logits], [prompts]
    after_prefill = tree.map(torch.clone, cache_state(cache))
    for _ in range(new):
        tokens.append(out[-1][:, -1, :model.cfg.vocab].argmax(-1)[:, None]
                      .to(torch.int32))
        logits, cache = model.decode(params, tokens[-1], cache)
        out.append(logits)
    return {"logits": out, "tokens": tokens,
            "caches": [after_prefill, cache_state(cache)],
            "len": int(cache["len"])}


def sharded_call(fn, device, *args, part) -> tuple:
    """One sharded serving call with the launch counters zeroed just
    before it: ``(logits, cache, {"ms": CUDA events, "launches",
    "collectives"})``."""
    observed = []
    zero_counts()
    with collectives.observe(lambda kind, n: observed.append((kind, n))):
        mark = Mark(device)
        logits, cache = fn(*args, shards=part)
        ms = mark.ms_to_now(device)
    return logits, cache, {"ms": ms, "launches": kernel_counts(),
                           "collectives": collective_counts(observed),
                           "record": observed}


def sharded_steps(model, params, part, cache, tokens, device) -> tuple:
    """Teacher-forced decode steps from ``cache``: logits and records."""
    logits, records = [], []
    for tok in tokens:
        lg, cache, rec = sharded_call(model.decode, device, params, tok,
                                      cache, part=part)
        logits.append(lg)
        records.append(rec)
    return logits, records, cache


def whole_rows(logits: list, part, batch: int) -> list:
    """Each call's logits of every row (gathered over the data axes where
    the rows are split over them)."""
    if not lm.rows_part(part, batch).rows_split:
        return list(logits)
    return [part.all_gather_dp(lg).reshape(-1, *lg.shape[1:])
            for lg in logits]


def rel_rms(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


#: The serving controls of the cache rather than of a decode step: the
#: control run builds and prefills its cache under them, then steps once,
#: and its worst call is read.
CACHE_CONTROLS = ("cross_from_participant_0", "unoffset", "cross_cut_at_0")


def cross_from_participant_0(local, cfg, full, part):
    """The encoder-decoder's serving control: this participant's block of
    the parameters with every decoder layer's cross ``wk`` / ``wv``
    replaced by participant 0's block of them (its cross K/V projected
    from participant 0's kv heads)."""
    from repro_torch.parallel.sharding import param_shardings, shard_tree

    first = shard_tree(full, param_shardings(full, cfg, part.mesh),
                       {a: 0 for a in part.mesh.axis_names})
    cross = dict(local["dec_blocks"]["cross_attn"])
    for name in ("wk", "wv"):
        cross[name] = first["dec_blocks"]["cross_attn"][name]
    return {**local, "dec_blocks": {**local["dec_blocks"],
                                    "cross_attn": cross}}


def shard_serve_f32(seed: int, device, key: str, part) -> dict:
    """Case ``key``'s float32 check: rank 0 runs the unsharded model greedily
    (routing recorded) on the seeded parameters, every rank the sharded
    cells on its block, fed rank 0's tokens with its routing replayed;
    rank 0 holds every call's gathered logits, the greedy tokens and the
    gathered cache after the prefill and after the last step to the
    unsharded run's, and the first step again under each of the case's
    controls (``controls``, else its ``control`` or its layout's): from
    the prefill's cache (a control of the decode step), or, for a control
    of the cache (``CACHE_CONTROLS``), after a cache built and prefilled
    under it too (the worst of the two calls and of the gathered cache
    after the prefill is read: the limit holds both).  Readings are rank
    0's (None elsewhere); ``control_rel_rms`` is the least control's."""
    from repro_torch.convert import gather_cache
    from repro_torch.parallel.sharding import param_shardings, shard_tree

    case = SHARD_SERVE_CASES[key]
    B = case["batch"]
    new, max_len = (case.get("new", SHARD_SERVE_NEW),
                    case.get("max_len", SHARD_SERVE_LEN))
    cfg = case_config(case, case["f32_layers"], dtype="float32")
    model = Model(cfg)
    full = model.init(torch.Generator(device=device).manual_seed(seed))
    extra = serve_frames(cfg, seed, device, case)
    lead = dist.get_rank() == 0
    routing = Routing()
    ref = None
    if lead:
        with routing.record():
            ref = greedy_unsharded(model, full, serve_prompts(
                cfg, seed, device, B, case["prompt"]), device, extra, new,
                max_len)
    local = shard_tree(full, param_shardings(full, cfg, part.mesh),
                       part.coord)
    layout = lm.serve_layout(cfg, part, B)
    names = case.get("controls") or (case.get("control")
                                     or SHARD_SERVE_CONTROLS[layout],)
    control_params = (cross_from_participant_0(local, cfg, full, part)
                      if "cross_from_participant_0" in names else None)
    del full
    shared = [{"tokens": [t.cpu() for t in ref["tokens"]],
               "routing": [r.cpu() for r in routing.recorded]}
              if lead else None]
    dist.broadcast_object_list(shared, src=0)
    tokens = [t.to(device) for t in shared[0]["tokens"]]
    rows = RowRouting([r.to(device) for r in shared[0]["routing"]], part,
                      cfg, B)
    n_moe = expected_launches(cfg)[0]["moe_gmm"] // 3
    step_routing = Routing()             # the control replays step 1's
    step_routing.recorded = rows.recorded[n_moe:2 * n_moe]
    batch = {"tokens": tokens[0], **extra}
    zero_counts()
    cache = model.init_cache(local, batch, max_len, shards=part)
    init_launches = kernel_counts()
    with rows.replay() as flips:
        lg, cache, rec = sharded_call(model.prefill, device, local, batch,
                                      cache, part=part)
        gathered = [gather_cache(cache, cfg, part, B)]
        start = copy_cache(cache)
        logits, records, cache = sharded_steps(model, local, part, cache,
                                               tokens[1:], device)
    logits, records = [lg, *logits], [rec, *records]
    gathered.append(gather_cache(cache, cfg, part, B))
    controls = {}
    for name in names:
        if name in CACHE_CONTROLS:
            # a control of the cache: built, prefilled and stepped under it
            c_routing = Routing()
            c_routing.recorded = rows.recorded[:2 * n_moe]
            own = name == "cross_from_participant_0"
            with c_routing.replay(), (
                    contextlib.nullcontext() if own
                    else shard_control(name)):
                c_params = control_params if own else local
                c_cache = model.init_cache(c_params, batch, max_len,
                                           shards=part)
                c_logits, c_cache = model.prefill(c_params, batch, c_cache,
                                                  shards=part)
                c_gathered = gather_cache(c_cache, cfg, part, B)
                control, _, _ = sharded_steps(model, c_params, part,
                                              c_cache, tokens[1:2], device)
            controls[name] = ([c_logits, *control], 0, c_gathered)
        else:
            with step_routing.replay(), shard_control(name):
                control, _, _ = sharded_steps(model, local, part,
                                              copy_cache(start), tokens[1:2],
                                              device)
            controls[name] = (control, 1, None)
    whole = whole_rows(logits, part, B)
    out = {"layers": cfg.n_layers, "records": records, "layout": layout,
           "launches_expected": expected_shard_serve_launches(
               cfg, layout, rows.local_rows, len(tokens)),
           "init_launches": init_launches,
           "init_launches_expected": expected_model_launches(cfg)[
               "init_cache"],
           "fingerprints": [fingerprint(t) for t in logits],
           "len": int(cache["len"]), "routing_flips": flips,
           "control": ", ".join(names)}
    if lead:
        V = cfg.vocab
        out.update(
            logits_rel_rms=[rel_rms(g[..., :V], w[..., :V])
                            for g, w in zip(whole, ref["logits"])],
            tokens_equal=all(torch.equal(g[:, -1, :V].argmax(-1),
                                         w[:, -1, :V].argmax(-1))
                             for g, w in zip(whole, ref["logits"])),
            cache_rel_rms=[max(rel_rms(g, w) for g, w in zip(
                tree.leaves(cache_state(got)), tree.leaves(want),
                strict=True))
                for got, want in zip(gathered, ref["caches"])],
            len_equal=int(gathered[-1]["len"]) == ref["len"])
        out["controls_rel_rms"], cache_rel = {}, {}
        for name, (control, first, c_gathered) in controls.items():
            control = whole_rows(control, part, B)
            worst = max(rel_rms(c[..., :V], w[..., :V]) for c, w in zip(
                control, ref["logits"][first:first + len(control)]))
            if c_gathered is not None:
                cache_rel[name] = max(rel_rms(g, w) for g, w in zip(
                    tree.leaves(cache_state(c_gathered)),
                    tree.leaves(ref["caches"][0]), strict=True))
                worst = max(worst, cache_rel[name])
            out["controls_rel_rms"][name] = worst
        out["control_rel_rms"] = min(out["controls_rel_rms"].values())
        if cache_rel:
            out["control_cache_rel_rms"] = cache_rel
    else:
        for control, _, _ in controls.values():
            whole_rows(control, part, B)        # the gather is collective
    return out


def state_fingerprints(cache: dict) -> dict:
    """Checksums of a cache's SSM state: every slot's ``conv_bc`` (whole
    on every model participant) and ``ssm`` (a head block where the heads
    divide the model axis, else whole)."""
    slots = [s for s in cache.get("slots", {}).values() if "conv_bc" in s]
    return {name: [fingerprint(s[name]) for s in slots]
            for name in ("conv_bc", "ssm")}


def build_in_turns(cfg, seed: int, device, part) -> tuple[dict, float]:
    """Every rank's block of the seeded parameters as served
    (``seeded_block``), the ranks building one after another, so that the
    card holds one whole float32 leaf at a time (jamba's stacked experts:
    15 GB); each rank's peak GB while it builds (None off the card)."""
    on_card = device.type == "cuda"
    local, peak = None, None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            local = seeded_block(cfg, seed, device, part)
            if on_card:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 1e9
                torch.cuda.empty_cache()
        dist.barrier()
    return local, peak


def shard_serve_bf16(seed: int, device, key: str, part) -> dict:
    """Case ``key``'s bf16 run: rank 0 runs the unsharded model greedily
    with the same kernels (routing recorded) on the seeded parameters as
    served, built leaf by leaf, and frees them; the ranks then build their
    blocks in turns (``build_in_turns``) and run the sharded cells, fed
    those tokens with that routing replayed, each call timed (CUDA events)
    with its launches and collectives, the SSM state's checksums after
    the prefill and after the last step, each rank's peak GB and the
    card's memory in use once every rank holds its block and cache; then,
    in a ``full_cache`` case, decodes until its cache is full (from a
    cache prefilled again to eight positions short of it where the steps
    ended short of that) and once more, which must raise ``IndexError``;
    in a case with no float32 check (``f32_layers`` None), the control:
    the block's ``CONTROL_WEIGHTS`` rounded in place to ``CONTROL_BITS``
    bits, a prefill and the first step (routing replayed) read against
    the unsharded run."""
    case = SHARD_SERVE_CASES[key]
    B = case["batch"]
    new, max_len = (case.get("new", SHARD_SERVE_NEW),
                    case.get("max_len", SHARD_SERVE_LEN))
    cfg = case_config(case, case["layers"])
    model = Model(cfg)
    lead = dist.get_rank() == 0
    on_card = device.type == "cuda"
    routing = Routing()
    ref = None
    extra = serve_frames(cfg, seed, device, case)
    if lead:
        served = seeded_block(cfg, seed, device)
        with routing.record():
            ref = greedy_unsharded(model, served, serve_prompts(
                cfg, seed, device, B, case["prompt"]), device, extra, new,
                max_len)
        del served, ref["caches"]
        if on_card:
            torch.cuda.empty_cache()
    shared = [{"tokens": [t.cpu() for t in ref["tokens"]],
               "routing": [r.cpu() for r in routing.recorded]}
              if lead else None]
    dist.broadcast_object_list(shared, src=0)
    local, build_peak = build_in_turns(cfg, seed, device, part)
    tokens = [t.to(device) for t in shared[0]["tokens"]]
    rows = RowRouting([r.to(device) for r in shared[0]["routing"]], part,
                      cfg, B)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    batch = {"tokens": tokens[0], **extra}
    zero_counts()
    cache = model.init_cache(local, batch, max_len, shards=part)
    init_launches = kernel_counts()
    states = []
    with rows.replay() as flips:
        lg, cache, rec = sharded_call(model.prefill, device, local, batch,
                                      cache, part=part)
        states.append(state_fingerprints(cache))
        logits, records, cache = sharded_steps(model, local, part, cache,
                                               tokens[1:], device)
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    card_used = None
    if on_card:
        free, total = torch.cuda.mem_get_info()
        card_used = (total - free) / 1e9
    logits, records = [lg, *logits], [rec, *records]
    states.append(state_fingerprints(cache))
    fingerprints = [fingerprint(t) for t in logits]
    length = int(cache["len"])
    whole = whole_rows(logits, part, B)
    full_error = None
    if case["full_cache"]:
        tok = torch.zeros_like(tokens[1])
        start = max_len - 8
        if cache["pos"] != start:
            long = torch.cat([tokens[0]] * -(-start // tokens[0].shape[1]),
                             dim=1)[:, :start]
            cache = model.init_cache(local, {"tokens": long, **extra},
                                     max_len, shards=part)
            _, cache = model.prefill(local, {"tokens": long}, cache,
                                     shards=part)
        while cache["pos"] < max_len:
            _, cache = model.decode(local, tok, cache, shards=part)
        try:
            model.decode(local, tok, cache, shards=part)
        except IndexError as e:
            full_error = f"IndexError: {e}"
    control, control_flips = None, None
    if case["f32_layers"] is None:
        del cache
        coarsen_in_place(local, CONTROL_BITS)
        n_moe = expected_launches(cfg)[0]["moe_gmm"] // 3
        c_routing = Routing()
        c_routing.recorded = rows.recorded[:2 * n_moe]
        with c_routing.replay() as control_flips:
            c_cache = model.init_cache(local, batch, max_len, shards=part)
            c_logits, c_cache = model.prefill(local, batch, c_cache,
                                              shards=part)
            control, _, _ = sharded_steps(model, local, part, c_cache,
                                          tokens[1:2], device)
        control = whole_rows([c_logits, *control], part, B)
        del c_cache
    layout = lm.serve_layout(cfg, part, B)
    out = {"layers": cfg.n_layers, "records": records, "layout": layout,
           "launches_expected": expected_shard_serve_launches(
               cfg, layout, rows.local_rows, len(tokens)),
           "init_launches": init_launches,
           "init_launches_expected": expected_model_launches(cfg)[
               "init_cache"],
           "local_rows_per_router_call": rows.local_rows,
           "fingerprints": fingerprints,
           "conv_bc_fingerprints": [st["conv_bc"] for st in states],
           "ssm_fingerprints": [st["ssm"] for st in states],
           "len": length, "routing_flips": flips, "peak_memory_gb": peak,
           "build_peak_memory_gb": build_peak,
           "card_memory_in_use_gb": card_used, "full_cache": full_error,
           "control_routing_flips": control_flips}
    if lead:
        V = cfg.vocab
        out["logits_rel_rms"] = [rel_rms(g[..., :V].float(),
                                         w[..., :V].float())
                                 for g, w in zip(whole, ref["logits"])]
        if control is not None:
            out["control_rel_rms"] = max(
                rel_rms(c[..., :V].float(), w[..., :V].float())
                for c, w in zip(control, ref["logits"]))
    del local
    return out


def shard_serve_prefill(seed: int, device, key: str, part) -> dict:
    """A prefill-only case (``moe_impl="ep"``): in float32 (at
    ``f32_layers``) and in bf16, rank 0 prefills the unsharded model (the
    unsharded ep layer over the case's mesh, routing recorded; bf16 on the
    parameters cast) and every rank the sharded one on its block, its
    shard's calls of that routing replayed, with its launches, time and
    collectives; rank 0 holds the gathered logits (and in float32 the
    gathered cache, and the prefill under the case's control) to its
    unsharded run's.  Then a decode step, which must raise ``ValueError``
    before any collective."""
    from repro_torch.convert import gather_cache
    from repro_torch.parallel.sharding import param_shardings, shard_tree

    case = SHARD_SERVE_CASES[key]
    B, max_len = case["batch"], case.get("max_len", SHARD_SERVE_LEN)
    lead = dist.get_rank() == 0
    on_card = device.type == "cuda"
    out = {}
    for kind, layers, kw in (("f32", case["f32_layers"],
                              {"dtype": "float32"}),
                             ("bf16", case["layers"], {})):
        cfg = case_config(case, layers, **kw)
        model = Model(cfg)
        full = model.init(torch.Generator(device=device).manual_seed(seed))
        local = cast_params(shard_tree(full, param_shardings(
            full, cfg, part.mesh), part.coord), cfg, device, in_place=True)
        batch = {"tokens": serve_prompts(cfg, seed, device, B,
                                         case["prompt"])}
        routing, ref = Routing(), None
        if lead:
            served = cast_params(full, cfg, device, in_place=True)
            with unsharded_mesh(case), routing.record(), torch.no_grad():
                cache = model.init_cache(served, batch, max_len)
                logits, cache = model.prefill(served, batch, cache)
            ref = {"logits": logits, "cache": cache_state(cache)}
            del served, cache
        del full
        if on_card:
            torch.cuda.empty_cache()
        shared = [[r.cpu() for r in routing.recorded] if lead else None]
        dist.broadcast_object_list(shared, src=0)
        rows = Routing()
        rows.recorded = [r.to(device)
                         for r in own_calls(shared[0], case, part)]
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            zero_counts()
            cache = model.init_cache(local, batch, max_len, shards=part)
            init_launches = kernel_counts()
            with rows.replay() as flips:
                lg, cache, rec = sharded_call(model.prefill, device, local,
                                              batch, cache, part=part)
            peak = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                    else None)
            whole = whole_rows([lg], part, B)[0]
            res = {"layers": cfg.n_layers, "records": [rec],
                   "launches_expected": [expected_launches(cfg)[0]],
                   "init_launches": init_launches,
                   "init_launches_expected": expected_model_launches(cfg)[
                       "init_cache"],
                   "fingerprints": [fingerprint(lg)],
                   "routing_flips": flips, "peak_memory_gb": peak,
                   "layout": lm.serve_layout(cfg, part, B)}
            if kind == "f32":
                gathered = gather_cache(cache, cfg, part, B)
                c_rows = Routing()
                c_rows.recorded = rows.recorded
                with c_rows.replay(), shard_control(case["control"]):
                    c_cache = model.init_cache(local, batch, max_len,
                                               shards=part)
                    c_lg = model.prefill(local, batch, c_cache,
                                         shards=part)[0]
                    del c_cache
                c_whole = whole_rows([c_lg], part, B)[0]
            seen: list = []
            try:
                with collectives.observe(
                        lambda kind_, n: seen.append(kind_)):
                    model.decode(local, batch["tokens"][:, :1], cache,
                                 shards=part)
                res["decode"] = None
            except ValueError as e:
                res["decode"] = f"ValueError: {e}"
            res["decode_collectives"] = seen
        if lead:
            V = cfg.vocab
            res["logits_rel_rms"] = [rel_rms(whole[..., :V].float(),
                                             ref["logits"][..., :V].float())]
            if kind == "f32":
                res["cache_rel_rms"] = [max(
                    rel_rms(g, w) for g, w in zip(
                        tree.leaves(gathered["slots"]),
                        tree.leaves(ref["cache"]), strict=True))]
                res["control"] = case["control"]
                res["control_rel_rms"] = rel_rms(
                    c_whole[..., :V], ref["logits"][..., :V])
        out[kind] = res
        del local, cache, ref
        if on_card:
            torch.cuda.empty_cache()
    return out


def shard_serve_rank(seed: int, device, part, key: str) -> dict:
    """One participant's ``shard_serve_path`` case: its float32 check
    (None where the case has none) and its bf16 run (a prefill-only
    case's: ``shard_serve_prefill``)."""
    case = SHARD_SERVE_CASES[key]
    if case.get("prefill_only"):
        t0 = time.time()
        run = shard_serve_prefill(seed, device, key, part)
        return {"coord": part.coord, "di": part.di, **run,
                "seconds": time.time() - t0}
    t0 = time.time()
    f32 = None
    if case["f32_layers"] is not None:
        f32 = shard_serve_f32(seed, device, key, part)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.time()
    bf16 = shard_serve_bf16(seed, device, key, part)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"coord": part.coord, "di": part.di, "f32": f32, "bf16": bf16,
            "f32_s": t1 - t0, "bf16_s": time.time() - t1}


def prefill_case_checks(key: str, ranks: list, card: str) -> dict:
    """A prefill-only ``shard_serve_path`` case's readings and checks over
    every rank's (``shard_serve_prefill``)."""
    case = SHARD_SERVE_CASES[key]
    per = [r["serve"][key] for r in ranks]
    f32, bf16 = per[0]["f32"], per[0]["bf16"]
    limit = SERVE_BF16_KERNEL_VS_PLAIN[case["arch"]]
    groups: dict = {}
    for p in per:
        for kind in ("f32", "bf16"):
            groups.setdefault((kind, p["di"]), set()).add(
                tuple(p[kind]["fingerprints"]))
    checks = {
        "layout": f32["layout"] == bf16["layout"] == case["layout"],
        "launches": all(p[kind]["records"][0]["launches"]
                        == p[kind]["launches_expected"][0]
                        for p in per for kind in ("f32", "bf16")),
        "init_cache_launches": all(
            p[kind]["init_launches"] == p[kind]["init_launches_expected"]
            for p in per for kind in ("f32", "bf16")),
        "f32_logits": max(f32["logits_rel_rms"]) <= SERVE_F32_REL_RMS,
        "f32_cache": max(f32["cache_rel_rms"]) <= SERVE_F32_REL_RMS,
        "f32_control_past_limit": f32["control_rel_rms"]
        > SERVE_F32_REL_RMS,
        "f32_routing": flip_share(f32["routing_flips"], "float32")
        <= ROUTING_FLIP_SHARE["float32"],
        "bf16_logits": max(bf16["logits_rel_rms"]) <= limit,
        "bf16_routing": routing_ok([bf16["routing_flips"]]),
        "logits_bits_equal_across_model_ranks": all(
            len(v) == 1 for v in groups.values()),
        "decode_raises_on_every_rank_before_any_collective": all(
            (p[kind]["decode"] or "").startswith("ValueError")
            and not p[kind]["decode_collectives"]
            for p in per for kind in ("f32", "bf16")),
    }
    return {
        "arch": get_config(case["arch"]).name, "moe_impl": case["moe_impl"],
        "mesh": {"data": case["mesh"][0], "model": case["mesh"][1]},
        "layers": bf16["layers"], "f32_layers": f32["layers"],
        "batch": case["batch"], "prompt_len": case["prompt"], "gpu": card,
        "prefill_ms_per_rank": [p["bf16"]["records"][0]["ms"] for p in per],
        "time_note": f"{len(per)} processes share one card and gloo copies "
                     "through the host: not a multi-card time",
        "peak_memory_gb_per_rank": [p["bf16"]["peak_memory_gb"]
                                    for p in per],
        "launches_prefill_rank0": bf16["records"][0]["launches"],
        "collectives_prefill_rank0": bf16["records"][0]["collectives"],
        "decode_rank0": bf16["decode"],
        "f32": {k: f32.get(k) for k in (
            "logits_rel_rms", "cache_rel_rms", "control", "control_rel_rms",
            "routing_flips")},
        "f32_limit_rel_rms": SERVE_F32_REL_RMS,
        "bf16": {"max_rel_rms": max(bf16["logits_rel_rms"]),
                 "limit": limit, "routing_flips": bf16["routing_flips"],
                 "routing_limit": ROUTING_FLIP_SHARE["bfloat16"]},
        "seconds_rank0": per[0]["seconds"], "checks": checks}


def phase_shard_serve(ranks: list, card: str,
                      pool: int = SHARD_RANKS) -> dict:
    """``shard_serve_path``'s checks over every rank's readings of the
    pool's cases (module doc, phase 13)."""
    out, failed = {}, []
    for key, case in pool_cases(SHARD_SERVE_CASES, pool).items():
        if case.get("prefill_only"):
            out[key] = prefill_case_checks(key, ranks, card)
            failed += [f"{key}: {k}" for k, ok in out[key]["checks"].items()
                       if not ok]
            continue
        arch = case["arch"]
        cfg = get_config(arch)
        per = [r["serve"][key] for r in ranks]
        f32, bf16 = per[0]["f32"], per[0]["bf16"]
        limit = SERVE_BF16_KERNEL_VS_PLAIN[arch]
        rows_whole = case["batch"] % case["mesh"][0] != 0

        def launches_exact(kind: str) -> bool:
            return all(rec["launches"] == want for p in per for rec, want
                       in zip(p[kind]["records"],
                              p[kind]["launches_expected"], strict=True))

        def same_bits(kind: str, reading: str) -> bool:
            """The same ``reading`` on every participant holding the same
            rows: of a data group, or all of them where the rows are
            whole."""
            groups: dict = {}
            for p in per:
                groups.setdefault(0 if rows_whole else p["di"], set()).add(
                    json.dumps([p[kind][reading], p[kind]["len"]]))
            return all(len(v) == 1 for v in groups.values())
        kinds = ("bf16",) if f32 is None else ("f32", "bf16")
        checks = {
            "layout": all(per[0][k]["layout"] == case["layout"]
                          for k in kinds),
            "launches": launches_exact("bf16"),
            "bf16_logits": max(bf16["logits_rel_rms"]) <= limit,
            "bf16_routing": routing_ok([bf16["routing_flips"]]),
            "logits_bits_equal_across_model_ranks": all(
                same_bits(k, "fingerprints") for k in kinds),
            "conv_bc_bits_equal_across_model_ranks":
                same_bits("bf16", "conv_bc_fingerprints"),
            "init_cache_launches": all(
                p[kind]["init_launches"] == p[kind]["init_launches_expected"]
                for p in per for kind in kinds),
            "full_cache_raises_on_every_rank": all(
                (p["bf16"]["full_cache"] or "").startswith("IndexError")
                for p in per) if case["full_cache"] else True,
        }
        if f32 is None:
            checks["bf16_control_past_limit"] = bf16["control_rel_rms"] > limit
        else:
            checks.update({
                "f32_launches": launches_exact("f32"),
                "f32_logits": max(f32["logits_rel_rms"]) <= SERVE_F32_REL_RMS,
                "f32_tokens_equal": f32["tokens_equal"],
                "f32_cache": max(f32["cache_rel_rms"]) <= SERVE_F32_REL_RMS
                and f32["len_equal"],
                "f32_control_past_limit": f32["control_rel_rms"]
                > SERVE_F32_REL_RMS,
                "f32_routing": flip_share(f32["routing_flips"], "float32")
                <= ROUTING_FLIP_SHARE["float32"]})
        if cfg.ssm_state and cfg.ssm_heads % case["mesh"][1]:
            # the state is whole on every model participant: all-gathered
            # from their channels after the prefill and every step
            checks["ssm_bits_equal_across_model_ranks"] = same_bits(
                "bf16", "ssm_fingerprints")
        if cfg.ssm_state and rows_whole:
            # every data participant runs the same rows' recurrence: its
            # block of the state (by model coordinate) is the same bits
            held: dict = {}
            for p in per:
                held.setdefault(p["coord"].get("model", 0), set()).add(
                    json.dumps(p["bf16"]["ssm_fingerprints"]))
            checks["ssm_bits_equal_across_data_participants"] = all(
                len(v) == 1 for v in held.values())
        if bf16["layout"] in ("hd", "seq_hd"):
            checks["no_decode_kernel_in_hd_layout"] = all(
                rec["launches"]["decode_attention"] == 0 for p in per
                for kind in kinds for rec in p[kind]["records"])
        step_ms = [[rec["ms"] for rec in p["bf16"]["records"][1:]]
                   for p in per]
        out[key] = {
            "arch": get_config(arch).name,
            "mesh": {"data": case["mesh"][0], "model": case["mesh"][1]},
            "layout": {"head": "head-sharded", "hd": "hd-sharded",
                       "seq": "fully-seq, whole heads",
                       "seq_hd": "fully-seq, head_dim blocks",
                       None: "no attention"}[bf16["layout"]],
            "rows": "whole on every rank" if rows_whole
            else "a data block a rank",
            "layers": bf16["layers"], "batch": case["batch"],
            "prompt_len": case["prompt"],
            "frames": case.get("frames"),
            "new_tokens": case.get("new", SHARD_SERVE_NEW),
            "max_len": case.get("max_len", SHARD_SERVE_LEN), "gpu": card,
            "prefill_ms_per_rank": [p["bf16"]["records"][0]["ms"]
                                    for p in per],
            "decode_ms_per_step_median_per_rank": [
                statistics.median(m) for m in step_ms],
            "decode_ms_per_step_rank0": step_ms[0],
            "time_note": f"{len(per)} processes share one card and gloo "
                         "copies through the host: not a multi-card time",
            "peak_memory_gb_per_rank": [p["bf16"]["peak_memory_gb"]
                                        for p in per],
            "launches_init_cache_rank0": bf16["init_launches"],
            "launches_prefill_rank0": bf16["records"][0]["launches"],
            "launches_step_rank0": bf16["records"][1]["launches"],
            "k5_launches_per_rank": [sum(rec["launches"]["moe_gmm"]
                                         for rec in p["bf16"]["records"])
                                     for p in per],
            "collectives_prefill_rank0": bf16["records"][0]["collectives"],
            "collectives_step_rank0": bf16["records"][1]["collectives"],
            "build_peak_memory_gb_per_rank": [
                p["bf16"]["build_peak_memory_gb"] for p in per],
            "card_memory_in_use_gb": max(
                p["bf16"]["card_memory_in_use_gb"] or 0 for p in per),
            "f32": None if f32 is None else {k: f32[k] for k in (
                "layers", "logits_rel_rms", "tokens_equal", "cache_rel_rms",
                "len_equal", "control", "control_rel_rms", "routing_flips")},
            "f32_controls_rel_rms": None if f32 is None
            else f32.get("controls_rel_rms"),
            "f32_control_cache_rel_rms": None if f32 is None
            else f32.get("control_cache_rel_rms"),
            "f32_limit_rel_rms": SERVE_F32_REL_RMS,
            "bf16": {"max_rel_rms": max(bf16["logits_rel_rms"]),
                     "rel_rms_per_call": bf16["logits_rel_rms"],
                     "limit": limit, "routing_flips": bf16["routing_flips"],
                     "routing_limit": ROUTING_FLIP_SHARE["bfloat16"],
                     "control_bits": CONTROL_BITS if f32 is None else None,
                     "control_rel_rms": bf16.get("control_rel_rms"),
                     "control_routing_flips": bf16["control_routing_flips"]},
            "full_cache_rank0": bf16["full_cache"],
            "seconds_rank0": {"f32": per[0]["f32_s"],
                              "bf16": per[0]["bf16_s"]},
            "checks": checks}
        failed += [f"{key}: {k}" for k, ok in checks.items() if not ok]
    run = {"ranks": pool, "cases": out}
    if failed:
        emit({"phase": "shard_serve_path", "ok": False, **run})
    check(not failed, "shard_serve: " + ", ".join(failed))
    return run


# -- the diagnosis stack ------------------------------------------------------

@contextlib.contextmanager
def gate_calls():
    """Every ``GateStaging.run`` inside the block: under ``"calls"`` the
    live rows of each packed batch and, on the card, its CUDA-event times
    ``(h2d, kernel, d2h)`` in ms; under ``"largest"`` the live rows and a
    copy of the inputs of the batch with the most.  K1's launch count is
    zeroed on entry, so ``bigroots_gates.LAUNCHES`` after the block counts
    the block's launches."""
    seen = {"calls": [], "largest": (0, None)}
    run = GateStaging.run

    def counted(self, batch, peer_mean):
        self.record_events = True
        gbits = run(self, batch, peer_mean)
        live = int(batch.counts.sum())
        seen["calls"].append((live, self.last_ms))
        if live > seen["largest"][0]:
            seen["largest"] = (live, tuple(t.clone()
                                           for t in self.last_inputs()))
        return gbits

    GateStaging.run = counted
    bigroots_gates.LAUNCHES = 0
    try:
        yield seen
    finally:
        GateStaging.run = run


def golden(kind: str, name: str) -> bytes:
    with open(os.path.join(GOLDEN_DIR, f"{kind}_{name}.golden"), "rb") as f:
        return f.read()


def cause_lines(body: bytes) -> list[dict]:
    return [json.loads(ln) for ln in body.decode().splitlines()
            if not ln.startswith("#")]


def gate_launches(what: str, seen: dict, gated: int,
                  seconds: float) -> dict:
    """K1's launches in a run: one for every packed sweep, and at least one
    where the run confirmed a cause through the gates.  Beside them the
    CUDA-event span of each launch (``k1_event_ms_*``) and the share of the
    run's host-clock ``seconds`` outside the sweeps' event spans: at a few
    live rows the copies before a launch are too short to hide the
    wrapper's host work, so a span holds that enqueue too, and bounds the
    kernel's time (and the device's busy time) from above."""
    calls = seen["calls"]
    launches = bigroots_gates.LAUNCHES
    check(launches == len(calls),
          f"{what}: {len(calls)} gate sweeps, {launches} K1 launches")
    check(launches > 0 or gated == 0,
          f"{what}: {gated} gate-confirmed causes without a K1 launch")
    ms = [t for _, t in calls if t is not None]
    kernel = [t[1] for t in ms]
    spans = sum(map(sum, ms))
    return {"k1_launches": launches, "gate_confirmed": gated,
            "max_live_rows": seen["largest"][0],
            "k1_event_ms_median": (statistics.median(kernel) if kernel
                                   else None),
            "k1_event_ms_max": max(kernel, default=None),
            "sweep_event_ms": spans,
            "idle_share_outside_sweeps": 1.0 - spans / (seconds * 1e3)}


def diagnosis_goldens(device) -> tuple[dict, tuple]:
    """The six library scenarios and the pinned episode exports on the
    card, each byte for byte against the JAX package's golden.  Also
    returns the inputs of the scenarios' largest packed batch."""
    schema_cols = set(JAX_FEATURES.names)
    out, largest = {}, (0, None)
    for name in SCENARIO_LIBRARY:
        want = golden("scenario", name)
        with gate_calls() as seen:
            res = run_scenario(name, device=device)
        check(res.golden_bytes() == want,
              f"scenario {name}: golden bytes differ")
        gated = sum(c["feature"] in schema_cols for c in cause_lines(want))
        out[name] = {"causes": len(res.causes), "seconds": res.wall_seconds,
                     **gate_launches(f"scenario {name}", seen, gated,
                                     res.wall_seconds)}
        largest = max(largest, seen["largest"], key=lambda x: x[0])
    for name in EPISODE_PINS:
        with gate_calls() as seen:
            es = export_episodes(name, device=device)
        check(es.golden_bytes() == golden("episodes", name),
              f"episodes {name}: golden bytes differ")
        out[f"episodes_{name}"] = {
            "sequences": len(es.y), "positives": es.positives,
            "seconds": es.wall_seconds,
            **gate_launches(f"episodes {name}", seen, len(es.confirmed),
                            es.wall_seconds)}
    return out, largest[1]


def diagnosis_scaled(device) -> dict:
    """hot_host_cpu at ``SCALED_HOSTS`` hosts: K1 on the card against the
    numpy gate oracle on the host, byte for byte, and the incident host's
    causes against the 16-host golden's."""
    sc = build_scenario("hot_host_cpu", hosts=SCALED_HOSTS,
                        racks=SCALED_RACKS)
    with gate_calls() as seen:
        t0 = time.perf_counter()
        got = run_scenario(sc, device=device)
        seconds = time.perf_counter() - t0
    causes = [json.loads(ln) for ln in got.cause_lines]
    launches = gate_launches("scaled scenario", seen, len(causes), seconds)
    t0 = time.perf_counter()
    want = run_scenario(sc, device=torch.device("cpu"), backend="numpy")
    oracle_seconds = time.perf_counter() - t0
    check(got.golden_bytes() == want.golden_bytes(),
          f"{SCALED_HOSTS} hosts: torch and numpy backends differ")
    small = [c for c in cause_lines(golden("scenario", "hot_host_cpu"))
             if c["node"] == SCALED_NODE]
    check(small and causes == small,
          f"{SCALED_HOSTS} hosts: {SCALED_NODE}'s causes differ from the "
          "16-host golden's, or another node carries a cause")
    return {"hosts": SCALED_HOSTS, "racks": SCALED_RACKS,
            "causes": len(causes), "rows_ingested":
            got.counters["rows_ingested"], "seconds": seconds,
            "numpy_backend_seconds": oracle_seconds, **launches}


def loop_numbers(res) -> tuple:
    return (res.stage_times, res.causes_per_stage, res.speculated,
            res.cordoned, res.job_duration,
            res.engine.decision_log_bytes())


def diagnosis_closed_loop(device) -> dict:
    """The closed-loop A/B on the card, as examples/fault_tolerance_demo.py
    asserts it, and equal to the same call on the host."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as tmp:
        for scenario in ("cpu", "skew"):
            path = os.path.join(tmp, f"audit_{scenario}.jsonl")
            ab = ab_compare(scenario, seed=0, audit_path=path, device=device)
            b, m = ab.baseline, ab.mitigated
            check(b.actuator.applied == [] and b.engine.dry_run,
                  f"A/B {scenario}: the diagnose-only arm acted")
            check(ab.improvement > AB_IMPROVEMENT,
                  f"A/B {scenario}: recovered only {ab.improvement:.3f}")
            with open(path) as f:
                decisions = sum(json.loads(ln)["type"] == "decision"
                                for ln in f)
            check(decisions > 0, f"A/B {scenario}: no decision audited")
            host = ab_compare(scenario, seed=0, device=torch.device("cpu"))
            check(loop_numbers(m) == loop_numbers(host.mitigated)
                  and loop_numbers(b) == loop_numbers(host.baseline),
                  f"A/B {scenario}: the card's run differs from the host's")
            out[scenario] = {"improvement": ab.improvement,
                             "mitigated_mean_step_s": m.mean_step_time,
                             "baseline_mean_step_s": b.mean_step_time,
                             "actions": len(m.actuator.applied),
                             "audited_decisions": decisions}
    return out


def diagnosis_training(device) -> dict:
    """The forecaster's value gate with parameters trained on the card, and
    the largest parameter difference from the same training on the host."""
    train = [export_episodes(n, seed=s, device=device) for n, s in VALUE_TRAIN]
    held = [export_episodes(n, seed=s, device=device) for n, s in VALUE_HELD]
    t0 = time.perf_counter()
    params = train_forecaster(train, seed=0, steps=VALUE_STEPS, lr=0.05,
                              device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = train_forecaster(train, seed=0, steps=VALUE_STEPS, lr=0.05,
                            device=torch.device("cpu"))
    host_s = time.perf_counter() - t0
    rep = evaluate_forecaster(params, held)
    lead = lead_time_curve(params, held, thresholds=(0.5,))[0]
    check(rep["positives"] > 0 and rep["auc"] > rep["baseline_auc"],
          f"value gate: AUC {rep['auc']} vs baseline {rep['baseline_auc']}")
    check(lead["median_lead_steps"] > 0.0 and lead["precision"] >= 0.5
          and lead["recall"] > 0.0, f"value gate: lead {lead}")
    diff = max(float(np.max(np.abs(np.asarray(params[k]) - host[k])))
               for k in params)
    check(np.isfinite(diff), "card-trained parameters are not finite")
    return {"steps": VALUE_STEPS, "train_seconds": card_s,
            "host_train_seconds": host_s, **rep, "lead_at_0.5": lead,
            "host_auc": evaluate_forecaster(host, held)["auc"],
            "max_param_diff_vs_host": diff}


def phase_diagnosis(device, flush) -> dict:
    t0 = time.perf_counter()
    goldens, largest = diagnosis_goldens(device)
    peer_mean = BigRootsThresholds().peer_mean
    out = {"goldens": goldens, "k1_at_largest_batch": {
        "live_rows": int(largest[4].sum().item()),
        **hold_against_plain(largest, peer_mean, "scenarios' largest batch"),
        **measure(largest, peer_mean, flush)}}
    out["scaled"] = diagnosis_scaled(device)
    out["closed_loop"] = diagnosis_closed_loop(device)
    out["training"] = diagnosis_training(device)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- the roofline of the timed paths -------------------------------------------

#: An ``mfu`` or achieved roofline fraction above this fails the phase: the
#: path would have run faster than the card's peaks allow, so a count or a
#: time is wrong.
ROOFLINE_LIMIT = 1.05


def roofline_paths(served: dict, train: dict) -> list:
    """``(config, kind, batch, length, cache, measured ms, peak bytes,
    launches)`` of each timed path: the serving prefill (its one timed
    call) and decode step (the median) of every served arch (``served``:
    arch → its run) at its served depth, the serving batch and prompt (a
    VLM's patches and text together) and its cache, and one train step
    (the median of steps 2–8) of every trained arch at its training shape.
    Launches are what the card made in one such call."""
    out = []
    for arch, run in served.items():
        cfg = served_config(arch)
        want = expected_model_launches(cfg)
        peak = run["peak_memory_gb"] * 1e9
        S, cache = cfg.frontend_tokens + PROMPT_LEN, serve_max_len(cfg)
        out += [(cfg, "prefill", SERVE_BATCH, S, cache, run["prefill_ms"],
                 peak, want["prefill"]),
                (cfg, "decode", SERVE_BATCH, S, cache,
                 run["decode_ms_per_step_median"], peak, want["decode"])]
    for arch in (MOE_ARCH, SSM_ARCH, ENCDEC_ARCH):
        B, S = TRAIN_SHAPES[arch]
        cfg = get_config(arch)
        out.append((cfg, "train", B, S, None, train[arch]["step_ms_median"],
                    train[arch]["peak_memory_gb"] * 1e9,
                    expected_train_launches(cfg)))
    return out


def path_roofline(cfg, kind: str, B: int, S: int, cache: int | None,
                  ms: float, peak: float, launches: dict) -> dict:
    """One timed path against the dry run's counters: the same step on
    ``meta`` at the same config (as served: cut in depth where the path
    is), shape and impls (served parameters in the compute dtype, as
    ``ServeEngine`` casts them), on a 1 × 1 mesh."""
    shape = ShapeSpec(f"{kind}_{B}x{S}", S, B, kind)
    args, shardings, step = dryrun.build_cell(
        cfg, shape, make_mesh((1, 1), ("data", "model")), max_len=cache,
        served=kind != "train")
    arg_bytes = dryrun.argument_bytes(args, shardings)
    counted = dryrun.count_step(step)
    roof = roofline.Roofline.build(
        counted["flops"], counted["bytes"], None, 1,
        roofline.model_flops_for(cfg, shape), counted["bytes_upper"])
    seconds = ms / 1e3
    res = {"arch": cfg.name, "layers": cfg.n_layers, "kind": kind,
           "batch": B, "seq": S, "cache": cache,
           "measured_ms": ms, "model_flops": roof.model_flops,
           "flops": counted["flops"], "bytes": counted["bytes"],
           "bytes_upper": counted["bytes_upper"],
           "compute_ms": roof.compute_s * 1e3,
           "memory_ms": roof.memory_s * 1e3, "bound_ms": roof.bound_s * 1e3,
           "dominant": roof.dominant, "useful_ratio": roof.useful_ratio,
           "mfu": roof.model_flops / (seconds * roofline.PEAK_FLOPS),
           "roofline_fraction_achieved": roof.bound_s / seconds,
           "argument_bytes_1x1": arg_bytes, "peak_memory_bytes": peak,
           "kernels": counted["kernels"], "count_s": counted["seconds"]}
    check(res["mfu"] <= ROOFLINE_LIMIT
          and res["roofline_fraction_achieved"] <= ROOFLINE_LIMIT,
          f"{cfg.name} {kind}: mfu {res['mfu']} / fraction "
          f"{res['roofline_fraction_achieved']} above {ROOFLINE_LIMIT}")
    check(arg_bytes <= peak, f"{cfg.name} {kind}: the dry run's {arg_bytes} "
                             f"argument bytes exceed the measured peak {peak}")
    counted_launches = {k: v["launches"] for k, v in counted["kernels"].items()}
    check(counted_launches == {k: v for k, v in launches.items() if v},
          f"{cfg.name} {kind}: the meta run counted {counted_launches}, the "
          f"card launched {launches}")
    return res


def phase_roofline(served: dict, train: dict) -> list[dict]:
    """Every timed path's roofline.  An encoder-decoder's prefill also
    gives its ``mfu`` over ``init_cache`` + prefill: its model FLOPs
    (every parameter over every prompt token) count the encoder, which
    ``init_cache`` runs, and the prefill alone does not."""
    out = []
    for p in roofline_paths(served, train):
        res = path_roofline(*p)
        cfg, kind = p[0], p[1]
        if cfg.enc_layers and kind == "prefill":
            run = served[ENCDEC_ARCH]
            ms = run["init_cache_ms"] + run["prefill_ms"]
            res.update(init_cache_ms=run["init_cache_ms"],
                       mfu_init_cache_and_prefill=res["model_flops"]
                       / (ms / 1e3 * roofline.PEAK_FLOPS))
        out.append(res)
    return out


# -- the dry run -----------------------------------------------------------------

#: The dry run runs on the host beside the card's phases, from the start
#: of ``run`` (after the build) to the ``dryrun`` phase, which waits for it,
#: in ``DRYRUN_JOBS`` processes: it needs no card, and alone it held the
#: card idle for 54.5-65.6 s of a 1036-1143 s run (NVIDIA H100 80GB HBM3,
#: 700.00 W).
DRYRUN_JOBS = 2
DRYRUN_TIMEOUT_S = 900.0


class DryRun:
    """``python -m repro_torch.launch.dryrun --all --mesh both`` (every
    cell on both production meshes, on meta) started in the background
    into a temporary directory, in a process group of its own (its pool's
    workers with it), which ``close`` ends."""

    def __init__(self, jobs: int) -> None:
        self.jobs = jobs
        self.dir = tempfile.TemporaryDirectory()
        self.err = open(os.path.join(self.dir.name, "stderr.txt"), "w+")
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "both", "--jobs", str(jobs), "--results-dir",
             os.path.join(self.dir.name, "cells")],
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
            stdout=subprocess.DEVNULL, stderr=self.err,
            start_new_session=True)

    def wait(self) -> tuple[int, float, float, list, str]:
        """``(rc, seconds from its start to its last cell's result,
        seconds waited here, rows, the tail of stderr)``."""
        t0 = time.perf_counter()
        rc = self.proc.wait(timeout=DRYRUN_TIMEOUT_S)
        waited = time.perf_counter() - t0
        self.err.seek(0)
        cells_dir = os.path.join(self.dir.name, "cells")
        rows = report.load(results_dir=cells_dir)
        ends = [os.path.getmtime(os.path.join(cells_dir, f))
                for f in os.listdir(cells_dir)] if os.path.isdir(
                    cells_dir) else []
        seconds = max(ends, default=time.time()) - self.t0
        return rc, seconds, waited, rows, self.err.read()[-2000:]

    def close(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()
        self.err.close()
        self.dir.cleanup()


def phase_dryrun(dry: DryRun | None = None) -> dict:
    """The dry run's results (``dry``, started earlier; else started here
    with a process per core and waited for): every cell must be ``ok``
    and count one participant's collectives, none refused.  Prints the
    report's two tables."""
    if dry is None:
        dry = DryRun(max(1, min(8, os.cpu_count() or 1)))
    try:
        rc, seconds, waited, rows, err = dry.wait()
    finally:
        dry.close()
    failed = [f"{r['mesh']} {r['arch']} {r['shape']}: {r.get('error')}"
              for r in rows if r["status"] != "ok"]
    check(rc == 0 and not failed and len(rows) == 64,
          f"dry run: rc {rc}, {len(rows)} cells, failed {failed}: {err}")
    print(report.dryrun_table(rows), flush=True)
    print(report.roofline_table(rows, mesh="single"), flush=True)
    refused = {(r["arch"], r["shape"], r["mesh"]) for r in rows
               if r["roofline"]["collective_bytes_per_device"] is None
               or r["collectives"]["skipped"] is not None}
    check(not refused and len(rows) == 2 * len(cells()),
          f"dry run: collectives uncounted in {sorted(refused)}")
    shown = {f"{r['mesh']} {r['arch']} {r['shape']}":
             r["collectives"]["bytes_by_kind"] for r in rows
             if (r["arch"], r["shape"]) in DRYRUN_SHOWN}
    return {"cells": len(rows), "seconds": seconds, "waited_s": waited,
            "jobs": dry.jobs,
            "dominant": {d: sum(r["roofline"]["dominant"] == d for r in rows)
                         for d in ("compute", "memory", "collective")},
            "collectives_uncounted": sorted(
                f"{m} {a} {s}" for a, s, m in refused),
            "collective_bytes_by_kind": shown}


#: Cells whose collective bytes by kind ``dryrun`` prints, on both meshes.
DRYRUN_SHOWN = (("glm4_9b", "train_4k"), ("glm4_9b", "decode_32k"),
                ("granite_moe_1b_a400m", "train_4k"),
                ("jamba_v0_1_52b", "long_500k"),
                ("mamba2_130m", "decode_32k"),
                ("seamless_m4t_medium", "prefill_32k"))


# -- the examples ----------------------------------------------------------------

#: The six examples with their smallest documented arguments.
EXAMPLES = {
    "quickstart": [],
    "anomaly_study": [],
    "fault_tolerance_demo": [],
    "serve_demo": [],
    "train_100m_bigroots": [],
    "fleet_demo": ["--hosts", "2", "--steps", "24", "--kill-after", "8",
                   "--lease", "1.0"],
}
#: Examples whose printed report must equal the same run on the host.
EXAMPLE_HOST_REPORT = ("quickstart", "anomaly_study")


def run_example(name: str, argv: list[str]) -> tuple[int, str, float]:
    """``repro_torch.examples.<name>.main(argv)`` in this process, its
    standard output kept."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_examples(device) -> dict:
    """Each example on the GPU: it must end with ``OK``; its kernel launches
    are counted (zeroed before, read after), every packed sweep it reaches
    launches K1, and ``serve_demo`` launches K2 and K3."""
    out = {}
    for name, extra in EXAMPLES.items():
        with gate_calls() as gates:
            zero_counts()
            rc, text, seconds = run_example(
                name, ["--device", str(device), *extra])
            launches = {**kernel_counts(),
                        "bigroots_gates": bigroots_gates.LAUNCHES}
        lines = text.strip().splitlines()
        check(rc == 0 and bool(lines) and lines[-1].startswith("OK"),
              f"example {name}: rc {rc}, last lines {lines[-3:]}")
        sweeps = len(gates["calls"])
        check(launches["bigroots_gates"] == sweeps,
              f"example {name}: K1 launched {launches['bigroots_gates']} "
              f"times over {sweeps} packed sweeps")
        if name == "serve_demo":
            check(launches["flash_attention"] >= 1
                  and launches["decode_attention"] >= 1,
                  f"serve_demo launched {launches}")
        run = {"seconds": seconds, "launches": launches,
               "packed_sweeps": sweeps, "last_line": lines[-1][:160]}
        if name in EXAMPLE_HOST_REPORT:
            _, host, _ = run_example(name, ["--device", "cpu", *extra])
            check(host == text, f"example {name}: the report differs from "
                                "the host's")
            run["equals_host_report"] = True
        out[name] = run
    return out


# -- phases -------------------------------------------------------------------

def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.splitlines()[-1], "gpu": card,
          "device_name": torch.cuda.get_device_name(0)})
    return card.splitlines()[0]


KERNEL_SOURCES = ("bigroots_gates", "flash_attention", "decode_attention",
                  "moe_gmm", "ssd_scan")


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build(KERNEL_SOURCES, verbose=True)
    for name in KERNEL_SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(str(v), ROOT)
                        for k, v in paths.items()},
          "flags": " ".join(build.NVCC_FLAGS)})


def run(args) -> None:
    card = phase_env()
    device = torch.device("cuda")
    phase_build()
    dry = DryRun(DRYRUN_JOBS)
    try:
        run_phases(args, card, device, dry)
    finally:
        dry.close()


def run_phases(args, card: str, device, dry: DryRun) -> None:
    """Every phase after the build (module doc), the dry run ``dry``
    running beside them until its phase."""
    peer_mean = BigRootsThresholds().peer_mean
    F = len(JAX_FEATURES)
    rng = np.random.default_rng(args.seed)
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=device)  # 128 MB

    replaced = Replaced(args.replaced) if args.replaced else None
    full = synthetic_batch(rng, 64, 16384, F, device)
    checks = [hold_against_plain(full, peer_mean, "full incident"),
              hold_against_plain(corner_batch(rng, device, F), peer_mean,
                                 "NaN values, zero counts, padded rows"),
              hold_against_plain(corner_batch(rng, device, 9), peer_mean,
                                 "the same at F=9")]
    checks += [hold_against_plain(t, peer_mean, label)
               for label, t in gate_corners(rng, device)]
    paths = {c["path"] for c in checks}
    check(paths == {"vector", "scalar"},
          f"the gate checks took only the {paths} path")
    check(all(c["path"] == "scalar" for c in checks
              if c["case"].startswith("unaligned")),
          "an unaligned view took the vector path")
    full_timing = measure(full, peer_mean, flush, replaced)
    del full
    emit({"phase": "kernels", "name": "bigroots_gates",
          "tolerance": "exact (int8 gate bits, torch.equal)",
          "checks": checks, "full_incident": full_timing})
    attn_checks = attention_checks(device, args.seed)
    for c in attn_checks:
        emit({"phase": "kernels", **c})
    attn_timing = attention_timings(device, args.seed, flush, replaced)
    emit({"phase": "kernels", "timings": attn_timing})
    moe_ssd_checks = gmm_checks(device, args.seed) + ssd_checks(
        device, args.seed)
    for c in moe_ssd_checks:
        emit({"phase": "kernels", **c})
    moe_ssd_timing = moe_ssd_timings(device, args.seed, flush, replaced)
    emit({"phase": "kernels", "timings": moe_ssd_timing})
    gmm_bwd_checks = gmm_backward_checks(device, args.seed)
    for c in gmm_bwd_checks:
        emit({"phase": "kernels", **c})
    gmm_bwd_timing = gmm_backward_timings(device, args.seed, flush)
    emit({"phase": "kernels", "timings": gmm_bwd_timing})
    t0 = time.perf_counter()
    shard_checks = shard_kernel_checks(device, args.seed)
    for c in shard_checks:
        emit({"phase": "kernels", **c})
    t1 = time.perf_counter()
    shard_timing = shard_kernel_timings(device, args.seed, flush)
    t2 = time.perf_counter()
    long_k3 = long_stats(device, args.seed, flush)
    emit({"phase": "kernels", "timings": {"sharded": shard_timing},
          "long_500k_statistics_form": long_k3,
          "sharded_seconds": {"checks": t1 - t0, "timings": t2 - t1,
                              "long_500k": time.perf_counter() - t2}})

    t0 = time.perf_counter()
    stream = make_stream(args)
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "stages": STAGES, "rows_per_stage": ROWS,
          "fill_payload_bytes": sum(map(len, stream["fill"])),
          "ticks": args.ticks,
          "fresh_rows_per_stage_per_tick": FRESH_SENDERS * FRESH_ROWS})

    bigroots_gates.LAUNCHES = 0
    got, timings, ingest_s, analyzer, agg = drive(
        args, stream, device, "torch", timed=True)
    launches = bigroots_gates.LAUNCHES
    check(launches == args.ticks,
          f"gate kernel launched {launches} times over {args.ticks} ticks")
    last = tuple(t.clone() for t in analyzer.staging.last_inputs())
    for t in timings:
        emit({"phase": "main_path_tick", **t})
    want, _, oracle_ingest_s, _, _ = drive(
        args, stream, torch.device("cpu"), "numpy", timed=False)
    check(bigroots_gates.LAUNCHES == launches,
          "the oracle run launched the kernel")
    summary = compare_runs(got, want, stream)
    emit({"phase": "main_path", "ok": True, "live_rows": agg.num_live_rows,
          "stage_windows": len(agg.store), "fill_ingest_s": ingest_s,
          "oracle_fill_ingest_s": oracle_ingest_s,
          "gate_launches": launches, **summary})

    at_path = hold_against_plain(last, peer_mean, "main path's last batch")
    path_timing = measure(last, peer_mean, flush, replaced)
    del stream, got, want, analyzer, agg, last
    torch.cuda.empty_cache()

    diagnosis = phase_diagnosis(device, flush)
    emit({"phase": "diagnosis_stack", "ok": True, **diagnosis})
    del flush

    serve = {}
    for arch in SERVE_PATHS:
        serve[arch] = phase_serve(args, card, device, arch)
        emit({"phase": "serve_path", "ok": True, **serve[arch]})
        torch.cuda.empty_cache()

    train = {}
    for arch in (MOE_ARCH, SSM_ARCH):
        train[arch] = phase_train(args, card, device, arch)
        emit({"phase": "train_path", "ok": True, **train[arch]})
        torch.cuda.empty_cache()

    served = dict(serve)
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        served[arch] = phase_model_serve(args, card, device, arch)
        emit({"phase": model_phase(served_config(arch)), "part": "serve",
              "ok": True, **served[arch]})
        torch.cuda.empty_cache()
    encdec = served[ENCDEC_ARCH]
    train[ENCDEC_ARCH] = phase_train(args, card, device, ENCDEC_ARCH)
    emit({"phase": "encdec_path", "part": "train", "ok": True,
          **train[ENCDEC_ARCH]})
    torch.cuda.empty_cache()
    ep, ep_ref = phase_ep(args, card, device)
    emit({"phase": "ep_path", "ok": True, **ep})
    torch.cuda.empty_cache()
    parallel, par_ref = phase_parallel(args, device)
    emit({"phase": "parallel", "ok": True, **parallel})
    dist_run = phase_dist(args, card, device, ep_ref, par_ref)
    emit({"phase": "dist_path", "ok": True, **dist_run})
    del ep_ref, par_ref
    torch.cuda.empty_cache()
    shard, shard_serve = phase_shard(args, card, device)
    emit({"phase": "shard_path", "ok": True, **shard})
    emit({"phase": "shard_serve_path", "ok": True, **shard_serve})
    uneven = phase_uneven(args, card, device)
    emit({"phase": "uneven_path", "ok": True, **uneven})
    print(uneven_summary(shard, shard_serve, uneven), flush=True)
    long_run = phase_long(args, card, device)
    emit({"phase": "long_path", "ok": True, **long_run})
    serve_cases = {**shard_serve["cases"], **long_run["cases"]}
    for res in phase_roofline(served, train):
        emit({"phase": "roofline", "ok": True, "gpu": card, **res})
    emit({"phase": "dryrun", "ok": True, **phase_dryrun(dry)})
    examples = phase_examples(device)
    emit({"phase": "examples", "ok": True, "gpu": card, **examples})

    def trained(name: str, arch: str) -> dict:
        """A kernel's launches in ``arch``'s training run, per step, and
        its forward and backward at the training shape."""
        return {"train_path": get_config(arch).name,
                "train_launches": train[arch]["launches"][name],
                "train_launches_per_step":
                    train[arch]["launches_per_step"][name],
                "train_shape": train[arch]["kernels"][name]}

    def sharded(name: str, key: str, arch: str, timed: str) -> dict:
        """A kernel at a ``shard_path`` case's shapes: its launches per
        rank and step, its checks' largest error and its timing there
        (``shard_timing[timed]``)."""
        case = shard["cases"][arch]
        return {"path": case["arch"], "mesh": case["mesh"],
                "launches_per_rank_step": case["launches_per_rank_step"][
                    name],
                "launches_per_rank": case["launches_per_rank_step"][name]
                * SHARD_STEPS,
                "max_abs_err": max(c["max_abs_err"] for c in shard_checks
                                   if c["kernel"] == name
                                   and c["sharded"].startswith(key)),
                **shard_timing[timed]}

    def sharded_serve(name: str, case_key: str, key: str | None = None,
                      timed: str | None = None) -> dict:
        """A kernel in a ``shard_serve_path`` case: its launches per rank
        in the prefill and in a step (rank 0's), its checks' largest
        error at that case's sharded shapes (``key``: their name, or a
        tuple of names) and its timing there."""
        case = serve_cases[case_key]
        out = {"path": case["arch"], "mesh": case["mesh"],
               "layout": case["layout"], "batch": case["batch"],
               "launches_per_rank_prefill":
                   case["launches_prefill_rank0"][name],
               "launches_per_rank_step": case["launches_step_rank0"][name]}
        if key:
            names = (key,) if isinstance(key, str) else key
            out["max_abs_err"] = max(c["max_abs_err"] for c in shard_checks
                                     if c["kernel"] == name
                                     and c["sharded"] in names)
        if timed:
            out.update(shard_timing[timed])
        return out

    def sharded_new(name: str, prefix: str) -> dict:
        """A kernel in the encoder-decoder's sharded cases (``encdec_*``
        shapes) or ``uneven_path``'s (``uneven_*``): its launches a rank
        (rank 0's) in a train step, ``init_cache``, the prefill and a
        step, and its checks' largest error at those shapes."""
        if prefix == "encdec":
            train_case = shard["cases"][ENCDEC_ARCH]
            serve_case = shard_serve["cases"][ENCDEC_ARCH]
        else:
            train_case, serve_case = uneven["train"], uneven["serve"]
        return {"path": train_case["arch"], "mesh": train_case["mesh"],
                "launches_per_rank_train_step":
                    train_case["launches_per_rank_step"][name],
                "launches_per_rank_init_cache":
                    serve_case["launches_init_cache_rank0"][name],
                "launches_per_rank_prefill":
                    serve_case["launches_prefill_rank0"][name],
                "launches_per_rank_step":
                    serve_case["launches_step_rank0"][name],
                "max_abs_err": max(c["max_abs_err"] for c in shard_checks
                                   if c["kernel"] == name
                                   and c["sharded"].startswith(prefix))}

    def entry(name: str, replaces: str, per: str, arch: str, t: dict,
              checked: list) -> dict:
        """One kernel's line: launches from ``arch``'s serving run, the
        largest error of its checks, its timing at that path's shapes."""
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": serve[arch]["launches"][name],
            "launches_per": per, "path": get_config(arch).name,
            "max_abs_err": max(c["max_abs_err"] for c in checked
                               + shard_checks if c["kernel"] == name),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "flops", "bytes",
                                 "round_medians")},
            "replaced_ms": t.get("replaced_ms"),
            "shape": t.get("shape") or t.get("cache") or [t["rows"], t["K"],
                                                          t["N"]],
            "served_launches": {served_config(a).name: r["launches"][name]
                                for a, r in served.items()
                                if r["launches"][name]},
        }

    print(card, flush=True)
    emit({"kernels": [{
        "name": "bigroots_gates", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bigroots_gates.cu",
        "replaces": "src/repro/kernels/bigroots_gates.py:63",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks + [at_path]),
        "ms": path_timing["ms"], "plain_ms": path_timing["plain_ms"],
        "bound_ms": path_timing["bound_ms"],
        "bound_by": path_timing["bound_by"], "library_ms": None,
        "replaced_ms": path_timing.get("replaced_ms"),
        **{k: path_timing[k] for k in (
            "shape", "path", "bytes", "live_rows", "rows",
            "deciding_elements", "pv_sectors", "pv_sectors_all",
            "bytes_live_rows", "bound_live_rows_ms", "bytes_all_rows",
            "bound_all_rows_ms", "round_medians")},
        "in_tick_ms": statistics.median(
            t["gate_kernel_ms"] for t in timings),
        "checks": len(checks) + 1,
        "full_incident": full_timing,
        "diagnosis_stack_launches": {
            name: run["k1_launches"] for name, run in
            [*diagnosis["goldens"].items(), ("scaled", diagnosis["scaled"])]},
        "train_path_launches": {get_config(a).name: t["k1_launches"]
                                for a, t in train.items()},
    }, {**entry("flash_attention", "src/repro/kernels/flash_attention.py:27",
                "one per layer of the prefill", SERVE_ARCH,
                attn_timing["flash_attention"], attn_checks),
        "granite_prefill": attn_timing["flash_attention_granite"],
        "served_prefill": {n: attn_timing[f"flash_attention_{n}"]
                           for n in SERVED_ATTENTION},
        **trained("flash_attention", MOE_ARCH),
        "train_launch": attn_timing["flash_attention_train"],
        "encdec": {
            "path": get_config(ENCDEC_ARCH).name,
            "serve_launches": encdec["launches"]["flash_attention"],
            "per_init_cache": encdec["launches_per_call"]["init_cache"][
                "flash_attention"],
            "per_prefill": encdec["launches_per_call"]["prefill"][
                "flash_attention"],
            "encoder": attn_timing["flash_attention_encoder"],
            "cross": attn_timing["flash_attention_cross"],
            "self": attn_timing["flash_attention_self"],
            "train_launches": train[ENCDEC_ARCH]["launches"][
                "flash_attention"],
            "train_launches_per_step": train[ENCDEC_ARCH][
                "launches_per_step"]["flash_attention"],
            "train_shape": train[ENCDEC_ARCH]["kernels"]["flash_attention"],
            "train_shape_cross": train[ENCDEC_ARCH]["kernels"][
                "flash_attention_cross"]},
        "ep_prefill_launches": ep["launches"]["flash_attention"],
        "dist_prefill_launches_per_rank": dist_run["launches_per_rank"][
            "flash_attention"],
        "sharded": {
            "granite": sharded("flash_attention", "flash_attention_granite",
                               MOE_ARCH, "flash_attention_granite"),
            "glm4": sharded("flash_attention", "flash_attention_glm4",
                            SERVE_ARCH, "flash_attention_glm4")},
        "sharded_serve": {
            "granite": sharded_serve(
                "flash_attention", MOE_ARCH, "serve_flash_attention_granite",
                "serve_flash_attention_granite"),
            "glm4": sharded_serve(
                "flash_attention", SERVE_ARCH, "serve_flash_attention_glm4",
                "serve_flash_attention_glm4")},
        "sharded_serve_fully_seq": {
            "granite": sharded_serve(
                "flash_attention", f"{MOE_ARCH}/fully_seq",
                "fs_flash_attention_granite"),
            "glm4": sharded_serve(
                "flash_attention", f"{SERVE_ARCH}/fully_seq",
                "fs_flash_attention_glm4"),
            "seamless": {
                **sharded_serve("flash_attention", f"{ENCDEC_ARCH}/fully_seq",
                                ENCDEC_FLASH[3:]),
                "launches_per_rank_init_cache": serve_cases[
                    f"{ENCDEC_ARCH}/fully_seq"]["launches_init_cache_rank0"][
                    "flash_attention"],
                **{part: shard_timing[f"fs_encdec_flash_{part}"]
                   for part in ("encoder", "self", "cross")}},
            "seamless_hd": sharded_serve("flash_attention",
                                         f"{ENCDEC_ARCH}/fully_seq_hd"),
            "jamba": sharded_serve(
                "flash_attention", f"{HYBRID_ARCH}/fully_seq",
                "fs_flash_attention_jamba", "fs_flash_attention_jamba"),
            "jamba_hd": sharded_serve(
                "flash_attention", f"{HYBRID_ARCH}/fully_seq_hd",
                "fs_flash_attention_jamba_hd",
                "fs_flash_attention_jamba_hd")},
        "sharded_encdec": {
            **sharded_new("flash_attention", "encdec"),
            **{part: shard_timing[f"encdec_flash_{part}"]
               for part in ("encoder", "self", "cross")}}},
        {**entry("decode_attention",
                 "src/repro/kernels/decode_attention.py:27",
                 "one per layer of every decode step", SERVE_ARCH,
                 attn_timing["decode_attention"], attn_checks),
         "granite_last_step": attn_timing["decode_attention_granite"],
         "served_last_step": {n: attn_timing[f"decode_attention_{n}"]
                              for n in SERVED_ATTENTION},
         "granite_launches": serve[MOE_ARCH]["launches"]["decode_attention"],
         "encdec": {
             "path": get_config(ENCDEC_ARCH).name,
             "serve_launches": encdec["launches"]["decode_attention"],
             "per_step": encdec["launches_per_call"]["decode"][
                 "decode_attention"],
             "cross_last_step": attn_timing["decode_attention_cross"],
             "self_last_step": attn_timing["decode_attention_self"]},
         "sharded_serve": {
             "granite": sharded_serve(
                 "decode_attention", MOE_ARCH,
                 "serve_decode_attention_granite",
                 "serve_decode_attention_granite"),
             "glm4": sharded_serve("decode_attention", SERVE_ARCH)},
         "sharded_serve_fully_seq": {
             "form": "statistics (o, m, l) over each rank's block of "
                     "positions, combined across dp",
             "granite": sharded_serve(
                 "decode_attention", f"{MOE_ARCH}/fully_seq",
                 "fs_decode_stats_granite"),
             "glm4": sharded_serve("decode_attention",
                                   f"{SERVE_ARCH}/fully_seq"),
             "seamless": {
                 **sharded_serve("decode_attention",
                                 f"{ENCDEC_ARCH}/fully_seq",
                                 FS_STATS[1:3]),
                 "self_block": shard_timing["fs_encdec_stats_self"],
                 "cross_block": shard_timing["fs_encdec_stats_cross"]},
             "seamless_hd": sharded_serve("decode_attention",
                                          f"{ENCDEC_ARCH}/fully_seq_hd"),
             "jamba": sharded_serve(
                 "decode_attention", f"{HYBRID_ARCH}/fully_seq",
                 "fs_decode_stats_jamba", "fs_decode_stats_jamba"),
             "jamba_hd": sharded_serve("decode_attention",
                                       f"{HYBRID_ARCH}/fully_seq_hd"),
             "long_500k": {"block": long_k3["timing"],
                           "max_abs_err": long_k3["max_abs_err"],
                           "combine": long_k3["combine"]}},
         "sharded_encdec": {
             **sharded_new("decode_attention", "encdec"),
             **{part: shard_timing[f"encdec_decode_{part}"]
                for part in ("self", "cross")}}},
        {**entry("ssd_scan", "src/repro/kernels/ssd_scan.py:29",
                 "one per SSM layer of the prefill", SSM_ARCH,
                 moe_ssd_timing["ssd_scan"], moe_ssd_checks),
         "jamba_prefill": moe_ssd_timing["ssd_scan_jamba"],
         **trained("ssd_scan", SSM_ARCH),
         "sharded": sharded("ssd_scan", "ssd_scan", SSM_ARCH, "ssd_scan"),
         "sharded_serve": {**sharded_serve("ssd_scan", SSM_ARCH),
                           "shape_note": "the prefill's block is the "
                                         "sharded step's: timed there"},
         "sharded_serve_fully_seq": sharded_serve(
             "ssd_scan", f"{SSM_ARCH}/fully_seq", "fs_ssd_scan"),
         "sharded_serve_fully_seq_jamba": {
             suffix: sharded_serve("ssd_scan", f"{HYBRID_ARCH}/{case}",
                                   f"fs_ssd_scan_{suffix}",
                                   f"fs_ssd_scan_{suffix}")
             for suffix, case in (("jamba", "fully_seq"),
                                  ("jamba_hd", "fully_seq_hd"))},
         "sharded_uneven": {**sharded_new("ssd_scan", "uneven"),
                            **shard_timing["uneven_ssd_scan"]}},
        {**entry("moe_gmm", "src/repro/kernels/moe_gmm.py:23",
                 "three per MoE layer of the prefill and of every decode "
                 "step", MOE_ARCH, moe_ssd_timing["moe_gmm_prefill"],
                 moe_ssd_checks),
         "library": moe_ssd_timing["moe_gmm_prefill"]["library"],
         "prefill_down_launch": moe_ssd_timing["moe_gmm_prefill_down"],
         "decode_launch": moe_ssd_timing["moe_gmm_decode"],
         "train_launch": moe_ssd_timing["moe_gmm_train"],
         **{n: {k: moe_ssd_timing[f"moe_gmm_{n}_{k}"]
                for k in ("prefill", "prefill_down", "decode")}
            for n in ("olmoe", "jamba")},
         **trained("moe_gmm", MOE_ARCH),
         "backward": {
             "source": "src/repro_torch/kernels/csrc/moe_gmm.cu "
                       "(gmm_dx_bf16, gmm_dw_bf16)",
             "replaces": "the plain version's autograd (no TPU kernel)",
             "train_launches_per_step": train[MOE_ARCH][
                 "backward_launches_per_step"],
             "max_abs_err": {part: max(c[part]["max_abs_err"]
                                       for c in gmm_bwd_checks if part in c)
                             for part in ("dx", "dw")},
             **gmm_bwd_timing},
         "ep": {"path": ep["arch"] + " moe_impl=ep", "shards": EP_SHARDS,
                "prefill_launches": ep["launches"]["moe_gmm"],
                "shard_gate_up": ep["k5_shard"]["gate_up"],
                "shard_down": ep["k5_shard"]["down"]},
         "dist": {"ranks": EP_SHARDS,
                  "prefill_launches_per_rank": dist_run["launches_per_rank"][
                      "moe_gmm"]},
         "sharded": {**sharded("moe_gmm", "moe_gmm", MOE_ARCH,
                               "moe_gmm_gate_up"),
                     "down": shard_timing["moe_gmm_down"]},
         "sharded_serve": {
             **sharded_serve("moe_gmm", MOE_ARCH, "serve_moe_gmm_decode",
                             "serve_moe_gmm_decode_gate_up"),
             "launches_per_rank_run": shard_serve["cases"][MOE_ARCH][
                 "k5_launches_per_rank"],
             "prefill_max_abs_err": max(
                 c["max_abs_err"] for c in shard_checks
                 if c["sharded"] == "serve_moe_gmm_prefill"),
             "prefill_gate_up": shard_timing[
                 "serve_moe_gmm_prefill_gate_up"]},
         "sharded_serve_fully_seq": {
             **sharded_serve("moe_gmm", f"{MOE_ARCH}/fully_seq",
                             "fs_moe_gmm_decode"),
             "launches_per_rank_run": shard_serve["cases"][
                 f"{MOE_ARCH}/fully_seq"]["k5_launches_per_rank"],
             "prefill_max_abs_err": max(
                 c["max_abs_err"] for c in shard_checks
                 if c["sharded"] == "fs_moe_gmm_prefill")},
         "sharded_serve_fully_seq_jamba": {
             suffix: {
                 **sharded_serve("moe_gmm", f"{HYBRID_ARCH}/{case}",
                                 (f"fs_moe_gmm_{suffix}_prefill",
                                  f"fs_moe_gmm_{suffix}_decode")),
                 "launches_per_rank_run": serve_cases[
                     f"{HYBRID_ARCH}/{case}"]["k5_launches_per_rank"],
                 **{k: shard_timing[f"fs_moe_gmm_{suffix}_{k}"]
                    for k in ("prefill_gate_up", "decode_gate_up")},
                 **({"prefill_down": shard_timing[
                     "fs_moe_gmm_jamba_prefill_down"]}
                    if suffix == "jamba" else {})}
             for suffix, case in (("jamba", "fully_seq"),
                                  ("jamba_hd", "fully_seq_hd"))},
         "sharded_ep": {
             "path": f"{shard['cases'][EP_KEY]['arch']} moe_impl=ep",
             "mesh": shard["cases"][EP_KEY]["mesh"],
             "launches_per_rank_step": shard["cases"][EP_KEY][
                 "launches_per_rank_step"]["moe_gmm"],
             "launches_per_rank_prefill": shard_serve["cases"][EP_KEY][
                 "launches_prefill_rank0"]["moe_gmm"],
             "max_abs_err": max(c["max_abs_err"] for c in shard_checks
                                if c["sharded"].startswith("ep_")),
             "gate_up": shard_timing["ep_moe_gmm_gate_up"],
             "down": shard_timing["ep_moe_gmm_down"],
             "prefill_gate_up": shard_timing["ep_serve_moe_gmm_gate_up"]}}],
        "replaced_bodies": replaced.src_dir if replaced else None})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=5,
                    help="driven ticks (the fleet's size is fixed)")
    ap.add_argument("--replaced", metavar="DIR",
                    help="a csrc directory holding the bigroots_gates.cu, "
                         "flash_attention.cu, moe_gmm.cu, "
                         "decode_attention.cu and ssd_scan.cu bodies this "
                         "version replaced: those that differ from the "
                         "current ones are built and timed in turns with "
                         "them (replaced_ms)")
    ap.add_argument("--f32-layers", type=int, default=4,
                    help="depth of the serving paths' float32 variants (the "
                         "bf16 runs are always at full depth)")
    ap.add_argument("--shard", action="store_true",
                    help="only build the kernels, hold them at the sharded "
                         "shapes and run shard_path, shard_serve_path and "
                         "uneven_path (the 16-rank mamba2 pool; bringing up "
                         "the sharded step and serving; the kernels line and "
                         "the ok line are not printed)")
    ap.add_argument("--serve", nargs="+", metavar="ARCH",
                    help="only build the kernels and serve these archs, "
                         "each held to the serving checks (bringing up an "
                         "arch; the kernels line and the ok line are not "
                         "printed)")
    ap.add_argument("--gmm-backward", action="store_true",
                    help="only build the kernels and hold and time K5's "
                         "backward kernels (the kernels line and the ok "
                         "line are not printed)")
    args = ap.parse_args()
    if args.gmm_backward:
        gmm_backward_only(args)
    elif args.serve:
        serve_only(args)
    elif args.shard:
        shard_only(args)
    else:
        run(args)


def gmm_backward_only(args) -> None:
    """``--gmm-backward``: K5's backward checks and timings alone."""
    phase_env()
    device = torch.device("cuda")
    phase_build()
    for c in gmm_backward_checks(device, args.seed):
        emit({"phase": "kernels", **c})
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=device)
    emit({"phase": "kernels", "timings": gmm_backward_timings(
        device, args.seed, flush)})


def shard_only(args) -> None:
    """``--shard``: the kernels at the sharded shapes, then ``shard_path``,
    ``shard_serve_path`` and ``uneven_path`` alone."""
    card = phase_env()
    device = torch.device("cuda")
    phase_build()
    for c in shard_kernel_checks(device, args.seed):
        emit({"phase": "kernels", **c})
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=device)
    emit({"phase": "kernels", "timings": {"sharded": shard_kernel_timings(
        device, args.seed, flush)},
        "long_500k_statistics_form": long_stats(device, args.seed, flush)})
    del flush
    torch.cuda.empty_cache()
    shard, shard_serve = phase_shard(args, card, device)
    emit({"phase": "shard_path", "ok": True, **shard})
    emit({"phase": "shard_serve_path", "ok": True, **shard_serve})
    uneven = phase_uneven(args, card, device)
    emit({"phase": "uneven_path", "ok": True, **uneven})
    print(uneven_summary(shard, shard_serve, uneven), flush=True)
    emit({"phase": "long_path", "ok": True,
          **phase_long(args, card, device)})


def serve_only(args) -> None:
    """``--serve``: each named arch's serving phase alone, every one run
    before the first failure is raised."""
    card = phase_env()
    device = torch.device("cuda")
    phase_build()
    failed = []
    for arch in args.serve:
        cfg = served_config(arch)
        try:
            if cfg.enc_layers or cfg.frontend_tokens:
                emit({"phase": model_phase(cfg), "part": "serve", "ok": True,
                      **phase_model_serve(args, card, device, arch)})
            else:
                emit({"phase": "serve_path", "ok": True,
                      **phase_serve(args, card, device, arch)})
        except RuntimeError as e:
            failed.append(str(e))
        torch.cuda.empty_cache()
    check(not failed, "; ".join(failed))


if __name__ == "__main__":
    main()
