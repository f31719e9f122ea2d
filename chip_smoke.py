#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. build    — compile every CUDA source of src/repro_torch/kernels/csrc
                (sm_90a), one nvcc per source, all started together; print
                each build time, the card, and ptxas's registers and spills
                for each kernel instance; check the wrappers' constants
                against their builds' (the scan's d_state sizes and lanes).
  2. kernels  — the per-example squared-norm kernels against their plain
                PyTorch versions on the card (f32 rtol 1e-5, atol 0: sums
                of up to 3072 squares taken in another order), against
                their exact-order emulator (bitwise), multi-tap against
                chained single-tap launches and against itself (bitwise):
                the main shapes (the single-tap kernel at (256, 3072 |
                2048) and (256, 2048 | 10)), the taps of a
                --model-parallel 4 step, ragged and odd widths, bf16 and
                mixed taps, 33 taps (two launches), bases off 16 bytes.
  3. main     — the paper's trainer through the port's entry point at full
                width (mlp_svhn 3072→2048×4→10, relaxed, ghost, 65,536
                resident examples); every logged loss and √TrΣ finite, the
                multi-tap kernel launched once per step, the plain versions
                never called.
  4. parity   — one scoring pass and one master step of mlp_svhn at full
                width on the card and on the CPU (plain versions) from the
                same params, data and injected sample indices; relative
                error ≤ 1e-4.
  5. times    — median step time (CUDA events), kernel vs plain time at the
                main-path shapes with the L2 cache cold (device time from
                the profiler, split by kernel; the single-tap kernel also
                at the replicated fc4 tap of a --model-parallel 4 step,
                (256, 2048 | 10)), beside the byte bound and the parent
                design's recorded times, and a profiler breakdown of a
                few steps.
  6. ghost    — the ghost-norm Gram kernel against its plain version on the
                card: the tap shapes of the seq-64 LM step, the S = 512
                flash-trainer step and the falcon-mamba ghost step, S = 2048
                (several tiles, the symmetric skip), S = 100 (ragged) and
                ragged widths, x/d types f32/f32, bf16/bf16 and bf16/f32,
                symmetric and not, and a d whose every value rounds to bf16
                the same way; tolerance GHOST_TOL × Σ_st |A_st·B_st| per
                row; two launches bitwise equal; which instance (tensor
                cores or SIMT) each case took; the plain Gram against the
                direct plain version; the wrapper refuses bad input.
  7. lm main  — glm4-9b at full width, depth cut to 4 layers, relaxed,
                ghost, through the train entry point: losses and √TrΣ
                finite, ghost_norm called 8 times a step, every call on
                its tensor-core instance, its plain versions never; median
                step ms and peak memory.
  8. lm parity — glm4-9b at full width, 1 layer, float32: one scoring pass
                and one master step on the card and on the CPU (plain Gram)
                with injected sample indices; relative error ≤ 1e-4.
  9. lm times — ghost_norm vs its plain version (two cuBLAS bmm and a
                reduction) per call of three steps (the seq-64 LM step, the
                S = 512 flash-trainer step, the falcon-mamba ghost step), L2
                cold, CUDA events, beside the byte and operation bounds; a
                profiler breakdown of LM steps.
 10. attn     — (run right after phase 6) the flash-attention forward and
                flash-decode kernels against their plain versions: glm4-9b
                shapes in bf16, ragged S = 100, window 24, decode lengths 0,
                1, the full ring and random ones, a 32k cache, f32 smoke
                shapes, MHA and rep 6; the forward's bf16 (tensor-core)
                kernel also at hd 32 and 64, MHA and rep 64; every decode
                case also in bf16 on the tensor-core instance, held to its
                arithmetic's emulation too
                (ref.decode_attention_split_emulation); f32 within
                2e-5 rel + 2e-6 abs, bf16 within one bf16 ulp; lse against a
                plain logsumexp; two launches bitwise equal; length-0 rows
                zero; refusals.
 11. serve    — glm4-9b at full width and full depth (40 layers, bf16)
                through the serve entry point: batch 8, prompt 2048, 64
                greedy steps, max_len 2112, default --kernel, every plain
                version forbidden; the decode steps replay one captured
                CUDA graph (serving/engine.py::make_decode_runner), after
                2 eager warm-up steps; flash_attention 40 launches, decode
                40 a step (replays counted by the runner), all of their
                tensor-core kernels; prefill ms, capture ms, median decode
                step ms, tok/s, peak memory.  Then, from one cloned state,
                a replayed step against an eager one (logits, lengths and
                caches bitwise, or the logits within 1e-4, reported); and
                the eager and the graphed step in turns: median ms (CUDA
                events) and a profiler window each (idle share).
 12. batcher  — ContinuousBatcher on the same params, kernel route, 8 slots,
                16 requests (prompts 17–600, 8–48 new tokens, seeded): all
                finish; decode steps and prefill shapes.
 13. serve parity — glm4-9b at full width, 1 layer, f32: a (2, 64) prefill
                and 4 teacher-forced decode steps, card (kernels) vs CPU
                (plain route), logits and caches; relative error ≤ 1e-4.
 14. serve times — each kernel vs its plain version and SDPA at the main
                path's shapes and a 32k decode cache, L2 cold, beside the
                bound (the forward: CUDA events, achieved TFLOP/s; decode:
                device time from the profiler beside the eager loop's wall
                time).
 15. flash bwd — the flash-attention backward kernel (without and with the
                score) and the score sweep against their plain versions:
                the glm4-9b trainer's shape (16, 512, 32/2 heads, 128) in
                bf16, ragged S = 100, window 24 and 1, f32 smoke shapes,
                MHA, rep 6, hd 32/64/128, and the bf16 (tensor-core)
                kernels also at hd 32 and 64, MHA and rep 64; f32 gradients
                within rtol 1e-4 /
                atol 1e-5, bf16 within that plus half a bf16 ulp; scores
                within rtol 1e-4; fused == sweep bitwise (f32); the f32
                sweep == its exact-order plain version bitwise, the bf16
                sweep == its emulator (ref.attn_score_sweep_bf16_blocked)
                bitwise, within rtol 1e-5 of the oracle and the plain
                version, and bitwise the same from copies off 16 bytes;
                two launches bitwise equal; the autograd Functions against
                autograd through the plain oracle; refusals.
 16. lm flash main — glm4-9b at full width, 4 layers, seq 512, batch and
                score batch 16, bf16, relaxed, ghost, through
                launch/train.py's run with attn_impl="flash" (master) and
                attn_scores="fused" (scorer), every plain version
                forbidden: per step 8 flash forward, 8 backward (4 with
                scores), all of the tensor-core kernels, 0 sweep and 5
                ghost_norm launches, all of the tensor-core instance;
                losses and
                √TrΣ finite; median step ms, peak memory.  Then 3 steps
                with attn_scores="separate": 4 sweeps a step.
 17. lm flash parity — glm4-9b at full width, 1 layer, f32, seq 128: the
                fused, separate and exact flash scoring passes and a flash
                master step, card vs CPU, relative error ≤ 1e-4; fused ==
                separate bitwise on both.
 18. lm flash times — the backward (with and without scores) and the
                sweep at the main shape, L2 cold, CUDA events (the sweep
                also device time from the profiler, split by kernel),
                beside the bound, the plain version and (backward) autograd
                through SDPA, with the backward's achieved TFLOP/s; the fused,
                separate and exact scorers; a profiler window over steps of
                the fused path (idle share).
 19. scan     — the selective-scan kernel against its plain version on the
                card: falcon-mamba-7b's scoring shape (8, 2048, 8192, 16) in
                bf16 with B and C column slices of the x_proj output and a
                falcon-init Δ, ragged S and d_inner in bf16 and f32, f32
                smoke shapes, d_state 8 and 4 (also at a ragged and an odd
                d_inner), f32 at falcon init over S = 2048, |Δ·A| up to 100
                (decays flushed to 0), B and C slices at odd columns (bases
                off 16 bytes); each case prints its lanes a channel
                (L); f32 within rtol 1e-5 and an
                atol of 1e-5 of the largest output, bf16 within one bf16 ulp
                of the plain version's f32 result (plus that atol); two
                launches bitwise equal; refusals (dtypes, shapes, layouts,
                CPU/CUDA mix, autograd).
 20. mamba main — falcon-mamba-7b at full width, depth cut to 10, bf16,
                through launch/train.py's run: (a) logit_grad scorer with
                ssm_mode="pallas" under every plain version forbidden, 10
                scan launches a scoring pass, the master on the ref scan;
                (b) the ghost scorer with ssm_mode="ref", 4 ghost_norm
                launches a step (in_proj, x_proj, out_proj, unembed), all
                of the tensor-core instance, no scan launch; (c) the build's logit_grad/pallas scorer alone
                at full depth (64 layers, 7.27 B params): one pass over 8 ×
                2048 tokens, 64 scan launches.  Step ms, pass ms, peak memory.
 21. mamba parity — falcon-mamba-7b at full width, 1 layer, f32: a
                logit_grad/pallas scoring pass, a ghost/ref scoring pass and
                a master step, card vs CPU; relative error ≤ 1e-4.
 22. mamba times — the scan kernel at the full-depth pass's shape and at
                the trainer's (16, 256, 8192, 16), with its L, L2 cold, CUDA
                events, beside its plain version and its bound (exponentials
                over the SFU rate vs bytes); a profiler window over a step
                of 20a's trainer cut to 2 layers.
 23. fused    — mlp_svhn at full width (65,536 examples) through the train
                entry point with --mode fused --probe-every 8, 40 steps,
                every plain version forbidden: losses and √TrΣ finite, the
                multi-tap kernel launched once a probe and never in a fused
                step; step by step, the rows sampled at step i stamped i;
                one fused step and one probe, card vs CPU (≤ 1e-4); a
                write_scores_global of 64 writes over 8 rows last-write-wins,
                bitwise as the CPU and run to run; the median fused-step,
                probe and relaxed-step ms (CUDA events).
 24. ghost_rev — glm4-9b at full width on the flash path (seq 512, score
                batch 16): (a) at 4 layers, ghost_rev against ghost with
                attn_scores "fused" then "separate" (relative error ≤ 1e-4),
                each scorer's pass ms and peak memory, ghost_rev's launches
                (4 ghost_norm a period + the unembed, 2 flash forward and 1
                backward a layer, the sweeps with "separate"); (b) one
                ghost_rev pass at full depth, 40 layers: scores finite and
                positive, 161 ghost_norm, 80 flash forward and 40 scored
                backward launches, all tensor-core, pass ms and peak
                memory; (c) --strategy ghost_rev through the train entry
                point at phase 7's cut, 29 ghost_norm launches a step.
 25. checkpoint — mlp_svhn relaxed at full width: 10 steps against 5,
                save, restore into a template of another seed, 5 more:
                params, stale params, store, step and the draws bitwise;
                a glm4-9b period's bf16 params round trip bitwise on the
                card; save and restore seconds, file sizes.
 26. asgd     — the ASGD baseline's §6 issgd mode at full width, delay 4,
                20 steps: finite losses; drawn rows written last-write-wins;
                one step card vs CPU from the state reached, the same
                draws (≤ 1e-4).
 27. telemetry — mlp_svhn at full width, relaxed, ghost, 40 steps through
                the train entry point: telemetry off, then --monitors all
                with --metrics-jsonl every 10 steps, median step ms of each;
                params and store bitwise equal; the five monitors of the
                store reached, card vs CPU (≤ 1e-5 relative); the JSONL
                read back by tools/metrics_report.py (its trajectory the
                run's metrics records); a --profile-dir window over steps
                2-3 whose trace names the multi-tap kernel, with its
                profile start/stop records.
 28. strategies — --adaptive-is --adapt-every 10 for 60 steps with a JSONL:
                replay_decisions over the file equals the live decisions;
                the gate closed against --mode uniform and open against
                relaxed, 10 steps each, draws and state bitwise; ghost,
                upper_bound, bandit_mixed and null: median step ms and a
                scoring pass's launches (1, 0, 0, 0 multi-tap); glm4-9b at
                phase 7's cut with --proposal-strategy upper_bound
                --monitors all (no kernel launch), its step ms beside
                phase 7's ghost step.
 29. large tables — the draws' CDF scan (sampler.cumsum) bitwise the same
                over 200 repeats of a one-row scan of 65,536 and 2^20 rows,
                beside how many of torch.cumsum's differ; the mlp_svhn
                trainer with --table-dtype int8
                --index-chunk-size 1024 --score-ttl 20, 40 steps, --index
                tree against dense bitwise; then N = 2^30 rows (chunk
                1024): the f32, bf16 and int8 table bytes, read_proposal,
                build_index, a refresh of 8 written chunks against a
                rebuild (bitwise; and how many of those chunks torch.sum
                would have summed differently), 256 indexed draws against
                the dense two-stage draw over read_proposal, one int8
                write of 256 rows (a whole-table requantize), the measured
                TV of bf16 and int8 against quantization_tv_bound, and the
                peak memory (< 70 GiB).
 30. minicpm3 — minicpm3-4b (MLA) at full width and full depth (62
                layers, bf16) through the train entry point with
                --strategy ghost_rev, seq 64, batch 32, score batch 128:
                losses finite, 8 ghost_norm launches a layer and 1 for the
                unembed a step, how many of them tensor-core and which
                instance each tap width took; step ms, peak memory.  At 4
                layers ghost_rev against ghost (relative error ≤ 1e-4);
                one MLA layer, the loss and the ghost scores of a 1-layer
                f32 model, card vs CPU (≤ 1e-4).
 31. dbrx, jamba — dbrx-132b at full width, 2 layers, the flash path with
                the fused score, relaxed, ghost, seq 128: launches a step
                (4 flash forward, 4 backward of which 2 scored, 2
                ghost_norm; the MoE router's tap takes the direct path, the
                only plain path allowed), all tensor-core; step ms, peak
                memory, the dropped share of replicas; its attention shapes
                (48/8 heads of 128, a GQA group of 6) against the plain
                versions; two steps from one state and one draw bitwise
                equal; a profiler window and the expert bmms' sizes; one
                MoE layer in f32, card vs CPU (≤ 1e-4), expert ids and kept
                mask equal.  Then jamba-v0.1-52b at full width in its smoke
                layout (l0 mamba+MLP, l1 attention+MoE): a logit_grad
                trainer with ssm_mode="pallas" (1 scan launch a step) and a
                ghost trainer on the ref scan and flash attention.
 32. musicgen — musicgen-medium at full width and full depth (48 layers),
                64 seeded conditioning embeds before 64 tokens, score
                batch 16: logit_grad, ghost and ghost_rev (flash) passes
                with their launches, ghost_rev against ghost (≤ 1e-4), the
                fused objective's score equal to logit_grad's; then the
                trainer on tokens alone.
 33. serve falcon-mamba — falcon-mamba-7b at full width and full depth (64
                layers, bf16) through the serve entry point, every plain
                version forbidden: batch 8, prompt 1024, 64 graphed steps
                (no kernel on this path: the prefill scans with the
                oracle, as the reference's collector does, and decode
                steps the state); graphed == eager bitwise (logits,
                lengths, caches) from one cloned state after the runner's
                warm-up; eager and graphed step ms and idle shares.  Then
                the batcher: 16 requests through 8 slots, bucketed
                pad-masked prefills; at prompts of 115 and 282 tokens the
                bucketed state against the unpadded one's, measured
                (bitwise or not, by layer).
 34. serve jamba — jamba-v0.1-52b at full width, one published period (8
                layers: mamba at 0–3 and 5–7, GQA at 4, MoE at 1, 3, 5,
                7), prompt 2048: flash_attention 1 a prefill and
                decode_attention 1 a token step, all tensor-core (rep 4);
                graphed == eager bitwise; the step's device time split
                into the dropless expert bmms, the other GEMMs and the rest.
 35. serve minicpm3 — minicpm3-4b (MLA) at full depth (62 layers), prompt
                2048: the materialised MLA prefill, the absorbed decode
                over the compressed cache; graphed == eager bitwise.
 36. serve musicgen — musicgen-medium at full depth (48 layers), 64
                embeds before a 1024-token prompt: flash_attention 48 a
                prefill, decode_attention 48 a token step (MHA, hd 64),
                all tensor-core; graphed == eager bitwise.  Phase 10 holds
                both kernels at jamba's and musicgen's served shapes first.
 37. serve parity — full width, 1 layer, f32: a falcon-mamba layer (also
                its bucketed prefill's state against the unpadded one's on
                the card), a minicpm3 MLA layer and a jamba mamba+MoE layer
                (experts cut to 4), a (2, 64) prefill and 4 decode steps,
                card vs CPU ≤ 1e-4 with identical expert ids; minicpm3 × 2
                with sliding window 8 decoding past the ring's wrap, card
                vs CPU and each against its windowed forward.
 38. async     — mlp_svhn at the paper's width (65,536 resident examples),
                --async-scoring at swap cadence 1 and 4, 40 steps, the
                scoring pass on its own CUDA stream: median step ms beside
                the relaxed step's in the same call; one multi-tap launch a
                step, on the scoring stream; each run bitwise the port's
                relaxed master fed the store as written through step
                K⌊t/K⌋ − 1 (draws, losses, params, both buffers); a
                profiler window: idle share and the overlap share (time
                with kernels on both streams at once over time with one).
 39. streaming — mlp_svhn at the paper's width over 524,288 examples (6 GiB
                of f32 rows) in pinned host chunks of 1,024 rows behind a
                window of 64 chunks (1/8 of the data): sync, then async at
                swap cadence 4, 40 steps each, against the resident runs of
                the same compositions, bitwise (draws, losses, params,
                store); step ms, hit rate, misses, streamed rows, peak GiB,
                and the host→device GB/s of a 256-row fetch and of a window
                built from the host.  Halved, with the cut printed, if the
                host cannot pin it.
 40. serve loop — glm4-9b at phase 7's cut, streamed, async at swap cadence
                2, 24 steps without and with the serve loop (8 slots,
                prompts of 64, 16 new tokens, 2 decodes a tick, the
                kernels' route, every plain version forbidden): step ms,
                ghost_norm 8 a step all on the scoring stream,
                flash_attention 4 a prefill and decode_attention 4 a decode
                (all tensor-core), rows ingested, dropped and live, peak
                GiB, a profiler window with the overlap share; a prefill and
                2 decode steps against the published snapshot bitwise those
                against an explicit copy of the params of its step.
 41. planes parity — f32 smoke widths, card vs CPU from the same params,
                data and uniforms: 4 async steps at swap cadence 2, 3
                streamed sync steps, two serve ticks with an ingest; draws,
                finished tokens and live rows equal, values within 1e-5.
 42. sharded  — the sharded ISSGD step over torch.distributed: (a) world 1
                over NCCL on cuda:0 through --mesh 1 against the one-device
                step of the same call, mlp_svhn at full width (W = 4, 40
                steps) and glm4-9b at phase 7's cut (4 steps), bitwise
                (draws, metrics, params, stale params, store), every plain
                version forbidden: 1 multi-tap launch a step, 8 ghost_norm
                (all tensor-core), the all-reduces and their elements a
                step, both step times; a 256-row ghost scoring batch
                against two of 128, the GEMMs over the batch (other bits)
                and one a shard's slice (the launcher's row block: the same
                bits); (b) world 2 on the one card, two spawned ranks over
                a gloo group on CUDA tensors, the same mlp_svhn run: every
                step's draws, losses, grad norms and Σw, the final store and
                params bitwise (a)'s, the trace monitors within 1e-5;
                32,768 rows of the store and the data a rank, no tensor of
                65,536 rows in a step recorded op by op, 1 multi-tap launch
                a step a rank; the hierarchical draw over the group bitwise
                the one-device draw of the same table (4,096 draws); the
                step time, shared between the two processes; --mesh past
                the card count refused, naming it.
 43. sharded planes — the planes over torch.distributed, every plain
                version forbidden: (a) phase 39's streamed mlp_svhn
                (524,288 rows in pinned chunks of 1,024, score batch
                4,096, W = 4, 40 steps), sync and async (swap 4), through
                --mesh 1 over NCCL against the one-device run of the same
                call, bitwise (draws, losses, grad norms, Σw, both
                buffers, params, stale params); step ms of both, hit rate,
                all-reduces and elements a step, 1 multi-tap launch a step
                (async: on the scoring stream); (b) a world of 2 over gloo
                on the one card, streamed async, 262,144 rows a rank in its
                own pinned chunks behind a window of 32: bitwise (a)'s
                async run, no 524,288-row tensor in a recorded step, no
                foreign chunk held or served, the scoring kernel on each
                rank's side stream, a gather-free checkpoint saved at step
                20 (save s, file MB); (c) the one-device streamed async run
                restores that file and runs the last 20 steps: bitwise
                (b)'s uninterrupted 40; (d) glm4-9b at phase 7's cut
                through --mesh 1 --stream --async-scoring --swap-every 2,
                4 steps, bitwise the one-device run, 8 ghost_norm launches
                a step, all on the scoring stream and tensor-core; the LM
                row blocks: phase 7's cut as a resident world of 2 on the
                one card at W = 2 draws what one device draws (16
                ghost_norm launches a step there, 8 a rank).
 44. model parallel — --model-parallel over gloo ranks sharing the one
                card (no speed figure: per-rank launches, model-axis
                all-reduces and bytes a step, peak GiB), every plain
                version forbidden: (a) phase 3's mlp_svhn at W = 4, 20
                relaxed steps at (data, model) = (1, 4), (1, 2) and (2, 2)
                against one device in the same call (its draws for the
                first 5 steps or more, losses within 1e-4), the (2, 2)
                world bitwise the (1, 2) one, a model group's ranks alike;
                a step a rank 1 multi-tap launch and 1 single-tap launch at
                M = 4 (the replicated 10-class tap), 0 at M = 2; 4 async
                and 4 streamed steps at M = 2; (b) glm4-9b at phase 7's
                cut at M = 2 and a score batch of 32 (two ranks on the
                card each hold the gathered unembed tap), sequence
                parallel on and off, 8 ghost_norm launches a step a
                rank, all tensor-core, the
                scored rows' ω̃ within 5e-2 of one device's (bf16) and of
                each other, and one flash
                attn_scores="fused" step at phase 16's seq 512, batch
                4; (c)
                falcon-mamba-7b × 2, dbrx-132b × 1, minicpm3-4b × 2 and
                jamba in phase 31's layout, 2 relaxed steps each, the same
                checks (the MoE archs at the median, at most a quarter
                of the rows beyond 5e-2: top-k routing flips near ties
                under bf16 reassociation); (d) the M = 2 mlp_svhn run's gather-free file
                restored on one device, bit for bit its shards.
 45. serving groups — serving on the (data, model) groups, ranks sharing
                the one card over gloo, every plain version forbidden: (a)
                glm4-9b at full width cut to 4 layers, bf16, 16 requests of
                seeded lengths through 8 slots of the model-group batcher
                at (data, model) = (1, 2) and (2, 2) against the
                one-device batcher: teacher-forced logits within 2e-2, the
                share of greedy tokens that agree, data world 2 bitwise
                data world 1, a model group's ranks alike, 4
                flash_attention launches a prefill and 4 decode_attention
                a token step a rank (16/1 local heads), all tensor-core;
                (b) glm4-9b's cut streamed async with and without the
                serve loop through --mesh 1 over NCCL and --mesh 1
                --model-parallel 2 over gloo: rows ingested and live, step
                ms; (c) sharded_decode_attention over 2 and 4 ranks at
                glm4-9b's decode shape (8 × 32,768 slots) and one
                524,288-slot sequence against the plain f32 oracle (rtol
                2e-5, atol 2e-6), the decode kernel's error beside it; (d)
                minicpm3-4b × 2, falcon-mamba-7b × 2, jamba in phase 31's
                layout and dbrx-132b × 1 through the (1, 2) batcher,
                teacher-forced logits against one device's (the MoE archs
                at the median row).
 46. dry run on the card — rank 0 of launch/dryrun.py's 16×16 layout run
                for real on the card (the fake backend on CUDA tensors):
                glm4-9b decode_32k and deepseek-7b at seq 512, batch 32;
                the fake run's argument bytes equal to the real tensors',
                its peak beside torch.cuda.max_memory_allocated.  The
                train step is the batch-split master, as the reference's
                dry run has it: rank 0 trains on its 2 of the 32 rows.
 47. remat    — ModelConfig.remat (on by default since this phase, so
                every earlier training phase remats, each trained flash
                forward launched once more in its backward): (a) one
                trainer step with remat off and on from the same state
                and draws, after a warm-up step, at the cuts of phases 7
                (glm4-9b × 4, ghost), 16 (the flash trainer, fused and
                separate), 20 (falcon-mamba-7b × 2, ghost on the ref
                scan), 30 (minicpm3-4b × 2, ghost) and 31 (dbrx-132b × 1,
                flash): loss, scores and new params bitwise equal, every
                kernel's launches equal but flash_attention's, doubled;
                peak GiB, step ms; (b) the depths remat opens, a warm-up
                and a timed step each: glm4-9b at its full 40 layers at
                the flash trainer's shape with ghost_rev, falcon-mamba-7b
                at its full 64 with the logit_grad scorer on the scan
                kernel and the master on the ref scan; peak GiB, a finite
                loss, every weight moved; (c) phase
                46's train shape, which now remats: the dry run's peak
                within 0.1 GiB of the allocator's.
 48. batch split — the batch-split master (make_sharded_train_step(...,
                split_batch=True), the reference's constrain_batch; off
                by default, so every earlier phase runs the unsplit
                step): a world of 2 ranks sharing the card over gloo on
                CUDA tensors, each rank training on its half of the
                minibatch and the gradients summed over the ranks, every
                plain version forbidden, against the one-device run of
                the same call: (a) mlp_svhn at full width, relaxed,
                ghost, W = 4, 10 steps; (b) glm4-9b at phase 7's cut on
                the flash path with the fused score at phase 16's shape,
                W = 2, 2 steps; (c) dbrx-132b × 1, capacity drops on, the
                routing the whole minibatch's (BatchSplit), W = 2, 2
                steps.  The draws equal one device's until the first
                refresh, the losses and grad norms within 1e-4 (f32) or
                5e-2 (bf16; dbrx's dropped shares and scored rows at the
                median, at most a quarter beyond), the ranks alike, two
                split runs bitwise equal; a rank's master at its B/2
                rows; launches a step a rank: 1 multi-tap (a), 16 flash
                forward, 8 backward (4 scored) and 5 ghost_norm (b), half
                one device's scorer launches (b, c), every tensor-core
                kernel on its tensor-core instance; the gradient
                all-reduces a step counted.
Then the card line, the kernels line, and last {"ok": true, "device": ...}.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

# --- the main path's scoring shapes: five fc taps of mlp_svhn at B=256
MAIN_B = 256
MAIN_TAPS = ((3072, 2048), (2048, 2048), (2048, 2048), (2048, 2048),
             (2048, 10))
KERNEL_RTOL = 1e-5       # f32 sums of ≤3072 squares in another order
CARD_VS_CPU_RTOL = 1e-4  # full-width f32 matmuls on card vs CPU
MAIN_STEPS = 40
WARMUP_STEPS = 5
# H100 SXM data sheet (hopper-kernels guide §1): HBM rate, f32 non-tensor
# peak, dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2**20
SOURCES = {
    "per_example_sqnorm_multi":
        "src/repro_torch/kernels/csrc/per_example_sqnorm.cu",
    "per_example_sqnorm": "src/repro_torch/kernels/csrc/per_example_sqnorm.cu",
    "ghost_norm": "src/repro_torch/kernels/csrc/ghost_norm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "flash_attention_bwd":
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "attn_score_sweep": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "selective_scan": "src/repro_torch/kernels/csrc/selective_scan.cu",
}
REPLACES = {
    "per_example_sqnorm_multi": "src/repro/kernels/per_example_sqnorm.py:128",
    "per_example_sqnorm": "src/repro/kernels/per_example_sqnorm.py:52",
    "ghost_norm": "src/repro/kernels/ghost_norm.py:73",
    "flash_attention": "src/repro/kernels/flash_attention.py:81",
    "decode_attention": "src/repro/kernels/decode_attention.py:59",
    "flash_attention_bwd": "src/repro/kernels/flash_attention_bwd.py:166",
    "attn_score_sweep": "src/repro/kernels/flash_attention_bwd.py:314",
    "selective_scan": "src/repro/kernels/selective_scan.py:56",
}

# --- the LM path: glm4-9b at full width, depth cut to LM_LAYERS
LM_LAYERS = 4
LM_STEPS = 12
LM_WARMUP = 2
LM_ARGV = ["--arch", "glm4-9b", "--mode", "relaxed", "--strategy", "ghost",
           "--seq", "64", "--batch", "32", "--score-batch", "128",
           "--examples", "8192", "--lr", "0.01", "--refresh-every", "8",
           "--device", "cuda"]
LM_SB, LM_S = 128, 64
# its ghost_norm calls a step: (name, rows, S, din, dout); the layer taps
# cover P·B = 4·128 rows, the unembed B = 128 (glm4-9b: d_model 4096,
# 32 heads and 2 KV heads of 128, d_ff 13696, vocab 151552)
GHOST_MAIN = (
    ("wq", LM_LAYERS * LM_SB, LM_S, 4096, 4096),
    ("wk", LM_LAYERS * LM_SB, LM_S, 4096, 256),
    ("wv", LM_LAYERS * LM_SB, LM_S, 4096, 256),
    ("wo", LM_LAYERS * LM_SB, LM_S, 4096, 4096),
    ("w_in", LM_LAYERS * LM_SB, LM_S, 4096, 13696),
    ("w_gate", LM_LAYERS * LM_SB, LM_S, 4096, 13696),
    ("w_out", LM_LAYERS * LM_SB, LM_S, 13696, 4096),
    ("unembed", LM_SB, LM_S, 4096, 151552),
)
# f32 Gram sums over up to 151,552 features and S² (s, t) terms, taken in
# another order than cuBLAS's: the error of a row is held against the
# magnitude of the terms it sums, Σ_st |A_st·B_st| (equal to the value
# when there is no cancellation)
GHOST_TOL = 1e-4

# --- the serve path: glm4-9b at full width and full depth (40 layers)
SERVE_B, SERVE_PROMPT, SERVE_STEPS = 8, 2048, 64
SERVE_MAX = SERVE_PROMPT + SERVE_STEPS
SERVE_ARGV = ["--arch", "glm4-9b", "--batch", str(SERVE_B), "--prompt-len",
              str(SERVE_PROMPT), "--steps", str(SERVE_STEPS), "--max-len",
              str(SERVE_MAX), "--device", "cuda"]
LONG_S = 32768           # the long-cache decode shape
BATCHER_SLOTS, BATCHER_REQUESTS, BATCHER_MAX_LEN = 8, 16, 1024
BATCHER_PROMPT, BATCHER_NEW = (17, 600), (8, 48)
# attention kernel vs plain: f32 at the JAX kernel tests' bound (the same
# f32 online softmax in another order); bf16 outputs compared in bf16, where
# two f32 results that differ in their last bits may round to neighbouring
# bf16 values, one bf16 ulp (at most 2^-7 of the value) apart
ATTN_F32 = dict(rtol=2e-5, atol=2e-6)
ATTN_BF16 = dict(rtol=2 ** -7, atol=1e-5)

# --- the trainable flash path: glm4-9b at full width, depth cut to
# LM_LAYERS, seq 512; the master on attn_impl="flash", the scorer on
# attn_impl="flash", attn_scores="fused"
FLASH_B, FLASH_S = 16, 512
FLASH_STEPS, FLASH_WARMUP, FLASH_SEP_STEPS = 12, 2, 3
FLASH_ARGV = ["--arch", "glm4-9b", "--mode", "relaxed", "--strategy",
              "ghost", "--seq", str(FLASH_S), "--batch", str(FLASH_B),
              "--score-batch", str(FLASH_B), "--examples", "4096", "--lr",
              "0.01", "--refresh-every", "8", "--device", "cuda"]
# its ghost_norm calls a step, as GHOST_MAIN: the score tap replaces the
# wq/wk/wv Grams; the layer taps cover P·B = 4·16 rows, the unembed B = 16
FLASH_GHOST = (
    ("wo", LM_LAYERS * FLASH_B, FLASH_S, 4096, 4096),
    ("w_in", LM_LAYERS * FLASH_B, FLASH_S, 4096, 13696),
    ("w_gate", LM_LAYERS * FLASH_B, FLASH_S, 4096, 13696),
    ("w_out", LM_LAYERS * FLASH_B, FLASH_S, 13696, 4096),
    ("unembed", FLASH_B, FLASH_S, 4096, 151552),
)
# kernel 5 against its plain version: f32 gradients at the reference's own
# bound for its backward (tests/test_kernels.py); bf16 gradients against the
# plain version's f32 gradients (inputs upcast exactly) at that bound plus
# the cast's rounding, half a bf16 ulp (2^-8 of the value).  Scores are sums
# of squares (no cancellation): rtol 1e-4.
BWD_F32 = dict(rtol=1e-4, atol=1e-5)
BWD_BF16 = dict(rtol=2 ** -8 + 1e-4, atol=1e-5)
SCORE_RTOL = 1e-4
# bf16: the sweep squares the cast gradients, each within 2^-8 of the f32
# value the fused epilogue squares, so the sums differ by < 2^-7 of the sum
SWEEP_BF16_RTOL = 2 ** -7
# the bf16 sweep against the oracle and the plain version on the same bf16
# gradients: sums of the same squares in other orders
SWEEP_RTOL = 1e-5

# --- the mamba path: falcon-mamba-7b at full width (d_model 4096, d_inner
# 8192, d_state 16, dt_rank 256, vocab 65024, bf16), depth cut to
# MAMBA_LAYERS for the trainer: without remat the deepest whose ghost leg
# stayed under 70 GiB, as autograd kept each layer's ref-scan graph, ~5.9
# GiB a layer at these sizes (tools/torch_mamba_depth_probe.py); with
# remat phase 47 trains all 64; seq 256 keeps every ghost tap on the Gram
# path (x_proj: S·(8192 + 288) ≤ 8192·288 needs S ≤ 278)
MAMBA_LAYERS = 10
MAMBA_PROFILE_LAYERS = 2   # phase 22's profiler window: its events cost time
MAMBA_S, MAMBA_B, MAMBA_SB = 256, 8, 16
MAMBA_STEPS, MAMBA_GHOST_STEPS, MAMBA_WARMUP = 6, 4, 1
MAMBA_ARGV = ["--arch", "falcon-mamba-7b", "--mode", "relaxed", "--seq",
              str(MAMBA_S), "--batch", str(MAMBA_B), "--score-batch",
              str(MAMBA_SB), "--examples", "2048", "--lr", "0.01",
              "--refresh-every", "8", "--device", "cuda"]
# its ghost_norm calls a step, as GHOST_MAIN: one per tap name over all
# P·B = 10·16 rows (x_proj: dt_rank 256 + 2 d_state), the unembed B = 16
MAMBA_GHOST = (
    ("in_proj", MAMBA_LAYERS * MAMBA_SB, MAMBA_S, 4096, 16384),
    ("x_proj", MAMBA_LAYERS * MAMBA_SB, MAMBA_S, 8192, 288),
    ("out_proj", MAMBA_LAYERS * MAMBA_SB, MAMBA_S, 8192, 4096),
    ("unembed", MAMBA_SB, MAMBA_S, 4096, 65024),
)
# the three steps whose ghost_norm calls phase 9 times
GHOST_STEPS = {"lm": GHOST_MAIN, "flash": FLASH_GHOST, "mamba": MAMBA_GHOST}
# the full-depth scoring pass and the kernel's main shape
SCAN_B, SCAN_S = 8, 2048
# scan kernel vs plain: the same f32 recurrence with FMA contraction and
# another exp; y sums signed terms over the states, so entries near zero
# are held to an atol of SCAN_RTOL of the largest output
SCAN_RTOL = 1e-5
# H100 SXM: 16 SFU results a clock on each of 132 SMs at the 1.98 GHz boost
# clock (exp is one MUFU op)
SFU_PER_S = 16 * 132 * 1.98e9

# --- slice 11: fused mode with its probe, ghost_rev, checkpoints, ASGD
FUSED_STEPS, FUSED_PROBE = 40, 8
# ghost_rev: glm4-9b at full width, seq 512, score batch 16, flash path;
# held to ghost at the LM_LAYERS cut (the same sums in another order and
# grouping, bf16 operands: within the card-vs-CPU bound), then one pass at
# full depth
REV_B, REV_S = 16, 512
REV_FULL_LAYERS = 40
REV_RTOL = 1e-4
REV_TRAIN_STEPS = 3
CKPT_K = 5
ASGD_DELAY, ASGD_STEPS = 4, 20
# slice 12: telemetry (mlp_svhn full width), the controller and the zoo,
# the billion-row structures
TEL_STEPS = 40
MON_RTOL = 1e-5          # f32 reductions over 65,536 rows, card vs CPU
ADAPT_STEPS, ADAPT_EVERY = 60, 10
GATE_STEPS = 10
ZOO_STEPS = 15
LM_UB_STEPS = 6
BIG_STEPS = 40
BIG_N, BIG_CHUNK, BIG_DRAWS = 2**30, 1024, 256
BIG_PEAK_GIB = 70
SCAN_REPEATS = 200
# slice 13: the rest of the LM zoo at full width.  minicpm3-4b (MLA) at
# full depth through the ghost_rev trainer; its score batch of 128 fits
# (ghost would hold every layer's f32 tap cotangents, ~0.9 GB a layer)
MINI_ARGV = ["--arch", "minicpm3-4b", "--mode", "relaxed", "--strategy",
             "ghost_rev", "--seq", "64", "--batch", "32", "--score-batch",
             "128", "--examples", "4096", "--lr", "0.01", "--refresh-every",
             "8", "--device", "cuda"]
MINI_STEPS, MINI_WARMUP = 3, 1
MINI_CUT, MINI_CUT_B, MINI_CUT_S = 4, 32, 64
# its taps a layer (wq_a, wq_b, wkv_a, wkv_b, wo, w_in, w_gate, w_out)
MLA_TAPS = 8
# dbrx-132b at full width, cut to 2 layers (~6.5 GB of bf16 a layer: the
# params, gradients and new params take ~47 GB at 2 layers, and the f32
# global norm of a 2.1 B-element expert leaf 17 GB more), the flash path
# with the fused score; the params are pushed to the workers every step,
# so the stale params alias them (a stale copy would be 15.5 GB more);
# then jamba-v0.1-52b at full width in its smoke layout
DBRX_LAYERS = 2
DBRX_B, DBRX_S, DBRX_SB, DBRX_N = 16, 128, 32, 2048
DBRX_ARGV = ["--arch", "dbrx-132b", "--mode", "relaxed", "--strategy",
             "ghost", "--seq", str(DBRX_S), "--batch", str(DBRX_B),
             "--score-batch", str(DBRX_SB), "--examples", str(DBRX_N), "--lr",
             "0.01", "--refresh-every", "1", "--device", "cuda"]
DBRX_STEPS, DBRX_WARMUP = 4, 1
JAMBA_ARGV = ["--arch", "jamba-v0.1-52b", "--mode", "relaxed", "--seq",
              "128", "--batch", "8", "--score-batch", "16", "--examples",
              "1024", "--lr", "0.01", "--refresh-every", "8", "--device",
              "cuda"]
JAMBA_STEPS = 2
# musicgen-medium at full width and full depth: 64 conditioning embeds
# before 64 tokens (S = 128), score batch 16
MUSIC_SB, MUSIC_S, MUSIC_FRONT = 16, 64, 64
MUSIC_ARGV = ["--arch", "musicgen-medium", "--mode", "relaxed",
              "--strategy", "ghost", "--seq", "64", "--batch", "16",
              "--score-batch", "32", "--examples", "2048", "--lr", "0.01",
              "--refresh-every", "8", "--device", "cuda"]
MUSIC_STEPS = 3
# slice 14: the rest of the serving engine at full width, bf16, batch 8,
# 64 graphed greedy steps each, through launch/serve.py
ZOO_SERVE_B, ZOO_SERVE_STEPS = 8, 64
FALCON_SERVE_PROMPT = 1024               # falcon-mamba-7b, 64 layers
JAMBA_SERVE_LAYERS, JAMBA_SERVE_PROMPT = 8, 2048   # one published period
JAMBA_SERVE_MAX = JAMBA_SERVE_PROMPT + ZOO_SERVE_STEPS
MINI_SERVE_PROMPT = 2048                 # minicpm3-4b, 62 layers
MUSIC_SERVE_FRONT, MUSIC_SERVE_PROMPT = 64, 1024   # musicgen, 48 layers
MUSIC_SERVE_MAX = MUSIC_SERVE_FRONT + MUSIC_SERVE_PROMPT + ZOO_SERVE_STEPS
# the falcon batcher: 16 requests through 8 slots; its bucketed prefills
# scan with the oracle, S_bucket steps a layer (buckets 32 to 128; prompts
# to 300 took 44 s, the oracle's host loop)
FALCON_BATCHER_PROMPT, FALCON_BATCHER_MAX_LEN = (17, 128), 1024
# the bucketed prefill's state against the unpadded one's at these prompt
# lengths (buckets 128 and 512): on the card the in_proj GEMM may differ
# with the row count
BUCKET_PROBES = (115, 282)
# card vs CPU: a prefill of 64 tokens and 4 decode steps at 1 layer, f32
ZOO_PARITY_B, ZOO_PARITY_S, ZOO_PARITY_STEPS = 2, 64, 4
ZOO_PARITY_EXPERTS = 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_state() -> str:
    """SM clock, power draw and temperature now, as nvidia-smi gives them:
    sampled beside a timing window, since a card under load may run
    below its top clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_taps(b, widths, dtypes, seed, device="cuda"):
    """x ~ N(0,1) activations, d ~ N(0,1)·1e-2 gradients, as given dtypes."""
    g = torch.Generator(device=device).manual_seed(seed)
    xs, ds = [], []
    for (din, dout), (xt, dt) in zip(widths, dtypes):
        xs.append(torch.randn(b, din, generator=g, device=device).to(xt))
        ds.append((torch.randn(b, dout, generator=g, device=device)
                   * 1e-2).to(dt))
    return xs, ds


def off_16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose base is one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a−b| over the largest |b| (per tensor)."""
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / scale if scale else 0.0


def phase_build(_build, card: str) -> dict:
    """Compile every csrc/*.cu, one nvcc each, all started together."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))

    def one(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(one, names)))
    for name in names:
        log = _build.library_path(name).with_suffix(".log")
        ptxas = log.read_text().strip() if log.exists() else "(cached build)"
        print(f"build: {name}.cu in {secs[name]:.2f} s on {card} → "
              f"{log.parent}\n{ptxas}", flush=True)
        for fn, regs, spill_st, spill_ld in ptxas_summary(ptxas):
            print(f"build: {name}.cu {fn}: {regs} registers, spill stores "
                  f"{spill_st} B, spill loads {spill_ld} B", flush=True)
    return secs


def ptxas_summary(log: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill-store bytes, spill-load bytes) for each
    entry function in an ``-Xptxas -v`` log."""
    out, fn, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), *spills))
            fn, spills = None, (0, 0)
    return out


def phase_kernels(pes, ref):
    """Kernel vs plain (rtol), vs emulator and multi vs chained (bitwise)."""
    f32, bf16 = torch.float32, torch.bfloat16
    n_main = len(MAIN_TAPS)
    ragged = ((3072, 2048), (2048, 10), (10, 3072))
    odd = ((1, 3), (777, 1023), (2049, 5))
    cases = [
        ("main", MAIN_B, MAIN_TAPS, ((f32, f32),) * n_main),
        ("ragged_f32", 257, ragged, ((f32, f32),) * 3),
        ("ragged_bf16", 257, ragged, ((bf16, bf16),) * 3),
        ("ragged_mixed", 257, ragged, ((bf16, f32), (f32, bf16), (bf16, f32))),
        ("33_taps", 17, ((40, 24),) * 33, ((f32, f32),) * 33),
        # the taps of a --model-parallel 4 step: four column shards and
        # the replicated 10-class layer
        ("model_parallel_4", MAIN_B,
         tuple((a, b // 4 if b % 4 == 0 else b) for a, b in MAIN_TAPS),
         ((f32, f32),) * n_main),
        ("odd_widths", 33, odd, ((f32, bf16), (bf16, f32), (f32, f32))),
        ("unaligned", 65, odd, ((f32, bf16), (bf16, f32), (f32, f32))),
    ]
    max_err = {"per_example_sqnorm": 0.0, "per_example_sqnorm_multi": 0.0}
    for ci, (name, b, widths, dtypes) in enumerate(cases):
        xs, ds = make_taps(b, widths, dtypes, seed=100 + ci)
        if name == "unaligned":         # bases 2 or 4 bytes off 16
            xs, ds = [off_16(x) for x in xs], [off_16(d) for d in ds]
        for with_bias in (True, False):
            tag = f"{name} with_bias={with_bias}"
            singles = []
            for t, (x, d) in enumerate(zip(xs, ds)):
                k = pes.per_example_sqnorm(x, d, with_bias=with_bias)
                p = ref.per_example_sqnorm_ref(x, d, with_bias=with_bias)
                e = ref.per_example_sqnorm_blocked(x, d, with_bias=with_bias)
                torch.cuda.synchronize()
                if not torch.allclose(k, p, rtol=KERNEL_RTOL, atol=0.0):
                    fail(f"per_example_sqnorm {tag} tap {t}: kernel vs "
                         f"plain rel err {rel_err(k, p):.3e}")
                if not torch.equal(k, e):
                    fail(f"per_example_sqnorm {tag} tap {t}: kernel != "
                         f"exact-order emulator")
                if name == "main":
                    max_err["per_example_sqnorm"] = max(
                        max_err["per_example_sqnorm"],
                        (k - p).abs().max().item())
                singles.append(k)
            km = pes.per_example_sqnorm_multi(xs, ds, with_bias=with_bias)
            km2 = pes.per_example_sqnorm_multi(xs, ds, with_bias=with_bias)
            pm = ref.per_example_sqnorm_multi_ref(xs, ds, with_bias=with_bias)
            em = ref.per_example_sqnorm_multi_blocked(xs, ds,
                                                      with_bias=with_bias)
            chained = singles[0]
            for s in singles[1:]:
                chained = chained + s
            torch.cuda.synchronize()
            if not torch.allclose(km, pm, rtol=KERNEL_RTOL, atol=0.0):
                fail(f"per_example_sqnorm_multi {tag}: kernel vs plain "
                     f"rel err {rel_err(km, pm):.3e}")
            if not torch.equal(km, chained):
                fail(f"per_example_sqnorm_multi {tag}: multi-tap != chained "
                     f"single-tap launches")
            if not torch.equal(km, em):
                fail(f"per_example_sqnorm_multi {tag}: kernel != "
                     f"exact-order emulator")
            if not torch.equal(km, km2):
                fail(f"per_example_sqnorm_multi {tag}: two launches differ")
            if name == "main":
                max_err["per_example_sqnorm_multi"] = max(
                    max_err["per_example_sqnorm_multi"],
                    (km - pm).abs().max().item())
        print(f"kernels: {name} (B={b}, {len(widths)} taps) ok: plain "
              f"rtol {KERNEL_RTOL}, emulator, chained and launch == launch "
              f"bitwise", flush=True)
    # the wrappers refuse what the kernel does not take
    x, d = make_taps(4, ((8, 8),), ((torch.float32, torch.float32),), 1)
    bad = {"float64": (x[0].double(), d[0]),
           "cpu tap": (x[0], d[0].cpu()),
           "non-contiguous": (x[0][:, ::2], d[0]),
           "batch mismatch": (x[0], d[0][:3])}
    for what, (bx, bd) in bad.items():
        try:
            pes.per_example_sqnorm(bx, bd)
        except (TypeError, ValueError):
            continue
        fail(f"per_example_sqnorm accepted a {what} input")
    print(f"kernels: wrappers refuse {', '.join(bad)}", flush=True)
    return max_err


def phase_main(train_mod, pes, gn, ref):
    """The trainer at full width through its entry point."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = run_forbidding_plain(ref, lambda: train_mod.main([
        "--arch", "mlp_svhn", "--mode", "relaxed", "--strategy", "ghost",
        "--batch", "64", "--score-batch", "256", "--examples", "65536",
        "--lr", "0.01", "--refresh-every", "8", "--steps",
        str(MAIN_STEPS), "--device", "cuda"]))
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["per_example_sqnorm_multi"] != MAIN_STEPS:
        fail(f"per_example_sqnorm_multi launched "
             f"{launches['per_example_sqnorm_multi']} times in "
             f"{MAIN_STEPS} steps")
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    for rec in result.history:
        if not all(math.isfinite(rec[k]) for k in keys):
            fail(f"non-finite metrics at step {rec['step']}: {rec}")
    step_ms = statistics.median(result.step_ms[WARMUP_STEPS:])
    print(f"main: {MAIN_STEPS} steps, launches {launches}, loss "
          f"{result.history[0]['loss']:.4f} → {result.history[-1]['loss']:.4f}"
          f", median step {step_ms:.4f} ms, peak memory {peak_gib:.2f} GiB",
          flush=True)
    return launches, step_ms, peak_gib


def phase_parity():
    """One scoring pass + master step, card vs CPU, same inputs."""
    from repro_torch.configs.mlp_svhn import CONFIG as cfg
    from repro_torch.core.issgd import (ISSGDConfig, make_master_pass,
                                        make_scoring_pass)
    from repro_torch.core.scorer import make_mlp_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.data import make_svhn_like
    from repro_torch.models.mlp import init_mlp_classifier, per_example_loss
    from repro_torch.optim import sgd, tree_leaves, tree_map

    n = 4096
    train, _ = make_svhn_like(torch.Generator("cuda").manual_seed(11), n=n,
                              dim=cfg.input_dim)
    params = init_mlp_classifier(torch.Generator().manual_seed(12), cfg,
                                 "cpu")
    idx = torch.randint(0, n, (64,),
                        generator=torch.Generator().manual_seed(13))
    tcfg = ISSGDConfig(batch_size=64, score_batch_size=256, refresh_every=8)
    opt = sgd(0.01)
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        scoring = make_scoring_pass(make_mlp_scorer(cfg, "ghost"), tcfg, n)
        master = make_master_pass(
            lambda pp, b: per_example_loss(pp, b, cfg), opt, tcfg, n)
        store, fresh, stale = scoring(p, init_store(n, dev), 0, data)
        new_p, _, _, _, m = master(p, (), p, store, 0, None, data, fresh,
                                   stale, sample_indices=idx)
        # the step's update new − old: compared alone, so that the shared
        # old params cannot hide a difference in the gradient
        deltas = tree_map(lambda a, b: a - b, new_p, p)
        out[dev] = {"scores": fresh, "loss": m.loss, "grad_norm": m.grad_norm,
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}}
    errs = {}
    for key, ref_val in out["cpu"].items():
        card = out["cuda"][key].cpu()
        if key == "scores":    # elementwise: every score is positive
            errs[key] = ((card - ref_val).abs() / ref_val.abs()).max().item()
        else:
            errs[key] = rel_err(card, ref_val)
    worst = max(errs, key=errs.get)
    print(f"parity: card vs CPU at full width, largest relative error "
          f"{errs[worst]:.3e} ({worst}); scores {errs['scores']:.3e}, loss "
          f"{errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}", flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"card vs CPU: {worst} relative error {errs[worst]:.3e} > "
             f"{CARD_VS_CPU_RTOL}")
    return errs


def call_loop(fn, inputs, rounds):
    for _ in range(rounds):
        for args in inputs:
            fn(*args)


def time_events(fn, inputs, rounds):
    """ms per call of fn(*inputs[i]) from CUDA events around a warm loop
    that rotates over the input sets; includes the host's launch gaps."""
    call_loop(fn, inputs, rounds)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call_loop(fn, inputs, rounds)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * len(inputs))


def time_cold(fn, inputs, rounds=20, split=False):
    """(device ms, wall ms) per call of fn(*inputs[i]), rotating over input
    sets larger than the L2 cache so every call finds its operands in
    device memory.  Device ms sums the durations of the CUDA kernels the
    profiler traced; wall ms is ``time_events`` of the unprofiled loop.
    With ``split`` also {kernel name: device ms per call}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = rounds * len(inputs)
    wall_ms = time_events(fn, inputs, rounds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call_loop(fn, inputs, rounds)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    if device_us <= 0:
        fail("the profiler traced no CUDA kernel time")
    if not split:
        return device_us / 1e3 / calls, wall_ms
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / calls
    return device_us / 1e3 / calls, wall_ms, by_name


def bound_ms(b, widths, elem_bytes=4):
    """Least time for the function: bytes (inputs once, f32[B] out once)
    over HBM rate vs 2 flops per input element over the f32 peak."""
    elems = b * sum(din + dout for din, dout in widths)
    t_bytes = (elems * elem_bytes + b * 4) / HBM_BYTES_PER_S
    t_ops = 2 * elems / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


# the parent design's device µs at phase 5's shapes (PR 20's A/B and phase
# 5, NVIDIA H100 80GB HBM3, 700 W), printed beside this build's
PARENT_US = {"per_example_sqnorm_multi": "9.04–9.09",
             "per_example_sqnorm": "3.95–4.03"}
# the single-tap kernel's main-path launch: the replicated 10-class tap of
# a --model-parallel 4 mlp_svhn step
MP4_TAP = (2048, 10)


def phase_times(pes, ref):
    f32 = ((torch.float32, torch.float32),)
    sets_needed = lambda widths: max(
        2, math.ceil(4 * L2_BYTES / (4 * MAIN_B * sum(a + b for a, b in widths))))
    rows = {}
    for name, widths in (("per_example_sqnorm_multi", MAIN_TAPS),
                         ("per_example_sqnorm", MAIN_TAPS[:1]),
                         ("per_example_sqnorm fc4", (MP4_TAP,))):
        inputs = [make_taps(MAIN_B, widths, f32 * len(widths), seed=500 + i)
                  for i in range(sets_needed(widths))]
        if name == "per_example_sqnorm_multi":
            kern = lambda xs, ds: pes.per_example_sqnorm_multi(xs, ds)
            plain = lambda xs, ds: ref.per_example_sqnorm_multi_ref(xs, ds)
        else:             # the single-tap kernel, at both of its shapes
            kern = lambda xs, ds: pes.per_example_sqnorm(xs[0], ds[0])
            plain = lambda xs, ds: ref.per_example_sqnorm_ref(xs[0], ds[0])
        # plain, kernel, kernel, plain: compare within one call, in turns
        (p1, pw1) = time_cold(plain, inputs)
        (k1, kw1, split1) = time_cold(kern, inputs, split=True)
        (k2, kw2, split2) = time_cold(kern, inputs, split=True)
        (p2, pw2) = time_cold(plain, inputs)
        bms, by = bound_ms(MAIN_B, widths)
        split = split1 if k1 <= k2 else split2
        rows[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "bound_ms": bms, "bound_by": by,
                      "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
                      "wall_ms_runs": [kw1, kw2],
                      "plain_wall_ms_runs": [pw1, pw2],
                      "device_ms_by_kernel": split}
        us = lambda a, b: f"{a * 1e3:.2f}/{b * 1e3:.2f} us"
        print(f"times: {name} at B={MAIN_B} taps {list(widths)}, "
              f"{len(inputs)} input sets rotated (L2 cold): device "
              f"kernel {us(k1, k2)}, plain {us(p1, p2)}; wall kernel "
              f"{us(kw1, kw2)}, plain {us(pw1, pw2)}; bound "
              f"{bms * 1e3:.2f} us ({by})", flush=True)
        print(f"times: {name} device time a call by kernel (the faster "
              f"run): " + "; ".join(f"{k} {v * 1e3:.2f} us"
                                    for k, v in split.items())
              + f"; {min(k1, k2) / bms:.2f}x the bound"
              + (f"; the parent design's {PARENT_US[name]} us"
                 if name in PARENT_US else ""), flush=True)
    fc4 = rows.pop("per_example_sqnorm fc4")
    rows["per_example_sqnorm"]["shapes"] = {
        "model_parallel_4_fc4": dict(fc4, shape=[MAIN_B, *MP4_TAP])}
    return rows


def phase_profile(train_mod, argv, cfg=None, steps=8, warm=3, tag="profile",
                  **attn):
    """Device time by kernel over a few steady steps of the run ``argv``
    (with the config override ``cfg`` and the attention path ``attn``)
    builds."""
    args = train_mod.parse_args(argv)
    built = train_mod.build(args, cfg, **attn)
    state, step, data = built.state, built.step, built.data
    carry = {"state": state}
    del state

    def one():
        carry["state"], _ = step(carry["state"], data)

    for _ in range(warm):
        one()
    out = profile_window(one, steps, tag)
    del carry, step, data
    return out


# ------------------------------------------------------------ the LM path
def lm_config(layers=LM_LAYERS):
    """glm4-9b at its published widths, depth cut to ``layers``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("glm4-9b"), num_layers=layers)


def gram_inputs(rows, s, din, dout, x_dtype, d_dtype, seed,
                one_way=False):
    """x ~ N(0,1) activations, d ~ N(0,1)·1e-2 cotangents on the card.
    ``one_way``: d = 1e-2·(b + 0.45·2^-7), b bf16 in [1, 2), so every d
    value rounds to bf16 in the same direction and a Gram built from one
    bf16 part of d errs coherently (tests/test_torch_ghost_split.py)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, s, din, generator=g, device="cuda").to(x_dtype)
    if one_way:
        b = (1 + torch.rand(rows, s, dout, generator=g, device="cuda")
             ).to(torch.bfloat16).float()
        return x, (1e-2 * (b + 0.45 * 2.0 ** -7)).to(d_dtype)
    d = (torch.randn(rows, s, dout, generator=g, device="cuda")
         * 1e-2).to(d_dtype)
    return x, d


def gram_error(k, x, d):
    """(largest |kernel − plain| over Σ_st |A_st·B_st|, plain, largest
    absolute difference) for one call's rows."""
    xf, df = x.float(), d.float()
    ga = torch.einsum("bsk,btk->bst", xf, xf)
    gb = torch.einsum("bsk,btk->bst", df, df)
    plain = torch.sum(ga * gb, dim=(1, 2))
    mag = torch.sum((ga * gb).abs(), dim=(1, 2))
    diff = (k - plain).abs()
    return (diff / mag).max().item(), plain, diff.max().item()


def phase_ghost_kernels(gn, ref):
    """The ghost-norm Gram kernel against its plain version."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []   # (tag, rows, S, din, dout, x dtype, d dtype)
    seen = set()
    for step, calls in GHOST_STEPS.items():
        for name, rows, s, din, dout in calls:
            if (rows, s, din, dout) not in seen:   # wq = wo, wk = wv, ...
                seen.add((rows, s, din, dout))
                cases.append((f"main {step} {name}", rows, s, din, dout,
                              bf16, f32))
    for xt, dt in ((f32, f32), (bf16, bf16), (bf16, f32)):
        types = f"{str(xt)[6:]}/{str(dt)[6:]}"
        cases += [(f"S=2048 {types}", 2, 2048, 4096, 256, xt, dt),
                  (f"S=2048 {types}", 2, 2048, 4096, 4096, xt, dt),
                  (f"S=100 {types}", 16, 100, 4096, 256, xt, dt),
                  (f"S=100 ragged widths {types}", 8, 100, 300, 77, xt, dt)]
    cases.append(("one-way rounding bfloat16/float32", 2, 64, 256, 4096,
                  bf16, f32))
    max_abs = 0.0
    for ci, (tag, rows, s, din, dout, xt, dt) in enumerate(cases):
        x, d = gram_inputs(rows, s, din, dout, xt, dt, seed=700 + ci,
                           one_way=tag.startswith("one-way"))
        tc_before = gn.ghost_norm.tc_launches
        worst = 0.0
        for symmetric in (True, False):
            k1 = gn.ghost_norm(x, d, symmetric=symmetric)
            k2 = gn.ghost_norm(x, d, symmetric=symmetric)
            torch.cuda.synchronize()
            if not torch.equal(k1, k2):
                fail(f"ghost_norm {tag} {(rows, s, din, dout)} symmetric="
                     f"{symmetric}: two launches differ")
            err, plain, abs_err = gram_error(k1, x, d)
            if not torch.allclose(plain, ref.ghost_norm_ref(x, d),
                                  rtol=1e-5, atol=0):
                fail(f"ghost_norm {tag}: the check's Gram != ghost_norm_ref")
            if err > GHOST_TOL:
                fail(f"ghost_norm {tag} {(rows, s, din, dout)} symmetric="
                     f"{symmetric}: kernel vs plain error {err:.3e} of "
                     f"Σ|A·B| > {GHOST_TOL}")
            worst = max(worst, err)
            if tag.startswith("main"):
                max_abs = max(max_abs, abs_err)
        tc = gn.ghost_norm.tc_launches - tc_before
        if tc not in (0, 4):
            fail(f"ghost_norm {tag}: {tc} of 4 calls on the tensor cores")
        if tag.startswith(("main", "one-way")) and tc != 4:
            fail(f"ghost_norm {tag}: a main-path shape took the SIMT "
                 f"instance")
        print(f"ghost: {tag} (R={rows}, S={s}, {din}→{dout}) ok on the "
              f"{'tensor-core' if tc else 'SIMT'} instance: symmetric and "
              f"not, error ≤ {worst:.2e} of Σ|A·B|, two launches bitwise "
              f"equal", flush=True)
        del x, d
    # the two plain versions agree (the direct one materializes din·dout)
    x, d = gram_inputs(8, 100, 300, 77, f32, f32, seed=690)
    a, b = ref.ghost_norm_ref(x, d), ref.ghost_norm_direct_ref(x, d)
    if not torch.allclose(a, b, rtol=1e-4, atol=0):
        fail(f"ghost_norm_ref vs ghost_norm_direct_ref: rel err "
             f"{rel_err(a, b):.3e}")
    # the wrapper refuses what the kernel does not take
    x, d = gram_inputs(2, 8, 16, 8, f32, f32, seed=691)
    bad = {"float64": (x.double(), d), "cpu d": (x, d.cpu()),
           "non-contiguous": (x[:, :, ::2], d),
           "S mismatch": (x, d[:, :7].contiguous()),
           "rows mismatch": (x, d[:1]), "2-D": (x[0], d[0])}
    before = gn.ghost_norm.launches
    for what, (bx, bd) in bad.items():
        try:
            gn.ghost_norm(bx, bd)
        except (TypeError, ValueError):
            continue
        fail(f"ghost_norm accepted a {what} input")
    if gn.ghost_norm.launches != before:
        fail("a refused ghost_norm call counted a launch")
    print(f"ghost: plain Gram == direct (rtol 1e-4); wrapper refuses "
          f"{', '.join(bad)}", flush=True)
    return max_abs


def kernel_wrappers() -> dict:
    """name → the wrapper whose ``launches`` counts that kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import per_example_sqnorm as pes
    from repro_torch.kernels import selective_scan as ss
    return {"per_example_sqnorm_multi": pes.per_example_sqnorm_multi,
            "per_example_sqnorm": pes.per_example_sqnorm,
            "ghost_norm": gn.ghost_norm,
            "flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "flash_attention_bwd": fab.flash_attention_bwd,
            "attn_score_sweep": fab.attn_score_sweep,
            "selective_scan": ss.selective_scan}


# the kernels with a tensor-core instance (tc_launches): bf16 attention
# (prefill, training, decode), bf16-x ghost norm
TC_KERNELS = ("flash_attention", "flash_attention_bwd", "ghost_norm",
              "decode_attention")


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
    wrappers = kernel_wrappers()
    wrappers["flash_attention_bwd"].scored = 0
    for name in TC_KERNELS:
        wrappers[name].tc_launches = 0



def check_tc(launches: dict, what: str) -> None:
    """Fail unless every launch of a TC_KERNELS kernel (all bf16, or bf16
    x, on the main paths) went to its tensor-core instance."""
    wrappers = kernel_wrappers()
    for name in TC_KERNELS:
        if wrappers[name].tc_launches != launches[name]:
            fail(f"{what}: {name} launched {launches[name]} times, "
                 f"{wrappers[name].tc_launches} of them the tensor-core "
                 f"kernel; the main path must take it every time")


def read_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


PLAIN_NAMES = ("per_example_sqnorm_ref", "per_example_sqnorm_multi_ref",
               "ghost_norm_ref", "ghost_norm_direct_ref",
               "flash_attention_ref", "flash_attention_kernel_ref",
               "decode_attention_ref", "decode_attention_kernel_ref",
               "flash_attention_bwd_kernel_ref",
               "attn_score_sweep_kernel_ref", "attn_grad_sqnorm_ref",
               "selective_scan_kernel_ref")


def run_forbidding_plain(ref, fn, allow=()):
    """fn() with every plain version replaced by one that raises, but for
    those named in ``allow``: ``ghost_norm_direct_ref`` is no kernel's
    stand-in but the direct path itself, which ``ops.ghost_norm`` takes
    by the reference's cost rule (the MoE router's tap)."""
    def forbidden(*_a, **_k):
        raise AssertionError("a plain version ran on the CUDA path")
    names = [n for n in PLAIN_NAMES if n not in allow]
    saved = {n: getattr(ref, n) for n in names}
    for n in names:
        setattr(ref, n, forbidden)
    try:
        return fn()
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)


def phase_lm_main(train_mod, pes, gn, ref):
    """glm4-9b at full width (depth cut) through the train entry point."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = run_forbidding_plain(ref, lambda: train_mod.main(
        LM_ARGV + ["--steps", str(LM_STEPS), "--log-every", "1"],
        lm_config()))
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches["ghost_norm"] != len(GHOST_MAIN) * LM_STEPS:
        fail(f"ghost_norm called {launches['ghost_norm']} times in "
             f"{LM_STEPS} LM steps; expected {len(GHOST_MAIN)} a step")
    check_tc(launches, "lm main")
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    for rec in result.history:
        if not all(math.isfinite(rec[k]) for k in keys):
            fail(f"non-finite LM metrics at step {rec['step']}: {rec}")
    step_ms = statistics.median(result.step_ms[LM_WARMUP:])
    hist = result.history
    del result
    torch.cuda.empty_cache()
    print(f"lm main: glm4-9b × {LM_LAYERS} layers, {LM_STEPS} steps, "
          f"launches {launches}, loss {hist[0]['loss']:.4f} → "
          f"{hist[-1]['loss']:.4f}, median step {step_ms:.3f} ms (CUDA "
          f"events, {LM_WARMUP} warm-up), peak memory {peak_gib:.2f} GiB",
          flush=True)
    return launches, step_ms, peak_gib, hist


def phase_lm_parity():
    """One LM scoring pass + master step at full width, card vs CPU."""
    from repro_torch.core.issgd import (ISSGDConfig, make_master_pass,
                                        make_scoring_pass)
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.data import make_token_dataset
    from repro_torch.models.transformer import (init_transformer,
                                                per_example_loss)
    from repro_torch.optim import sgd, tree_leaves, tree_map

    cfg = dataclasses.replace(lm_config(), num_layers=1, dtype="float32")
    n, sb, b, seq = 64, 4, 2, 64
    train = make_token_dataset(torch.Generator("cuda").manual_seed(21), n=n,
                               seq=seq + 1, vocab=cfg.vocab_size)
    params = init_transformer(torch.Generator("cuda").manual_seed(22), cfg,
                              "cuda")
    idx = torch.randint(0, n, (b,), generator=torch.Generator().manual_seed(23))
    tcfg = ISSGDConfig(batch_size=b, score_batch_size=sb, refresh_every=8)
    # lr 1: the update new − old stands far above the f32 rounding of the
    # params themselves, so comparing it compares the gradients
    opt = sgd(1.0)
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        scoring = make_scoring_pass(make_lm_scorer(cfg, "ghost"), tcfg, n)
        master = make_master_pass(
            lambda pp, bb: per_example_loss(pp, cfg, bb)[0], opt, tcfg, n)
        t0 = time.perf_counter()
        store, fresh, stale = scoring(p, init_store(n, dev), 0, data)
        new_p, _, _, _, m = master(p, (), p, store, 0, None, data, fresh,
                                   stale, sample_indices=idx)
        deltas = tree_map(lambda a, c: (a - c).cpu(), new_p, p)
        out[dev] = {"scores": fresh.cpu(), "loss": m.loss.cpu(),
                    "grad_norm": m.grad_norm.cpu(),
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}}
        print(f"lm parity: {dev} pass in {time.perf_counter() - t0:.1f} s",
              flush=True)
        del p, new_p, deltas, data
    errs = {}
    for key, ref_val in out["cpu"].items():
        card = out["cuda"][key]
        if key == "scores":    # elementwise: every score is positive
            errs[key] = ((card - ref_val).abs() / ref_val.abs()).max().item()
        else:
            errs[key] = rel_err(card, ref_val)
    worst = max(errs, key=errs.get)
    print(f"lm parity: glm4-9b full width, 1 layer, f32, card (CUDA Gram "
          f"kernel) vs CPU (plain Gram): largest relative error "
          f"{errs[worst]:.3e} ({worst}); scores {errs['scores']:.3e}, loss "
          f"{errs['loss']:.3e}, grad norm {errs['grad_norm']:.3e}",
          flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"LM card vs CPU: {worst} relative error {errs[worst]:.3e} > "
             f"{CARD_VS_CPU_RTOL}")
    del params
    torch.cuda.empty_cache()
    return errs


def ghost_bounds(rows, s, din, dout):
    """(bytes ms, operations ms) of ghost_norm on bf16 x and f32 d: inputs
    read once and f32[R] written once over the HBM rate; the operations
    are the algorithm's two symmetric Grams, S(S+1)·(din + dout) flops a
    row (S(S+1)/2 entries of one multiply-add per feature), over the bf16
    tensor-core peak, where the kernel runs them (as ``flash_bound`` counts
    the flash kernels, whose P split also makes the tensor cores do more
    than the algorithm)."""
    nbytes = rows * s * (din * 2 + dout * 4) + rows * 4
    flops = float(s * (s + 1) * (din + dout) * rows)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            flops / BF16_TC_FLOP_PER_S * 1e3)


def phase_ghost_times(gn, ref, rounds=5):
    """ghost_norm vs its plain version at each call of the three steps of
    GHOST_STEPS.  Every input set is larger than the L2 cache, so one set
    keeps calls cold.

    Each call keeps the card busy for 0.3 ms or more while the host
    enqueues the next in far less, so CUDA events around a loop of calls
    give the device time.  (The profiler's kernel sum is not used here:
    it has dropped records of these long kernels.)"""
    shapes = {}
    for calls in GHOST_STEPS.values():
        for _, rows, s, din, dout in calls:
            shape = (rows, s, din, dout)
            if shape in shapes:
                continue
            x, d = gram_inputs(rows, s, din, dout, torch.bfloat16,
                               torch.float32, seed=800)
            if x.numel() * 2 + d.numel() * 4 < 2 * L2_BYTES:
                fail(f"ghost times {shape}: inputs fit in L2")
            kern = lambda a, b: gn.ghost_norm(a, b, symmetric=True)
            plain = lambda a, b: ref.ghost_norm_ref(a, b)
            args = [(x, d)]
            # plain, kernel, kernel, plain: compare within one call, in turns
            p1 = time_events(plain, args, rounds)
            k1 = time_events(kern, args, rounds)
            k2 = time_events(kern, args, rounds)
            p2 = time_events(plain, args, rounds)
            b_ms, o_ms = ghost_bounds(rows, s, din, dout)
            shapes[shape] = {
                "shape": list(shape), "ms": min(k1, k2),
                "plain_ms": min(p1, p2), "bytes_ms": b_ms, "ops_ms": o_ms,
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2]}
            print(f"lm times: ghost_norm (R={rows}, S={s}, {din}→{dout}, "
                  f"bf16 x, f32 d, L2 cold): CUDA events kernel "
                  f"{k1 * 1e3:.1f}/{k2 * 1e3:.1f} us, plain (2 bmm + "
                  f"reduce) {p1 * 1e3:.1f}/{p2 * 1e3:.1f} us; bound bytes "
                  f"{b_ms * 1e3:.1f} us, ops (tensor cores) "
                  f"{o_ms * 1e3:.1f} us", flush=True)
            del x, d
    rows_out, steps = {}, {}
    for step, calls in GHOST_STEPS.items():
        rows_out[step] = {name: shapes[(rows, s, din, dout)]
                          for name, rows, s, din, dout in calls}
        steps[step] = {k: sum(r[k] for r in rows_out[step].values())
                       for k in ("ms", "plain_ms", "bytes_ms", "ops_ms")}
        steps[step]["bound_ms"] = max(steps[step]["bytes_ms"],
                                      steps[step]["ops_ms"])
        steps[step]["bound_by"] = ("bytes" if steps[step]["bytes_ms"] >=
                                   steps[step]["ops_ms"] else "operations")
        steps[step]["calls"] = len(calls)
    card_after = card_state()
    for step, t in steps.items():
        print(f"lm times: ghost_norm per {step} step ({t['calls']} calls): "
              f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"bound bytes {t['bytes_ms']:.3f} ms, ops {t['ops_ms']:.3f} "
              f"ms", flush=True)
    print(f"lm times: clock, power, temperature after: {card_after}",
          flush=True)
    return rows_out, steps, card_after


# ---------------------------------------------------------- the serve path
def serve_config(layers=None, dtype=None):
    """glm4-9b at its published widths (and depth unless ``layers``)."""
    from repro_torch.configs import get_config
    kw = {k: v for k, v in (("num_layers", layers), ("dtype", dtype))
          if v is not None}
    return dataclasses.replace(get_config("glm4-9b"), **kw)


def attn_inputs(shapes, dtype, seed):
    """N(0,1) tensors of ``shapes`` on the card, as ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(sh, generator=g, device="cuda").to(dtype)
            for sh in shapes]


def plain_lse(q, k, window, q_chunk=256):
    """(B, H, S) logsumexp of the masked logits (-inf masks), chunked."""
    bsz, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(bsz, s, hkv, h // hkv, hd).float() * hd ** -0.5
    pos = torch.arange(s, device=q.device)
    out = []
    for lo in range(0, s, q_chunk):
        lg = torch.einsum("bqgrd,bkgd->bgrqk", qg[:, lo:lo + q_chunk],
                          k.float())
        qp = pos[lo:lo + q_chunk]
        mask = pos[None, :] <= qp[:, None]
        if window > 0:
            mask = mask & ((qp[:, None] - pos[None, :]) < window)
        out.append(torch.logsumexp(torch.where(mask, lg, float("-inf")), -1))
    return torch.cat(out, dim=-1).reshape(bsz, h, s)


def attn_close(got, want, dtype) -> tuple[bool, float]:
    """(within the stated tolerance, largest absolute difference)."""
    tol = ATTN_F32 if dtype == torch.float32 else ATTN_BF16
    err = (got.float() - want.float()).abs().max().item() if got.numel() \
        else 0.0
    return torch.allclose(got.float(), want.float(), **tol), err


def expect_refusal(what: str, fn) -> None:
    try:
        fn()
    except (TypeError, ValueError):
        return
    fail(f"accepted {what}")


def phase_attn_kernels(fa, da, ref):
    """The flash-attention forward and flash-decode kernels against their
    plain versions on the card."""
    f32, bf16 = torch.float32, torch.bfloat16
    max_abs = {}
    # (tag, B, S, H, Hkv, hd, window, dtype)
    flash_cases = [
        ("glm4-9b prefill", SERVE_B, SERVE_PROMPT, 32, 2, 128, 0, bf16),
        ("ragged S=100", 2, 100, 32, 2, 128, 0, bf16),
        ("ragged S=100", 2, 100, 32, 2, 128, 0, f32),
        ("window 24", 2, 300, 32, 2, 128, 24, bf16),
        ("window 24", 2, 300, 32, 2, 128, 24, f32),
        ("glm4-9b-smoke", 2, 64, 8, 2, 32, 0, f32),
        ("glm4-9b-smoke window 8", 2, 70, 8, 2, 32, 8, f32),
        ("MHA (deepseek-7b heads)", 1, 100, 32, 32, 128, 0, f32),
        ("rep 6 (internlm2-20b heads)", 1, 130, 48, 8, 128, 0, bf16),
        ("hd 64", 2, 90, 4, 1, 64, 0, f32),
        # the tensor-core kernel's other instances and row mappings
        ("glm4-9b-smoke hd 32 window 8", 2, 70, 8, 2, 32, 8, bf16),
        ("hd 64", 2, 90, 4, 1, 64, 0, bf16),
        ("MHA (deepseek-7b heads)", 1, 100, 32, 32, 128, 0, bf16),
        ("rep 64", 1, 50, 64, 1, 64, 0, bf16),
        # the served paths of slice 14: jamba's GQA layer (a group of 4),
        # musicgen's MHA at hd 64 over 64 embeds + a 1024-token prompt
        ("jamba-v0.1-52b prefill", ZOO_SERVE_B, JAMBA_SERVE_PROMPT, 32, 8,
         128, 0, bf16),
        ("musicgen-medium prefill", ZOO_SERVE_B,
         MUSIC_SERVE_FRONT + MUSIC_SERVE_PROMPT, 24, 24, 64, 0, bf16),
    ]
    for ci, (tag, b, s, h, hkv, hd, win, dt) in enumerate(flash_cases):
        q, k, v = attn_inputs([(b, s, h, hd), (b, s, hkv, hd),
                               (b, s, hkv, hd)], dt, seed=900 + ci)
        o, lse = fa.flash_attention(q, k, v, window=win, return_lse=True)
        o2 = fa.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        po, plse = ref.flash_attention_kernel_ref(q, k, v, window=win,
                                                  return_lse=True)
        name = (f"flash_attention {tag} {str(dt)[6:]} "
                f"(B, S, H, Hkv, hd)={(b, s, h, hkv, hd)} window={win}")
        if not torch.equal(o, o2):
            fail(f"{name}: two launches differ")
        ok, err = attn_close(o, po, dt)
        if not ok:
            fail(f"{name}: kernel vs plain max abs err {err:.3e}")
        lse_want = plain_lse(q, k, win)
        lse_err = (lse - lse_want).abs().max().item()
        if not torch.allclose(lse, lse_want, **ATTN_F32):
            fail(f"{name}: lse vs plain logsumexp max abs err {lse_err:.3e}")
        if not torch.allclose(plse, lse_want, **ATTN_F32):
            fail(f"{name}: the plain version's lse != logsumexp")
        if ci == 0:
            max_abs["flash_attention"] = err
        print(f"attn: {name} ok: max abs err {err:.3e}, lse err "
              f"{lse_err:.3e}, two launches bitwise equal", flush=True)
        del q, k, v, o, o2, lse, po, plse, lse_want
    # (tag, B, S, H, Hkv, hd, lengths, dtype)
    g = torch.Generator().manual_seed(950)
    rand = lambda b, s: torch.randint(1, s + 1, (b,), generator=g).tolist()
    decode_cases = [
        ("glm4-9b decode", SERVE_B, SERVE_MAX, 32, 2, 128,
         [0, 1, SERVE_MAX, SERVE_MAX - 1] + rand(4, SERVE_MAX), bf16),
        ("glm4-9b 32k cache", SERVE_B, LONG_S, 32, 2, 128,
         [LONG_S, 0, 1] + rand(5, LONG_S), bf16),
        ("glm4-9b f32", 4, 300, 32, 2, 128, [0, 1, 300, 177], f32),
        ("glm4-9b-smoke", 4, 40, 8, 2, 32, [0, 1, 40, 17], f32),
        ("ragged ring 100", 3, 100, 32, 2, 128, [100, 37, 0], bf16),
        ("MHA (deepseek-7b heads)", 2, 200, 32, 32, 128, [200, 5], bf16),
        ("rep 6 (internlm2-20b heads)", 2, 200, 48, 8, 128, [199, 64], f32),
        ("hd 64", 2, 64, 4, 1, 64, [64, 0], f32),
        ("jamba-v0.1-52b decode", ZOO_SERVE_B, JAMBA_SERVE_MAX, 32, 8, 128,
         [JAMBA_SERVE_MAX, 1] + rand(6, JAMBA_SERVE_MAX), bf16),
        ("musicgen-medium decode", ZOO_SERVE_B, MUSIC_SERVE_MAX, 24, 24, 64,
         [MUSIC_SERVE_MAX, 0] + rand(6, MUSIC_SERVE_MAX), bf16),
    ]
    def check_decode(tag, q, k, v, lens):
        """Both launches, the plain version, the -inf oracle, length-0
        rows; for bf16 the tensor-core instance and its emulation.  Returns
        the largest difference from the plain version."""
        b, h, hd = q.shape
        s, hkv = k.shape[1], k.shape[2]
        dt = q.dtype
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        tc_before = da.decode_attention.tc_launches
        o = da.decode_attention(q, k, v, lengths)
        o2 = da.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        name = (f"decode_attention {tag} {str(dt)[6:]} "
                f"(B, S, H, Hkv, hd)={(b, s, h, hkv, hd)}")
        if not torch.equal(o, o2):
            fail(f"{name}: two launches differ")
        ok, err = attn_close(o, ref.decode_attention_kernel_ref(
            q, k, v, lengths), dt)
        if not ok:
            fail(f"{name}: kernel vs plain max abs err {err:.3e}")
        instance = "SIMT"
        if dt == bf16:
            # the tensor-core instance, also against its arithmetic's
            # emulation at the split the wrapper chose
            instance = "tensor-core"
            if da.decode_attention.tc_launches != tc_before + 2:
                fail(f"{name}: bf16 did not take the tensor-core kernel")
            chunk, _ = da.split_plan(b, hkv, s, da._num_sms(0))
            ok, err_e = attn_close(o, ref.decode_attention_split_emulation(
                q, k, v, lengths, chunk), dt)
            if not ok:
                fail(f"{name}: kernel vs its emulation max abs err "
                     f"{err_e:.3e}")
            instance += f", vs emulation {err_e:.3e} (chunk {chunk})"
        elif da.decode_attention.tc_launches != tc_before:
            fail(f"{name}: f32 took the tensor-core kernel")
        zero = [i for i, n in enumerate(lens) if n == 0]
        if zero and o[zero].abs().max().item() != 0.0:
            fail(f"{name}: a length-0 row is not zeros")
        live = [i for i, n in enumerate(lens) if n > 0]
        ok, err_o = attn_close(o[live], ref.decode_attention_ref(
            q[live], k[live], v[live], lengths[live]), dt)
        if not ok:
            fail(f"{name}: kernel vs the -inf oracle max abs err {err_o:.3e}")
        print(f"attn: {name} lengths {lens} ok ({instance}): max abs err "
              f"{err:.3e}, length-0 rows zero, two launches bitwise equal",
              flush=True)
        return err

    for ci, (tag, b, s, h, hkv, hd, lens, dt) in enumerate(decode_cases):
        q, k, v = attn_inputs([(b, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)],
                              dt, seed=960 + ci)
        err = check_decode(tag, q, k, v, lens)
        if ci == 0:
            max_abs["decode_attention"] = err
        if dt == f32:
            # every case also on the tensor-core instance
            check_decode(tag, q.bfloat16(), k.bfloat16(), v.bfloat16(),
                         lens)
        del q, k, v
    # the wrappers refuse what the kernels do not take, counting nothing
    q, k, v = attn_inputs([(1, 8, 4, 32), (1, 8, 2, 32), (1, 8, 2, 32)], f32,
                          seed=990)
    q48, k48 = attn_inputs([(1, 8, 4, 48), (1, 8, 2, 48)], f32, seed=991)
    k1 = k[:, :, :1].contiguous()
    bad = {"float64": (q.double(), k.double(), v.double()),
           "cpu k": (q, k.cpu(), v), "bf16 q with f32 k": (q.bfloat16(), k, v),
           "non-contiguous q": (q[:, :, ::2], k1, k1),
           "hd 48": (q48, k48, k48), "rep 128": (q.repeat(1, 1, 32, 1), k1, k1)}
    before = read_counts()
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    for what, (bq, bk, bv) in bad.items():
        expect_refusal(f"flash_attention: {what}",
                       lambda: fa.flash_attention(bq, bk, bv))
        expect_refusal(f"decode_attention: {what}",
                       lambda: da.decode_attention(bq[:, 0], bk, bv, lens))
    for what, bl in {"int64 lengths": lens.long(), "cpu lengths": lens.cpu(),
                     "lengths of 0 rows": lens[:0]}.items():
        expect_refusal(f"decode_attention: {what}",
                       lambda: da.decode_attention(q[:, 0], k, v, bl))
    if read_counts() != before:
        fail("a refused attention call counted a launch")
    print(f"attn: wrappers refuse {', '.join(bad)} and bad lengths",
          flush=True)
    return max_abs


# ------------------------------------------------- the trainable flash path
def bwd_inputs(b, s, h, hkv, hd, window, dtype, seed, fa):
    """q, k, v ~ N(0,1)·0.5 (as the reference's backward test), the forward
    kernel's o and lse, and dO ~ N(0,1), on the card as ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = [(torch.randn(sh, generator=g, device="cuda") * 0.5).to(dtype)
               for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))]
    do = torch.randn(b, s, h, hd, generator=g, device="cuda").to(dtype)
    o, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    return q, k, v, o, lse, do


def grads_close(got, want, dtype) -> tuple[bool, float]:
    """(within BWD_F32 or BWD_BF16 of the f32 ``want``, largest abs diff)."""
    tol = BWD_F32 if dtype == torch.float32 else BWD_BF16
    err = (got.float() - want).abs().max().item()
    return torch.allclose(got.float(), want, **tol), err


def check_trainable(ops, ref, q, k, v, do, window, name, scores):
    """The autograd Functions (f32) against torch.autograd.grad through the
    plain -inf oracle, and their score taps against the kernel's score."""
    leaves = lambda: [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
    lw = leaves()
    want = torch.autograd.grad(ref.flash_attention_ref(*lw, window=window),
                               lw, do)
    lf = leaves()
    got = torch.autograd.grad(
        ops.make_flash_attention_trainable(window=window)(*lf), lf, do)
    for tag, a, b in zip("qkv", got, want):
        if not torch.allclose(a, b, **BWD_F32):
            fail(f"{name}: autograd Function d{tag} vs autograd through the "
                 f"oracle max abs err {(a - b).abs().max().item():.3e}")
    ls = leaves()
    tap = torch.zeros(q.shape[0], device="cuda", requires_grad=True)
    fused = torch.autograd.grad(ops.make_flash_attention_trainable(
        window=window, with_scores=True)(*ls, tap), ls + [tap], do)
    lp = leaves()
    tap2 = torch.zeros(q.shape[0], device="cuda", requires_grad=True)
    probed = ops.make_qkv_score_probe()(*lp, tap2)
    sep = torch.autograd.grad(ops.make_flash_attention_trainable(
        window=window)(*probed), lp + [tap2], do)
    if not all(torch.equal(a, b) for a, b in zip(fused[:3], got)) or \
            not all(torch.equal(a, b) for a, b in zip(sep[:3], got)):
        fail(f"{name}: the score taps changed the gradients")
    if not torch.equal(fused[3], scores) or not torch.equal(sep[3], scores):
        fail(f"{name}: the fused and probe taps' gradients != the kernel's "
             f"score")


def check_sweep16(fab, ref, grads, sw, psw, name) -> None:
    """The bf16 sweep's score sw of grads: bitwise its exact-order
    emulator, within SWEEP_RTOL of the oracle and of the plain version
    psw (the fused epilogue's tile order), and bitwise the same from
    copies whose bases lie off 16 bytes (its scalar loads)."""
    if not torch.equal(sw, ref.attn_score_sweep_bf16_blocked(*grads)):
        fail(f"{name}: bf16 sweep != its exact-order emulator")
    for what, want in (("oracle", ref.attn_grad_sqnorm_ref(*grads)),
                       ("plain version", psw)):
        err = ((sw - want).abs() / want).max().item()
        if err > SWEEP_RTOL:
            fail(f"{name}: bf16 sweep vs {what} rel err {err:.3e}")
    moved = [off_16(g) for g in grads]
    if not torch.equal(fab.attn_score_sweep(*moved), sw):
        fail(f"{name}: bf16 sweep of copies off 16 bytes differs")


def phase_flash_bwd_kernels(fa, fab, ops, ref):
    """Kernel 5 (with and without scores) and kernel 6 against their plain
    versions on the card, fused == sweep, launch == launch, the autograd
    Functions, and the refusals."""
    f32, bf16 = torch.float32, torch.bfloat16
    max_abs = {}
    # (tag, B, S, H, Hkv, hd, window, dtype)
    cases = [
        ("glm4-9b train", FLASH_B, FLASH_S, 32, 2, 128, 0, bf16),
        ("ragged S=100", 2, 100, 32, 2, 128, 0, bf16),
        ("ragged S=100", 2, 100, 32, 2, 128, 0, f32),
        ("window 24", 2, 300, 32, 2, 128, 24, bf16),
        ("window 24", 2, 300, 32, 2, 128, 24, f32),
        ("glm4-9b-smoke", 2, 64, 8, 2, 32, 0, f32),
        ("glm4-9b-smoke window 8", 2, 70, 8, 2, 32, 8, f32),
        ("MHA (deepseek-7b heads)", 1, 100, 32, 32, 128, 0, f32),
        ("rep 6 (internlm2-20b heads)", 1, 130, 48, 8, 128, 0, bf16),
        ("rep 6 (internlm2-20b heads)", 1, 130, 48, 8, 128, 5, f32),
        ("hd 64", 2, 90, 4, 1, 64, 0, f32),
        ("hd 32 window 1", 2, 50, 4, 2, 32, 1, f32),
        # the tensor-core kernels' other instances and row mappings
        ("glm4-9b-smoke hd 32 window 8", 2, 70, 8, 2, 32, 8, bf16),
        ("hd 64", 2, 90, 4, 1, 64, 0, bf16),
        ("MHA (deepseek-7b heads)", 1, 100, 32, 32, 128, 0, bf16),
        ("rep 64", 1, 50, 64, 1, 64, 3, bf16),
    ]
    for ci, (tag, b, s, h, hkv, hd, win, dt) in enumerate(cases):
        q, k, v, o, lse, do = bwd_inputs(b, s, h, hkv, hd, win, dt,
                                         1100 + ci, fa)
        name = (f"flash bwd {tag} {str(dt)[6:]} (B, S, H, Hkv, hd)="
                f"{(b, s, h, hkv, hd)} window={win}")
        grads = fab.flash_attention_bwd(q, k, v, o, lse, do, window=win)
        *grads_s, sc = fab.flash_attention_bwd(q, k, v, o, lse, do,
                                               window=win, with_scores=True)
        *_, sc2 = fab.flash_attention_bwd(q, k, v, o, lse, do, window=win,
                                          with_scores=True)
        sw = fab.attn_score_sweep(*grads)
        sw2 = fab.attn_score_sweep(*grads)
        torch.cuda.synchronize()
        *plain, psc = ref.flash_attention_bwd_kernel_ref(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            window=win, with_scores=True)
        psw = ref.attn_score_sweep_kernel_ref(*grads)
        if not all(torch.isfinite(t).all() for t in (*grads, sc, sw)):
            fail(f"{name}: a non-finite gradient or score")
        if not all(torch.equal(a, c) for a, c in zip(grads, grads_s)):
            fail(f"{name}: with_scores changed the gradients")
        if not torch.equal(sc, sc2) or not torch.equal(sw, sw2):
            fail(f"{name}: two launches differ")
        errs = []
        for t, got, want in zip("qkv", grads, plain):
            ok, err = grads_close(got, want, dt)
            if not ok:
                fail(f"{name}: d{t} kernel vs plain max abs err {err:.3e}")
            errs.append(err)
        sc_err = ((sc - psc).abs() / psc).max().item()
        if sc_err > SCORE_RTOL:
            fail(f"{name}: fused score vs plain rel err {sc_err:.3e}")
        sweep_note = "sweep == plain sweep bitwise"
        if dt == f32 and not torch.equal(sw, psw):
            fail(f"{name}: sweep != its exact-order plain version")
        if dt == bf16:
            check_sweep16(fab, ref, grads, sw, psw, name)
            sweep_note = (f"sweep == its emulator bitwise and within rtol "
                          f"{SWEEP_RTOL} of the plain versions, a base off "
                          f"16 bytes bitwise the same")
        if dt == f32 and not torch.equal(sc, sw):
            fail(f"{name}: fused score != sweep (f32, must be bitwise)")
        sw_err = ((sw - sc).abs() / sc).max().item()
        if sw_err > SWEEP_BF16_RTOL:
            fail(f"{name}: sweep vs fused score rel err {sw_err:.3e}")
        if dt == f32:
            check_trainable(ops, ref, q, k, v, do, win, name, sc)
        if ci == 0:
            max_abs["flash_attention_bwd"] = max(errs)
            max_abs["attn_score_sweep"] = (sw - psw).abs().max().item()
        print(f"flash bwd: {name} ok: grads max abs err "
              f"{max(errs):.3e}, score rel err {sc_err:.3e}, sweep vs fused "
              f"{'bitwise' if dt == f32 else f'{sw_err:.2e}'}, "
              f"{sweep_note}, two launches bitwise equal"
              f"{', autograd Functions ok' if dt == f32 else ''}",
              flush=True)
        del q, k, v, o, lse, do, grads, grads_s, plain
    # the wrappers refuse what the kernels do not take, counting nothing
    q, k, v, o, lse, do = bwd_inputs(1, 8, 4, 2, 32, 0, f32, 1190, fa)
    q48, k48 = attn_inputs([(1, 8, 4, 48), (1, 8, 2, 48)], f32, seed=1191)
    k1 = k[:, :, :1].contiguous()
    q128 = q.repeat(1, 1, 32, 1)
    lse128 = lse.repeat(1, 32, 1)
    non_contig = do.transpose(1, 2).contiguous().transpose(1, 2)
    bad = {"float64": (q.double(), k.double(), v.double(), o.double(), lse,
                       do.double()),
           "cpu do": (q, k, v, o, lse, do.cpu()),
           "non-contiguous do": (q, k, v, o, lse, non_contig),
           "bf16 do with f32 q": (q, k, v, o, lse, do.bfloat16()),
           "bf16 lse": (q, k, v, o, lse.bfloat16(), do),
           "lse of 2 heads": (q, k, v, o, lse[:, :2].contiguous(), do),
           "hd 48": (q48, k48, k48, q48, lse, q48),
           "rep 128": (q128, k1, k1, q128, lse128, q128)}
    before = read_counts()
    for what, args in bad.items():
        expect_refusal(f"flash_attention_bwd: {what}",
                       lambda: fab.flash_attention_bwd(*args))
    sweep_bad = {"float64": (q.double(), k.double(), v.double()),
                 "cpu dk": (q, k.cpu(), v), "non-contiguous dq":
                 (non_contig, k, v), "hd 48": (q48, k48, k48),
                 "S mismatch": (q[:, :7].contiguous(), k, v),
                 "rep 128": (q128, k1, k1)}
    for what, args in sweep_bad.items():
        expect_refusal(f"attn_score_sweep: {what}",
                       lambda: fab.attn_score_sweep(*args))
    if read_counts() != before:
        fail("a refused flash backward or sweep call counted a launch")
    print(f"flash bwd: wrappers refuse {', '.join(bad)}; the sweep "
          f"{', '.join(sweep_bad)}", flush=True)
    return max_abs


def phase_flash_main(train_mod, ref):
    """glm4-9b at full width (depth cut) through the train entry point on
    the trainable flash path: the master on attn_impl="flash", the scorer
    on attn_scores="fused"; then a few steps with attn_scores="separate",
    the path of the score sweep."""
    fab = kernel_wrappers()["flash_attention_bwd"]
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    out = {}
    for variant, steps in (("fused", FLASH_STEPS),
                           ("separate", FLASH_SEP_STEPS)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        args = train_mod.parse_args(FLASH_ARGV + ["--steps", str(steps),
                                                  "--log-every", "1"])
        result = run_forbidding_plain(ref, lambda: train_mod.run(
            args, lm_config(), attn_impl="flash", attn_scores=variant))
        launches = read_counts()
        scored = fab.scored
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # the scorer's and the master's forwards, each run again in its
        # backward (remat): 4 forward launches a layer a step
        per_step = {"flash_attention": 4 * LM_LAYERS,
                    "flash_attention_bwd": 2 * LM_LAYERS,
                    "attn_score_sweep": LM_LAYERS if variant == "separate"
                    else 0, "ghost_norm": len(FLASH_GHOST),
                    "per_example_sqnorm_multi": 0, "per_example_sqnorm": 0,
                    "decode_attention": 0, "selective_scan": 0}
        want = {k: n * steps for k, n in per_step.items()}
        want_scored = LM_LAYERS * steps if variant == "fused" else 0
        if launches != want or scored != want_scored:
            fail(f"lm flash {variant}: launches {launches} ({scored} scored "
                 f"backward calls) in {steps} steps; expected {want} "
                 f"({want_scored} scored)")
        check_tc(launches, f"lm flash {variant}")
        for rec in result.history:
            if not all(math.isfinite(rec[k]) for k in keys):
                fail(f"non-finite lm flash metrics at step {rec['step']}: "
                     f"{rec}")
        warm = FLASH_WARMUP if steps > FLASH_WARMUP else 0
        step_ms = statistics.median(result.step_ms[warm:])
        hist, all_ms = result.history, result.step_ms
        del result
        torch.cuda.empty_cache()
        out[variant] = {"steps": steps, "launches": launches,
                        "scored_bwd_calls": scored, "step_ms_median": step_ms,
                        "step_ms": all_ms, "peak_mem_gib": peak_gib,
                        "losses": [r["loss"] for r in hist]}
        print(f"lm flash main ({variant}): glm4-9b × {LM_LAYERS} layers, "
              f"seq {FLASH_S}, batch {FLASH_B}, score batch {FLASH_B}, "
              f"{steps} steps, launches {launches} ({scored} backward calls "
              f"with scores), loss {hist[0]['loss']:.4f} → "
              f"{hist[-1]['loss']:.4f}, median step {step_ms:.3f} ms (CUDA "
              f"events, {warm} warm-up), peak memory {peak_gib:.2f} GiB",
              flush=True)
    return out


def phase_flash_parity():
    """glm4-9b at full width, 1 layer, f32, seq 128: the fused, separate
    and exact flash scoring passes and a flash master step with injected
    indices, card (kernels) against CPU (plain versions); on the card
    fused == separate bitwise."""
    from repro_torch.core.issgd import (ISSGDConfig, make_master_pass,
                                        make_scoring_pass)
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.data import make_token_dataset
    from repro_torch.models.transformer import (init_transformer,
                                                per_example_loss)
    from repro_torch.optim import sgd, tree_leaves, tree_map

    cfg = dataclasses.replace(lm_config(), num_layers=1, dtype="float32")
    n, sb, b, seq = 64, 4, 2, 128
    train = make_token_dataset(torch.Generator("cuda").manual_seed(51), n=n,
                               seq=seq + 1, vocab=cfg.vocab_size)
    params = init_transformer(torch.Generator("cuda").manual_seed(52), cfg,
                              "cuda")
    idx = torch.randint(0, n, (b,), generator=torch.Generator().manual_seed(53))
    tcfg = ISSGDConfig(batch_size=b, score_batch_size=sb, refresh_every=8)
    opt = sgd(1.0)    # the update stands far above the params' rounding
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        t0 = time.perf_counter()
        res = {}
        for variant in ("fused", "separate", None):
            scoring = make_scoring_pass(make_lm_scorer(
                cfg, "ghost", attn_impl="flash", attn_scores=variant),
                tcfg, n)
            store, fresh, stale = scoring(p, init_store(n, dev), 0, data)
            res[f"scores {variant or 'exact'}"] = fresh.cpu()
        master = make_master_pass(
            lambda pp, bb: per_example_loss(pp, cfg, bb,
                                            attn_impl="flash")[0],
            opt, tcfg, n)
        new_p, _, _, _, m = master(p, (), p, store, 0, None, data, fresh,
                                   stale, sample_indices=idx)
        deltas = tree_map(lambda a, c: (a - c).cpu(), new_p, p)
        res.update({"loss": m.loss.cpu(), "grad_norm": m.grad_norm.cpu(),
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}})
        out[dev] = res
        print(f"lm flash parity: {dev} passes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del p, new_p, deltas, data
    card = out["cuda"]
    if not torch.equal(card["scores fused"], card["scores separate"]) or \
            not torch.equal(out["cpu"]["scores fused"],
                            out["cpu"]["scores separate"]):
        fail("lm flash parity: fused != separate scores (f32, must be "
             "bitwise) on the card or on the CPU")
    errs = {}
    for key, want in out["cpu"].items():
        if key.startswith("scores"):   # elementwise: every score positive
            errs[key] = ((card[key] - want).abs() / want.abs()).max().item()
        else:
            errs[key] = rel_err(card[key], want)
    worst = max(errs, key=errs.get)
    print(f"lm flash parity: glm4-9b full width, 1 layer, f32, seq {seq}, "
          f"card (kernels) vs CPU (plain versions): largest relative error "
          f"{errs[worst]:.3e} ({worst}); "
          f"{json.dumps({k: f'{v:.2e}' for k, v in errs.items() if not k.startswith('update')})}"
          f"; fused == separate bitwise on both", flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"lm flash card vs CPU: {worst} relative error "
             f"{errs[worst]:.3e} > {CARD_VS_CPU_RTOL}")
    del params
    torch.cuda.empty_cache()
    return errs


def bwd_bound(b, s, h, hkv, hd, elem) -> dict:
    """q, k, v, O, dO and lse read and dQ, dK, dV and the (B,) scores
    written once; five causal-half products, 10·B·H·hd·S(S+1)/2 flops
    (S = QKᵀ, dP = dO·Vᵀ, dV, dK, dQ)."""
    nbytes = (4 * b * s * h * hd + 4 * b * s * hkv * hd) * elem \
        + 4 * b * h * s + 4 * b
    return bound_of(nbytes, 10.0 * b * h * hd * s * (s + 1) / 2, elem)


def sweep_bound(b, s, h, hkv, hd, elem) -> dict:
    """dQ, dK, dV read once and the (B,) scores written once; a multiply
    and an add per element in f32."""
    elems = b * s * (h + 2 * hkv) * hd
    return bound_of(elems * elem + 4 * b, 2.0 * elems, 4)


def phase_flash_times(train_mod, fa, fab, ref, rounds=5):
    """Kernels 5 and 6 at the main shape against their bounds, plain
    versions and (kernel 5) autograd through SDPA; the three scorers; a
    profiler window over a few steps of the fused path."""
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.data import make_token_dataset
    from repro_torch.models.transformer import init_transformer
    bf16 = torch.bfloat16
    cfg = lm_config()
    b, s, h, hkv, hd = (FLASH_B, FLASH_S, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim)
    rows = {}
    sets = [bwd_inputs(b, s, h, hkv, hd, 0, bf16, 1200 + i, fa)
            for i in range(2)]                  # 2 × 286 MB: L2 cold
    kern = lambda *a: fab.flash_attention_bwd(*a)
    kern_s = lambda *a: fab.flash_attention_bwd(*a, with_scores=True)
    plain = lambda *a: ref.flash_attention_bwd_kernel_ref(*a)
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1 = time_events(plain, sets[:1], 1)
    k1, ks1 = time_events(kern, sets, rounds), time_events(kern_s, sets,
                                                           rounds)
    ks2, k2 = time_events(kern_s, sets, rounds), time_events(kern, sets,
                                                             rounds)
    p2 = time_events(plain, sets[:1], 1)
    # the library: autograd through one SDPA call, the backward only
    q, k, v, _, _, do = sets[0]
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    lo = sdpa(lq, lk, lv, is_causal=True, enable_gqa=True)
    ldo = do.transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                      retain_graph=True)
    l1 = time_events(lib, [()], rounds)
    del lq, lk, lv, lo, ldo
    rows["flash_attention_bwd"] = {
        "shape": [b, s, h, hkv, hd], "dtype": "bfloat16", "ms": min(k1, k2),
        "ms_with_scores": min(ks1, ks2), "plain_ms": min(p1, p2),
        "library_ms": l1, **bwd_bound(b, s, h, hkv, hd, 2),
        "ms_runs": [k1, k2], "ms_with_scores_runs": [ks1, ks2],
        "plain_ms_runs": [p1, p2]}
    r = rows["flash_attention_bwd"]
    r["tflop_s"] = achieved_tflops(r)
    print(f"lm flash times: flash_attention_bwd (B, S, H, Hkv, hd)="
          f"{(b, s, h, hkv, hd)} bf16, window 0, 2 input sets: kernel "
          f"{k1:.3f}/{k2:.3f} ms ({r['tflop_s']:.1f} TFLOP/s), with scores "
          f"{ks1:.3f}/{ks2:.3f} ms, plain "
          f"{p1:.3f}/{p2:.3f} ms, autograd through SDPA {l1:.3f} ms; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} (bytes "
          f"{r['bytes_ms']:.4f}, ops {r['ops_ms']:.4f})", flush=True)
    grads = [fab.flash_attention_bwd(*st) for st in sets]
    del sets
    kern = lambda *a: fab.attn_score_sweep(*a)
    plain = lambda *a: ref.attn_score_sweep_kernel_ref(*a)
    # device time from the profiler (a ~30 us call: CUDA events around the
    # eager loop would mostly time the wrapper's host work), beside the
    # events' time
    p1 = time_events(plain, grads, 1)
    k1, kw1, split1 = time_cold(kern, grads, 10 * rounds, split=True)
    k2, kw2, split2 = time_cold(kern, grads, 10 * rounds, split=True)
    p2 = time_events(plain, grads, 1)
    rows["attn_score_sweep"] = {
        "shape": [b, s, h, hkv, hd], "dtype": "bfloat16", "ms": min(k1, k2),
        "events_ms": min(kw1, kw2), "plain_ms": min(p1, p2),
        "library_ms": None, **sweep_bound(b, s, h, hkv, hd, 2),
        "ms_runs": [k1, k2], "events_ms_runs": [kw1, kw2],
        "plain_ms_runs": [p1, p2],
        "device_ms_by_kernel": split1 if k1 <= k2 else split2}
    r = rows["attn_score_sweep"]
    print(f"lm flash times: attn_score_sweep dq {(b, s, h, hd)}, dk/dv "
          f"{(b, s, hkv, hd)} bf16, 2 input sets: device {k1 * 1e3:.2f}/"
          f"{k2 * 1e3:.2f} us (" + "; ".join(
              f"{k} {v * 1e3:.2f}"
              for k, v in r["device_ms_by_kernel"].items())
          + f"), CUDA events {kw1 * 1e3:.2f}/{kw2 * 1e3:.2f} us, plain "
          f"{p1:.3f}/{p2:.3f} ms; bound {r['bound_ms'] * 1e3:.2f} us by "
          f"{r['bound_by']}", flush=True)
    del grads
    torch.cuda.empty_cache()
    # the three scorers at the main shape (the reference's
    # benchmarks/scoring_throughput.py::_transformer_fused_vs_separate)
    params = init_transformer(torch.Generator("cuda").manual_seed(61), cfg,
                              "cuda")
    batch = {"tokens": make_token_dataset(
        torch.Generator("cuda").manual_seed(62), n=b, seq=s + 1,
        vocab=cfg.vocab_size).arrays["tokens"]}
    scorers = {name: make_lm_scorer(cfg, "ghost", attn_impl="flash",
                                    attn_scores=variant)
               for name, variant in (("fused", "fused"),
                                     ("separate", "separate"),
                                     ("exact", None))}
    order = ["fused", "separate", "exact", "exact", "separate", "fused"]
    runs = {name: [] for name in scorers}
    for name in order:
        runs[name].append(time_events(scorers[name], [(params, batch)], 2))
    rows["scorers"] = {name: {"ms": min(v), "ms_runs": v}
                       for name, v in runs.items()}
    print(f"lm flash times: ghost scorer at glm4-9b × {LM_LAYERS} layers, "
          f"B={b}, S={s}, bf16, ms a call (two runs, in turns): "
          f"{json.dumps(runs)}", flush=True)
    del params, batch, scorers
    torch.cuda.empty_cache()
    rows["card_after"] = card_state()
    prof = phase_profile(train_mod, FLASH_ARGV, lm_config(), steps=3, warm=2,
                         tag="lm flash profile", attn_impl="flash",
                         attn_scores="fused")
    return rows, prof


def phase_serve_main(serve_mod, ref):
    """glm4-9b at full width and depth through the serve entry point: the
    decode steps are replays of one captured CUDA graph, whose launches the
    runner adds to the counters at each replay."""
    from repro_torch.serving.engine import DECODE_WARMUP
    torch.cuda.empty_cache()
    reset_counts()
    result = run_forbidding_plain(ref, lambda: serve_mod.main(SERVE_ARGV))
    launches = read_counts()
    cfg = serve_config()
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {launches['flash_attention']} times "
             f"in the prefill; expected {cfg.num_layers}")
    steps = SERVE_STEPS + DECODE_WARMUP
    if launches["decode_attention"] != cfg.num_layers * steps:
        fail(f"decode_attention launched {launches['decode_attention']} "
             f"times in {SERVE_STEPS} graphed decode steps and "
             f"{DECODE_WARMUP} eager warm-up steps; expected "
             f"{cfg.num_layers} a step")
    check_tc(launches, "serve main")
    toks = result.tokens
    if tuple(toks.shape) != (SERVE_B, SERVE_STEPS + 1) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"serve tokens {tuple(toks.shape)} outside [0, "
             f"{cfg.vocab_size})")
    if result.state.lengths.tolist() != [SERVE_MAX] * SERVE_B:
        fail(f"serve lengths {result.state.lengths.tolist()}")
    for name, buf in result.state.caches.items():
        if not torch.isfinite(buf).all():
            fail(f"serve cache {name} holds a non-finite value")
    step_ms = statistics.median(result.step_ms)
    out = {"prefill_ms": result.prefill_ms, "decode_step_ms_median": step_ms,
           "decode_step_ms": result.step_ms, "tok_per_s": result.tok_per_s,
           "decode_s": result.decode_s, "capture_ms": result.capture_ms,
           "decode_warmup_steps": DECODE_WARMUP,
           "peak_mem_gib": result.peak_bytes / 2**30, "launches": launches,
           "card_after": card_state()}
    print(f"serve main: glm4-9b × {cfg.num_layers} layers (full depth), "
          f"batch {SERVE_B}, prompt {SERVE_PROMPT}, {SERVE_STEPS} greedy "
          f"steps (a captured graph, after {DECODE_WARMUP} eager warm-up "
          f"steps and its capture in {result.capture_ms:.1f} ms): launches "
          f"{launches}; prefill {result.prefill_ms:.3f} ms, "
          f"median decode step {step_ms:.3f} ms (CUDA events), "
          f"{result.tok_per_s:.1f} tok/s, peak memory "
          f"{out['peak_mem_gib']:.2f} GiB; clock, power, temperature after: "
          f"{out['card_after']}", flush=True)
    return result, out


def profile_window(fn, steps, tag):
    """Device busy vs wall over ``steps`` calls of fn(), and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = card_state()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    if not by_name:
        print(f"{tag}: device time not measured (no CUDA events traced)",
              flush=True)
        return None
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    top = [{"kernel": k[:90], "us_per_step": round(us / steps, 2),
            "calls_per_step": c / steps} for k, (us, c) in top]
    print(f"{tag}: {steps} steps, device busy {device_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share {1 - device_ms / wall_ms:.3f}); "
          f"clock, power, temperature after: {after}; top kernels "
          f"{json.dumps(top)}", flush=True)
    return {"steps": steps, "device_ms": device_ms, "wall_ms": wall_ms,
            "idle_share": 1 - device_ms / wall_ms, "card_after": after,
            "top": top}


def step_times(fn, steps):
    """CUDA-event ms of each of ``steps`` calls of fn()."""
    marks = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in marks]


def clone_state(st):
    from repro_torch.serving.engine import ServeState
    return ServeState(caches={k: v.clone() for k, v in st.caches.items()},
                      lengths=st.lengths.clone())


def phase_serve_graph_equal(result, cfg=None, bitwise=False,
                            tag="serve graph"):
    """From one cloned state, one eager decode step and one replay of the
    captured step: lengths and caches bitwise equal, the logits too with
    ``bitwise`` (else within CARD_VS_CPU_RTOL, reported).  The runner's
    warm-up steps run on its copy of the state first, so a recurrent
    state they left advanced would show here."""
    from repro_torch.serving.engine import decode_step, make_decode_runner
    cfg = cfg or serve_config()
    tok = result.tokens[:, -1].contiguous()
    with torch.no_grad():
        logits_e, st_e = decode_step(result.params, cfg, tok,
                                     clone_state(result.state), "pallas")
        runner = make_decode_runner(result.params, cfg,
                                    clone_state(result.state), "pallas")
        logits_g, st_g = runner(tok)
    torch.cuda.synchronize()
    caches_equal = all(torch.equal(st_g.caches[k], v)
                       for k, v in st_e.caches.items())
    lengths_equal = torch.equal(st_g.lengths, st_e.lengths)
    logits_equal = torch.equal(logits_g, logits_e)
    err = rel_err(logits_g.float(), logits_e.float())
    print(f"{tag}: one replay of the captured decode step vs one "
          f"eager step from one cloned state: logits "
          f"{'bitwise equal' if logits_equal else f'differ, rel err {err:.3e}'}"
          f", lengths {'equal' if lengths_equal else 'DIFFER'}, caches "
          f"{'bitwise equal' if caches_equal else 'DIFFER'}", flush=True)
    if not (lengths_equal and caches_equal):
        fail(f"{tag}: the graphed decode step's state differs from the "
             f"eager step's")
    if err > CARD_VS_CPU_RTOL or (bitwise and not logits_equal):
        fail(f"{tag}: graphed vs eager decode logits rel err {err:.3e}")
    del runner, st_e, st_g
    torch.cuda.empty_cache()
    return {"logits_bitwise": logits_equal, "logits_rel_err": err,
            "caches_bitwise": caches_equal}


def phase_serve_profile(result, steps=4, warm=2, timed=8, cfg=None,
                        tag="serve profile"):
    """The decode step eager and as replays of its captured graph, in the
    same call, continuing the main path's state (past max_len the ring
    wraps; slot order does not matter): the median of ``timed`` steps
    (CUDA events) and a profiler window (idle share) for each."""
    from repro_torch.serving.engine import decode_step, make_decode_runner
    cfg = cfg or serve_config()
    carry = {"st": result.state, "tok": result.tokens[:, -1].contiguous()}

    @torch.no_grad()
    def eager():
        logits, carry["st"] = decode_step(result.params, cfg, carry["tok"],
                                          carry["st"], "pallas")
        carry["tok"] = torch.argmax(logits, -1).to(torch.int32)

    for _ in range(warm):
        eager()
    out = {"eager": {"step_ms": step_times(eager, timed)}}
    out["eager"]["profile"] = profile_window(
        eager, steps, f"{tag} (eager decode steps)")
    with torch.no_grad():
        runner = make_decode_runner(result.params, cfg, carry["st"],
                                    "pallas")

    @torch.no_grad()
    def graphed():
        logits, carry["st"] = runner(carry["tok"])
        carry["tok"] = torch.argmax(logits, -1).to(torch.int32)

    for _ in range(warm):
        graphed()
    out["graphed"] = {"step_ms": step_times(graphed, timed)}
    out["graphed"]["profile"] = profile_window(
        graphed, steps, f"{tag} (graphed decode steps)")
    # the profiler's own host work stretches its window's wall clock; the
    # device time a step over the unprofiled median step is the idle share
    # the serving user sees
    for mode in out.values():
        mode["step_ms_median"] = statistics.median(mode["step_ms"])
        prof = mode["profile"]
        mode["idle_share_vs_median"] = (
            None if prof is None else
            1 - prof["device_ms"] / steps / mode["step_ms_median"])
    show = lambda m: (f"{out[m]['step_ms_median']:.3f} ms (idle share "
                      f"{out[m]['idle_share_vs_median']:.3f})"
                      if out[m]["profile"] else
                      f"{out[m]['step_ms_median']:.3f} ms")
    print(f"{tag}: median decode step eager {show('eager')}, "
          f"graphed {show('graphed')} (CUDA events, {timed} steps each, "
          f"one call; idle share: 1 - profiled device ms a step / median "
          f"step)", flush=True)
    return out


def phase_batcher(params, ref):
    """ContinuousBatcher on glm4-9b at full width and depth, kernel route:
    16 requests of seeded prompt lengths and budgets through 8 slots."""
    from repro_torch.serving import ContinuousBatcher, Request
    cfg = serve_config()
    g = torch.Generator().manual_seed(31)
    lens = torch.randint(BATCHER_PROMPT[0], BATCHER_PROMPT[1] + 1,
                         (BATCHER_REQUESTS,), generator=g).tolist()
    news = torch.randint(BATCHER_NEW[0], BATCHER_NEW[1] + 1,
                         (BATCHER_REQUESTS,), generator=g).tolist()
    gd = torch.Generator(device="cuda").manual_seed(32)
    reqs = [Request(uid=i, prompt=torch.randint(
                0, cfg.vocab_size, (n,), generator=gd, device="cuda"),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        batcher = ContinuousBatcher(
            params, cfg, num_slots=BATCHER_SLOTS, max_len=BATCHER_MAX_LEN,
            decode_kernel="pallas", attn_impl="pallas")
        finished = run_forbidding_plain(ref, lambda: batcher.run(reqs))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    if sorted(finished) != list(range(BATCHER_REQUESTS)):
        fail(f"batcher finished {sorted(finished)} of {BATCHER_REQUESTS}")
    for r in reqs:
        if len(finished[r.uid]) != r.max_new_tokens:
            fail(f"request {r.uid} got {len(finished[r.uid])} tokens, asked "
                 f"for {r.max_new_tokens}")
    layers = cfg.num_layers
    if launches["flash_attention"] != layers * BATCHER_REQUESTS or \
            launches["decode_attention"] % layers:
        fail(f"batcher launches {launches}")
    steps = launches["decode_attention"] // layers
    out = {"requests": BATCHER_REQUESTS, "slots": BATCHER_SLOTS,
           "max_len": BATCHER_MAX_LEN, "prompt_lens": lens,
           "max_new_tokens": news, "decode_steps": steps,
           "prefill_traces": batcher.prefill_traces, "wall_s": wall_s,
           "launches": launches}
    print(f"batcher: glm4-9b × {layers} layers, {BATCHER_SLOTS} slots, "
          f"{BATCHER_REQUESTS} requests (prompts {min(lens)}–{max(lens)}, "
          f"{min(news)}–{max(news)} new tokens) all finished in "
          f"{wall_s:.2f} s: {steps} decode steps, {batcher.prefill_traces} "
          f"prefill shapes, launches {launches}", flush=True)
    del batcher
    torch.cuda.empty_cache()
    return out


def phase_serve_parity():
    """glm4-9b at full width, 1 layer, f32: a (2, 64) prefill and 4
    teacher-forced decode steps through the kernels on the card, against
    the plain route on the CPU."""
    from repro_torch.models.transformer import init_transformer
    from repro_torch.optim import tree_map
    from repro_torch.serving.engine import decode_step, prefill
    cfg = serve_config(layers=1, dtype="float32")
    params = init_transformer(torch.Generator().manual_seed(41), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64 + 4),
                         generator=torch.Generator().manual_seed(42))
    out = {}
    for dev, route in (("cuda", "pallas"), ("cpu", "ref")):
        p = tree_map(lambda t: t.to(dev), params)
        t = toks.to(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            last, st = prefill(p, cfg, t[:, :64], 96, attn_impl=route)
            res = {"prefill logits": last.cpu()}
            for i in range(4):
                last, st = decode_step(p, cfg, t[:, 64 + i], st, route)
                res[f"decode {i} logits"] = last.cpu()
        res.update({f"cache {k}": v.cpu() for k, v in st.caches.items()})
        out[dev] = res
        print(f"serve parity: {dev} ({route} route) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del p, st, last
    errs = {k: rel_err(out["cuda"][k], v) for k, v in out["cpu"].items()}
    worst = max(errs, key=errs.get)
    print(f"serve parity: glm4-9b full width, 1 layer, f32, card (kernels) "
          f"vs CPU (plain route): largest relative error {errs[worst]:.3e} "
          f"({worst}); {json.dumps({k: f'{v:.2e}' for k, v in errs.items()})}",
          flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"serve card vs CPU: {worst} relative error {errs[worst]:.3e} > "
             f"{CARD_VS_CPU_RTOL}")
    del params
    torch.cuda.empty_cache()
    return errs


def bound_of(nbytes: float, flops: float, elem: int) -> dict:
    """The larger of bytes over the HBM rate and flops over the peak for
    the inputs' type (bf16 tensor cores, or f32 outside them)."""
    peak = BF16_TC_FLOP_PER_S if elem == 2 else F32_FLOP_PER_S
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / peak * 1e3
    return {"bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "flops": flops}


def achieved_tflops(row: dict) -> float:
    """The bound's operations over the kernel's time, TFLOP/s."""
    return row["flops"] / (row["ms"] * 1e-3) / 1e12


def flash_bound(b, s, h, hkv, hd, elem) -> dict:
    """q, k, v read and out written once; 4·B·H·hd·S(S+1)/2 flops (the
    causal half of q·k and p·v)."""
    nbytes = (2 * b * s * h * hd + 2 * b * s * hkv * hd) * elem
    return bound_of(nbytes, 4.0 * b * h * hd * s * (s + 1) / 2, elem)


def decode_bound(lengths, h, hkv, hd, elem) -> dict:
    """K and V up to each row's length, q and lengths read, out written
    once; 4·H·hd flops per valid slot of a row."""
    slots, b = sum(lengths), len(lengths)
    nbytes = (2 * slots * hkv * hd + 2 * b * h * hd) * elem + 4 * b
    return bound_of(nbytes, 4.0 * h * hd * slots, elem)


def sdpa(*args, **kw):
    """The library yardstick; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(*args, **kw)


def phase_serve_times(fa, da, ref, rounds=3):
    """Each serve kernel against its plain version and one PyTorch call
    (SDPA) at the main path's shapes, decode also at a 32k cache; CUDA
    events around loops, input sets rotated past the L2 cache."""
    bf16 = torch.bfloat16
    rows = {}
    b, s, h, hkv, hd = SERVE_B, SERVE_PROMPT, 32, 2, 128
    q, k, v = attn_inputs([(b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)],
                          bf16, seed=1000)
    lib_args = [tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))]
    args = [(q, k, v)]
    kern = lambda *a: fa.flash_attention(*a)
    plain = lambda *a: ref.flash_attention_kernel_ref(*a)
    lib = lambda *a: sdpa(*a, is_causal=True, enable_gqa=True)
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1, k1 = time_events(plain, args, 1), time_events(kern, args, rounds)
    k2, p2 = time_events(kern, args, rounds), time_events(plain, args, 1)
    l1 = time_events(lib, lib_args, rounds)
    rows["flash_attention"] = {
        "shape": [b, s, h, hkv, hd], "dtype": "bfloat16", "ms": min(k1, k2),
        "plain_ms": min(p1, p2), "library_ms": l1,
        **flash_bound(b, s, h, hkv, hd, 2), "ms_runs": [k1, k2],
        "plain_ms_runs": [p1, p2]}
    r = rows["flash_attention"]
    r["tflop_s"] = achieved_tflops(r)
    print(f"serve times: flash_attention (B, S, H, Hkv, hd)="
          f"{(b, s, h, hkv, hd)} bf16, window 0: kernel {k1:.3f}/{k2:.3f} "
          f"ms ({r['tflop_s']:.1f} TFLOP/s), plain {p1:.3f}/{p2:.3f} ms, "
          f"SDPA {l1:.3f} ms; bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']} (bytes {r['bytes_ms']:.4f}, ops "
          f"{r['ops_ms']:.4f})", flush=True)
    del q, k, v, args, lib_args
    torch.cuda.empty_cache()
    for tag, s in (("main", SERVE_MAX), ("32k", LONG_S)):
        sets = max(1, math.ceil(2 * L2_BYTES / (2 * b * s * hkv * hd * 2)))
        inputs, lib_in = [], []
        for i in range(sets):
            q, k, v = attn_inputs([(b, h, hd), (b, s, hkv, hd),
                                   (b, s, hkv, hd)], bf16, seed=1010 + i)
            lengths = torch.full((b,), s, dtype=torch.int32, device="cuda")
            inputs.append((q, k, v, lengths))
            mask = (torch.arange(s, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            lib_in.append((q[:, :, None], k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), mask))
        kern = lambda *a: da.decode_attention(*a)
        plain = lambda *a: ref.decode_attention_kernel_ref(*a)
        lib = lambda q_, k_, v_, m_: sdpa(q_, k_, v_, attn_mask=m_,
                                         enable_gqa=True)
        # a call of the kernel is ~13 us of device work behind ~30 us of
        # the host's: device time from the profiler (ms) beside the eager
        # loop's wall time (wall_ms)
        (p1, pw1) = time_cold(plain, inputs, rounds)
        (k1, kw1) = time_cold(kern, inputs, 10 * rounds)
        (k2, kw2) = time_cold(kern, inputs, 10 * rounds)
        (p2, pw2) = time_cold(plain, inputs, rounds)
        (l1, lw1) = time_cold(lib, lib_in, 10 * rounds)
        r = rows[f"decode_attention {tag}"] = {
            "shape": [b, s, h, hkv, hd], "lengths": s, "dtype": "bfloat16",
            "input_sets": sets, "ms": min(k1, k2), "plain_ms": min(p1, p2),
            "library_ms": l1, **decode_bound([s] * b, h, hkv, hd, 2),
            "ms_runs": [k1, k2], "plain_ms_runs": [p1, p2],
            "wall_ms_runs": [kw1, kw2],
            "plain_wall_ms_runs": [pw1, pw2], "library_wall_ms": lw1}
        us = lambda a, b: f"{a * 1e3:.2f}/{b * 1e3:.2f} us"
        print(f"serve times: decode_attention {tag} (B, S, H, Hkv, hd)="
              f"{(b, s, h, hkv, hd)} bf16, all {s} slots, {sets} input "
              f"sets: device kernel {us(k1, k2)}, plain {us(p1, p2)}, SDPA "
              f"{l1 * 1e3:.2f} us; wall kernel {us(kw1, kw2)}, plain "
              f"{us(pw1, pw2)}, SDPA {lw1 * 1e3:.2f} us; bound {r['bound_ms'] * 1e3:.2f} us by "
              f"{r['bound_by']} (bytes {r['bytes_ms'] * 1e3:.2f}, ops "
              f"{r['ops_ms'] * 1e3:.2f})", flush=True)
        del inputs, lib_in
        torch.cuda.empty_cache()
    rows["card_after"] = card_state()
    print(f"serve times: clock, power, temperature after: "
          f"{rows['card_after']}", flush=True)
    return rows


# ------------------------------------------------------------ the mamba path
def mamba_config(layers=None):
    """falcon-mamba-7b at its published widths, depth cut to ``layers``
    (MAMBA_LAYERS by default)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("falcon-mamba-7b"),
                               num_layers=layers or MAMBA_LAYERS)


def scan_inputs(b, s, di, ds, dtype, seed, falcon=False, steep=False,
                col=256):
    """The scan's operands on the card: u ~ N(0,1); B and C column slices
    of a (B, S, col + 2·d_state) projection, at columns col and col +
    d_state, as the model hands them over (col 256, its dt_rank; an odd
    col puts their bases off 16 bytes); D ~ N(0,1).  With ``falcon`` Δ and
    A as falcon-mamba's init gives them (Δ log-uniform in [1e-3, 1e-1],
    A = −[1 .. d_state], so exp(Δ·A) reaches 0.999 and the state sums
    ~1000 steps); with ``steep`` Δ log-uniform in [1e-2, 6.25] and the
    same A, so |Δ·A| reaches 100 and decays below 2^-126 flush to 0; else
    the reference's kernel test's, Δ = softplus(N(0,1)), A =
    −exp(N(0,1)/2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=g, device="cuda")
    u = rn(b, s, di)
    if falcon or steep:
        lo, hi = (math.log(1e-2), math.log(6.25)) if steep else \
            (math.log(1e-3), math.log(1e-1))
        delta = torch.exp(lo + (hi - lo) * torch.rand(
            b, s, di, generator=g, device="cuda"))
        a = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device="cuda")[None].repeat(di, 1)
    else:
        delta = torch.nn.functional.softplus(rn(b, s, di))
        a = -torch.exp(0.5 * rn(di, ds))
    proj = rn(b, s, col + 2 * ds).to(dtype)
    return (u.to(dtype), delta.to(dtype), a.contiguous(),
            proj[..., col:col + ds], proj[..., col + ds:], rn(di))


def scan_check(y, plain, dtype) -> tuple[bool, float]:
    """(within the stated tolerance, largest absolute difference) of the
    kernel's y against the plain version's f32 result: f32 within rtol
    SCAN_RTOL, bf16 within one bf16 ulp of the f32 result rounded; both
    with an atol of SCAN_RTOL of the largest |plain|."""
    atol = SCAN_RTOL * plain.abs().max().item()
    if dtype == torch.float32:
        err = (y - plain).abs()
        ok = bool((err <= SCAN_RTOL * plain.abs() + atol).all())
    else:
        rounded = plain.to(torch.bfloat16).float()
        ulp = torch.exp2(torch.floor(torch.log2(rounded.abs())) - 7)
        err = (y.float() - rounded).abs()
        ok = bool((err <= ulp + atol).all())
    return ok, (y.float() - plain).abs().max().item()


def phase_scan_kernels(ss, ops, ref):
    """The selective-scan kernel against its plain version on the card."""
    f32, bf16 = torch.float32, torch.bfloat16
    # (tag, B, S, d_inner, d_state, dtype, scan_inputs options)
    falcon, steep = {"falcon": True}, {"steep": True}
    cases = [
        ("falcon-mamba-7b scoring", SCAN_B, SCAN_S, 8192, 16, bf16, falcon),
        ("falcon-mamba-7b trainer", MAMBA_SB, MAMBA_S, 8192, 16, bf16,
         falcon),
        ("falcon-mamba-7b f32", 2, 512, 8192, 16, f32, falcon),
        ("ragged S and d_inner", 2, 100, 300, 16, bf16, {}),
        ("ragged S and d_inner", 3, 37, 130, 16, f32, {}),
        ("falcon-mamba-7b-smoke", 4, 64, 512, 8, f32, {}),
        ("reference test shape", 2, 100, 30, 8, f32, {}),
        ("d_state 4", 2, 16, 32, 4, f32, {}),
        ("falcon init f32, the longest memory", 2, SCAN_S, 4096, 16, f32,
         falcon),
        ("|delta·A| to 100, ftz decays", 2, 256, 1024, 16, f32, steep),
        ("|delta·A| to 100, ftz decays", 2, 256, 1024, 16, bf16, steep),
        ("d_state 8, ragged d_inner", 2, 100, 302, 8, bf16, {}),
        ("d_state 4, odd d_inner", 2, 77, 301, 4, bf16, {}),
        ("B and C at odd columns", 2, 300, 512, 16, bf16,
         {"falcon": True, "col": 255}),
        ("B and C at odd columns", 2, 100, 130, 16, f32, {"col": 257}),
    ]
    max_abs = 0.0
    for ci, (tag, b, s, di, ds, dt, opts) in enumerate(cases):
        args = scan_inputs(b, s, di, ds, dt, seed=1900 + ci, **opts)
        with torch.no_grad():
            y = ss.selective_scan(*args)
            y2 = ops.selective_scan(*args)
        torch.cuda.synchronize()
        name = (f"selective_scan {tag} {str(dt)[6:]} (B, S, d_inner, "
                f"d_state)={(b, s, di, ds)}, L={ss.LANES[ds]}")
        if not torch.equal(y, y2):
            fail(f"{name}: two launches differ")
        plain = ref.selective_scan_kernel_ref(*[t.float() for t in args])
        ok, err = scan_check(y, plain, dt)
        if not ok:
            fail(f"{name}: kernel vs plain max abs err {err:.3e}")
        if ci == 0:
            max_abs = err
        print(f"scan: {name} ok: max abs err {err:.3e} (largest |y| "
              f"{plain.abs().max().item():.3e}), two launches bitwise equal",
              flush=True)
        del args, y, y2, plain
    # the wrapper refuses what the kernel does not take, counting nothing
    u, dl, a, bm, cm, d = scan_inputs(2, 8, 32, 4, f32, seed=1990)
    bad = {"float64 u": (u.double(), dl, a, bm, cm, d),
           "float16 u and delta": (u.half(), dl.half(), a, bm, cm, d),
           "bf16 u with f32 delta": (u.bfloat16(), dl, a, bm, cm, d),
           "bf16 A": (u, dl, a.bfloat16(), bm, cm, d),
           "delta shape": (u, dl[:, :7], a, bm, cm, d),
           "A rows": (u, dl, a[:31], bm, cm, d),
           "B shape": (u, dl, a, bm[:, :7], cm, d),
           "d_state 3": (u, dl, a[:, :3].contiguous(), bm[..., :3],
                         cm[..., :3], d),
           "non-contiguous u": (torch.randn(2, 8, 64, device="cuda")[
               ..., ::2], dl, a, bm, cm, d),
           "B with strided states": (u, dl, a, torch.randn(
               2, 8, 8, device="cuda")[..., ::2], cm, d),
           "B with rows of two strides": (u, dl, a, bm.transpose(
               0, 1).contiguous().transpose(0, 1), cm, d),
           "CPU C": (u, dl, a, bm, cm.cpu(), d)}
    before = read_counts()
    for what, args in bad.items():
        expect_refusal(f"selective_scan: {what}",
                       lambda: ss.selective_scan(*args))
    expect_refusal("ops.selective_scan: CPU/CUDA mix",
                   lambda: ops.selective_scan(u, dl, a, bm, cm.cpu(), d))
    for fn in (ss.selective_scan, ops.selective_scan):
        try:
            fn(u.clone().requires_grad_(True), dl, a, bm, cm, d)
        except RuntimeError as e:
            if "forward-only" not in str(e):
                raise
        else:
            fail("selective_scan ran under autograd")
    if read_counts() != before:
        fail("a refused selective_scan call counted a launch")
    print(f"scan: wrappers refuse {', '.join(bad)}, a CPU/CUDA mix and "
          f"autograd", flush=True)
    return max_abs


def phase_mamba_main(train_mod, ref):
    """falcon-mamba-7b at full width (depth cut) through the train entry
    point: (a) the logit_grad scorer on the scan kernel, (b) the ghost
    scorer on the ref scan, then (c) the build's scorer alone at full
    depth."""
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    out = {}
    for leg, strategy, mode, steps in (
            ("logit_grad", "logit_grad", "pallas", MAMBA_STEPS),
            ("ghost", "ghost", "ref", MAMBA_GHOST_STEPS)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        args = train_mod.parse_args(MAMBA_ARGV + [
            "--strategy", strategy, "--steps", str(steps), "--log-every",
            "1"])
        result = run_forbidding_plain(ref, lambda: train_mod.run(
            args, mamba_config(), ssm_mode=mode))
        launches = read_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        per_step = {k: 0 for k in launches}
        if mode == "pallas":
            per_step["selective_scan"] = MAMBA_LAYERS
        else:
            per_step["ghost_norm"] = len(MAMBA_GHOST)
        want = {k: n * steps for k, n in per_step.items()}
        if launches != want:
            fail(f"mamba {leg}: launches {launches} in {steps} steps; "
                 f"expected {want}")
        check_tc(launches, f"mamba {leg}")
        for rec in result.history:
            if not all(math.isfinite(rec[k]) for k in keys):
                fail(f"non-finite mamba {leg} metrics at step "
                     f"{rec['step']}: {rec}")
        step_ms = statistics.median(result.step_ms[MAMBA_WARMUP:])
        hist, all_ms = result.history, result.step_ms
        del result
        torch.cuda.empty_cache()
        out[leg] = {"strategy": strategy, "ssm_mode": mode, "steps": steps,
                    "launches": launches, "step_ms_median": step_ms,
                    "step_ms": all_ms, "peak_mem_gib": peak_gib,
                    "losses": [r["loss"] for r in hist]}
        print(f"mamba main ({leg}, ssm_mode={mode!r}): falcon-mamba-7b × "
              f"{MAMBA_LAYERS} layers, seq {MAMBA_S}, batch {MAMBA_B}, score "
              f"batch {MAMBA_SB}, {steps} steps, launches {launches}, loss "
              f"{hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f}, median step "
              f"{step_ms:.3f} ms (CUDA events, {MAMBA_WARMUP} warm-up), peak "
              f"memory {peak_gib:.2f} GiB", flush=True)
    out["full_depth"] = phase_mamba_full_depth(train_mod, ref)
    return out


def phase_mamba_full_depth(train_mod, ref, rounds=2):
    """The build's logit_grad/pallas scorer at full width and full depth:
    one counted pass over SCAN_B × SCAN_S tokens, then ``rounds`` timed."""
    cfg = mamba_config(layers=64)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train_mod.parse_args(
        ["--arch", "falcon-mamba-7b", "--strategy", "logit_grad", "--seq",
         str(SCAN_S), "--examples", str(SCAN_B), "--device", "cuda"])
    params, train, _, scorer = train_mod.build_lm(args, cfg,
                                                  ssm_mode="pallas")
    batch = {"tokens": train.arrays["tokens"]}
    from repro_torch.optim import tree_leaves
    n_params = sum(t.numel() for t in tree_leaves(params))
    reset_counts()
    t0 = time.perf_counter()
    scores = run_forbidding_plain(ref, lambda: scorer(params, batch))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    want = {k: 0 for k in launches}
    want["selective_scan"] = cfg.num_layers
    if launches != want:
        fail(f"mamba full depth: launches {launches} in one scoring pass; "
             f"expected {want}")
    if tuple(scores.shape) != (SCAN_B,) or not torch.isfinite(scores).all() \
            or (scores < 0).any():
        fail(f"mamba full depth: scores {scores.tolist()}")
    pass_ms = [time_events(scorer, [(params, batch)], 1)
               for _ in range(rounds)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out = {"layers": cfg.num_layers, "params": n_params, "tokens":
           [SCAN_B, SCAN_S], "launches": launches, "first_pass_s": first_s,
           "pass_ms": pass_ms, "peak_mem_gib": peak_gib,
           "scores": scores.tolist(), "card_after": card_state()}
    print(f"mamba full depth: falcon-mamba-7b × {cfg.num_layers} layers "
          f"({n_params / 1e9:.2f} B params, {cfg.dtype}), logit_grad scorer "
          f"with "
          f"ssm_mode='pallas' over {SCAN_B} × {SCAN_S} tokens: launches "
          f"{launches}; first pass {first_s:.2f} s (host), then "
          f"{', '.join(f'{m:.1f}' for m in pass_ms)} ms a pass (CUDA "
          f"events); peak memory {peak_gib:.2f} GiB; clock, power, "
          f"temperature after: {out['card_after']}", flush=True)
    del params, train, scorer, batch
    torch.cuda.empty_cache()
    return out


def phase_mamba_parity():
    """falcon-mamba-7b at full width, 1 layer, f32: a logit_grad/pallas
    scoring pass (the kernel on the card, its plain version on the CPU), a
    ghost/ref scoring pass and a master step with injected indices, card
    against CPU."""
    from repro_torch.core.issgd import (ISSGDConfig, make_master_pass,
                                        make_scoring_pass)
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.core.weight_store import init_store
    from repro_torch.data import make_token_dataset
    from repro_torch.models.transformer import (init_transformer,
                                                per_example_loss)
    from repro_torch.optim import sgd, tree_leaves, tree_map

    cfg = dataclasses.replace(mamba_config(layers=1), dtype="float32")
    n, sb, b, seq = 64, 4, 2, 64
    train = make_token_dataset(torch.Generator("cuda").manual_seed(71), n=n,
                               seq=seq + 1, vocab=cfg.vocab_size)
    params = init_transformer(torch.Generator("cuda").manual_seed(72), cfg,
                              "cuda")
    idx = torch.randint(0, n, (b,), generator=torch.Generator().manual_seed(73))
    tcfg = ISSGDConfig(batch_size=b, score_batch_size=sb, refresh_every=8)
    # lr 1e3: dt_bias and a_log are O(1–7) against gradients of O(1e-3), so
    # at lr 1 the update new − old would carry the f32 rounding of the
    # params themselves (~1e-4 of the update); at 1e3 it stands far above
    opt = sgd(1e3)
    out = {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        t0 = time.perf_counter()
        res = {}
        for strategy, mode in (("logit_grad", "pallas"), ("ghost", "ref")):
            scoring = make_scoring_pass(
                make_lm_scorer(cfg, strategy, ssm_mode=mode), tcfg, n)
            store, fresh, stale = scoring(p, init_store(n, dev), 0, data)
            res[f"scores {strategy}/{mode}"] = fresh.cpu()
        master = make_master_pass(
            lambda pp, bb: per_example_loss(pp, cfg, bb)[0], opt, tcfg, n)
        new_p, _, _, _, m = master(p, (), p, store, 0, None, data, fresh,
                                   stale, sample_indices=idx)
        deltas = tree_map(lambda a, c: (a - c).cpu(), new_p, p)
        res.update({"loss": m.loss.cpu(), "grad_norm": m.grad_norm.cpu(),
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}})
        out[dev] = res
        print(f"mamba parity: {dev} passes in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del p, new_p, deltas, data
    errs = {}
    for key, want in out["cpu"].items():
        card = out["cuda"][key]
        if key.startswith("scores"):   # elementwise: every score positive
            errs[key] = ((card - want).abs() / want.abs()).max().item()
        else:
            errs[key] = rel_err(card, want)
    worst = max(errs, key=errs.get)
    print(f"mamba parity: falcon-mamba-7b full width, 1 layer, f32, seq "
          f"{seq}, card (kernels) vs CPU (plain versions): largest relative "
          f"error {errs[worst]:.3e} ({worst}); "
          f"{json.dumps({k: f'{v:.2e}' for k, v in errs.items() if not k.startswith('update')})}",
          flush=True)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"mamba card vs CPU: {worst} relative error {errs[worst]:.3e} "
             f"> {CARD_VS_CPU_RTOL}")
    del params
    torch.cuda.empty_cache()
    return errs


def scan_bound(b, s, di, ds, elem) -> dict:
    """u and Δ read and y written once (``elem`` bytes each), B and C read
    once (their d_state columns), A and D once in f32; the operations are
    the exponentials, B·S·d_inner·d_state, one SFU result each (the f32
    arithmetic around them, ~6 flops an element, takes ~0.4 of that at
    67 TFLOP/s)."""
    nbytes = 3 * b * s * di * elem + 2 * b * s * ds * elem + (di * ds + di) * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = b * s * di * ds / SFU_PER_S * 1e3
    return {"bytes_ms": b_ms, "ops_ms": o_ms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "exps": b * s * di * ds, "flops_ms": 6.0 * b * s * di * ds
            / F32_FLOP_PER_S * 1e3}


def phase_mamba_times(train_mod, ss, ref, rounds=5):
    """The scan kernel at both main-path shapes, the full-depth pass's
    (u, Δ and y 268 MB each in bf16: every call finds them outside the 50
    MB L2) and the trainer's (67 MB each; two input sets rotated), against
    its plain version, CUDA events, in turns; a profiler window over a
    step of phase 20a's trainer at MAMBA_PROFILE_LAYERS.  Returns the
    full-depth pass's row with the trainer's under "shapes"."""
    rows = {}
    for tag, (b, s, di, ds), sets in (
            ("full-depth pass", (SCAN_B, SCAN_S, 8192, 16), 1),
            ("trainer", (MAMBA_SB, MAMBA_S, 8192, 16), 2)):
        args = [scan_inputs(b, s, di, ds, torch.bfloat16, seed=2200 + i,
                            falcon=True) for i in range(sets)]
        kern = lambda *a: ss.selective_scan(*a)
        plain = lambda *a: ref.selective_scan_kernel_ref(*a)
        with torch.no_grad():
            # plain, kernel, kernel, plain: compare within one call, in turns
            p1 = time_events(plain, args, 1)
            k1 = time_events(kern, args, rounds)
            k2 = time_events(kern, args, rounds)
            p2 = time_events(plain, args, 1)
        row = {"shape": [b, s, di, ds], "dtype": "bfloat16",
               "lanes": ss.LANES[ds], "input_sets": sets, "ms": min(k1, k2),
               "plain_ms": min(p1, p2), "library_ms": None,
               **scan_bound(b, s, di, ds, 2), "ms_runs": [k1, k2],
               "plain_ms_runs": [p1, p2], "card_after": card_state()}
        print(f"mamba times: selective_scan {tag} (B, S, d_inner, d_state)="
              f"{(b, s, di, ds)} bf16, falcon-init Δ, L={row['lanes']}: "
              f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms; "
              f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} (bytes "
              f"{row['bytes_ms']:.4f}, exps on the SFU {row['ops_ms']:.4f}, "
              f"f32 arithmetic {row['flops_ms']:.4f}); clock, power, "
              f"temperature after: {row['card_after']}", flush=True)
        rows[tag] = row
        del args
        torch.cuda.empty_cache()
    # one profiled step: with remat the master's ref scan dispatches each
    # layer's ~23k ops twice, and reading one 10-layer step's events back
    # took ~80 s
    prof = phase_profile(train_mod, MAMBA_ARGV + ["--strategy",
                                                  "logit_grad"],
                         mamba_config(MAMBA_PROFILE_LAYERS), steps=1, warm=1,
                         tag=f"mamba profile (× {MAMBA_PROFILE_LAYERS} "
                             f"layers)", ssm_mode="pallas")
    row = dict(rows["full-depth pass"])
    row["shapes"] = rows
    return row, prof


# ------------------------------------------- slice 11: fused, ghost_rev,
# checkpoints, ASGD
def mlp_argv(*extra) -> list:
    """The mlp_svhn trainer of phase 3 (full width, 65,536 examples)."""
    return ["--arch", "mlp_svhn", "--batch", "64", "--score-batch", "256",
            "--examples", "65536", "--lr", "0.01", "--refresh-every", "8",
            "--device", "cuda", *extra]


def lww(n, idx, vals, fill):
    """The store column a last-write-wins write of vals at idx gives."""
    out = torch.full((n,), fill, dtype=vals.dtype)
    for i, v in zip(idx.tolist(), vals.cpu()):
        out[i] = v
    return out


def phase_fused(train_mod, ref):
    """Fused mode through the launcher at full width, then its per-step
    store contract, card vs CPU for a fused step and a probe, the
    duplicate-heavy last-write-wins write, and the step times."""
    from repro_torch.core import weight_store as ws
    from repro_torch.core.issgd import (ISSGDConfig, TrainState,
                                        make_master_pass, make_score_step)
    from repro_torch.core.scorer import make_mlp_scorer
    from repro_torch.configs.mlp_svhn import CONFIG as cfg
    from repro_torch.data import make_svhn_like
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.optim import sgd, tree_leaves, tree_map
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    argv = mlp_argv("--mode", "fused", "--probe-every", str(FUSED_PROBE))
    probes = len(range(0, FUSED_STEPS, FUSED_PROBE))
    reset_counts()
    result = run_forbidding_plain(ref, lambda: train_mod.main(
        argv + ["--steps", str(FUSED_STEPS), "--log-every", "1"]))
    launches = read_counts()
    want = {k: 0 for k in launches}
    want["per_example_sqnorm_multi"] = probes
    if launches != want:
        fail(f"fused: launches {launches} in {FUSED_STEPS} steps with "
             f"{probes} probes; expected {want}")
    for rec in result.history:
        if not all(math.isfinite(rec[k]) for k in keys):
            fail(f"fused: non-finite metrics at step {rec['step']}: {rec}")
    fused_ms = statistics.median(result.step_ms[WARMUP_STEPS:])
    del result

    # the store after each step, and where the kernel launches: step by
    # step through the launcher's `build`
    built = train_mod.build(train_mod.parse_args(argv))
    state, per_step, per_probe = built.state, [], []
    for i in range(2 * FUSED_PROBE + 1):
        before = read_counts()["per_example_sqnorm_multi"]
        state, m = run_forbidding_plain(
            ref, lambda: built.step(state, built.data))
        idx = m.sample_indices
        if not bool((state.store.scored_at[idx] == i).all()):
            fail(f"fused: rows sampled at step {i} are not stamped {i}")
        per_step.append(read_counts()["per_example_sqnorm_multi"] - before)
        if i % FUSED_PROBE == 0:
            before = read_counts()["per_example_sqnorm_multi"]
            state = run_forbidding_plain(
                ref, lambda: built.probe(state, built.data))
            per_probe.append(read_counts()["per_example_sqnorm_multi"]
                             - before)
    if set(per_step) != {0} or set(per_probe) != {1}:
        fail(f"fused: multi-tap launches a step {per_step}, a probe "
             f"{per_probe}; expected 0 and 1")
    probe_ms = statistics.median(step_times(
        lambda: built.probe(state, built.data), 20)[3:])
    del built, state
    relaxed = train_mod.build(train_mod.parse_args(mlp_argv()))
    carry = {"s": relaxed.state}

    def relaxed_step():
        carry["s"], _ = relaxed.step(carry["s"], relaxed.data)
    relaxed_ms = statistics.median(step_times(relaxed_step, 20)[3:])
    del relaxed, carry

    # one fused step and one probe, card vs CPU, same params and indices
    n = 4096
    train, _ = make_svhn_like(torch.Generator("cuda").manual_seed(21), n=n,
                              dim=cfg.input_dim)
    params = mlp_mod.init_mlp_classifier(torch.Generator().manual_seed(22),
                                         cfg, "cpu")
    idx = torch.randint(0, 512, (64,),
                        generator=torch.Generator().manual_seed(23))
    tcfg = ISSGDConfig(batch_size=64, score_batch_size=256, mode="fused")
    master = make_master_pass(
        None, sgd(0.01), tcfg, n,
        fused_score=lambda p, b: mlp_mod.per_example_loss_and_score(p, b,
                                                                    cfg))
    probe = make_score_step(make_mlp_scorer(cfg, "ghost"), tcfg, n)
    out, stamps = {}, {}
    for dev in ("cuda", "cpu"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p = tree_map(lambda t: t.to(dev), params)
        new_p, _, _, store, m = master(p, (), p, ws.init_store(n, dev), 0,
                                       None, data, sample_indices=idx)
        st = probe(TrainState(new_p, (), p, store, 1, None), data)
        deltas = tree_map(lambda a, b: a - b, new_p, p)
        out[dev] = {"loss": m.loss, "grad_norm": m.grad_norm,
                    "trace_stale": m.trace_stale,
                    "fused scores": store.weights[idx],
                    "probe scores": st.store.weights[256:512],
                    **{f"update {i}": t for i, t in
                       enumerate(tree_leaves(deltas))}}
        stamps[dev] = st.store.scored_at.cpu()
    if not torch.equal(stamps["cuda"], stamps["cpu"]):
        fail("fused: card and CPU stamps differ")
    errs = {k: rel_err(out["cuda"][k].cpu(), v)
            for k, v in out["cpu"].items()}
    worst = max(errs, key=errs.get)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"fused card vs CPU: {worst} relative error {errs[worst]:.3e}")

    # duplicate-heavy last-write-wins: B = 64 writes over 8 rows
    g = torch.Generator().manual_seed(24)
    didx = torch.randint(0, 8, (64,), generator=g)
    dvals = torch.randperm(64, generator=g).float() + 0.25
    stamps = torch.arange(64, dtype=torch.int32) + 100
    dup = {}
    for dev in ("cuda", "cpu"):
        base = ws.init_store(32, dev)
        dup[dev] = [ws.write_scores_global(base, didx.to(dev), dvals.to(dev),
                                           stamps.to(dev)) for _ in range(2)]
    a, b = dup["cuda"]
    c = dup["cpu"][0]
    if not (torch.equal(a.weights, b.weights)
            and torch.equal(a.scored_at, b.scored_at)
            and torch.equal(a.weights.cpu(), c.weights)
            and torch.equal(a.scored_at.cpu(), c.scored_at)
            and torch.equal(c.weights, lww(32, didx, dvals, 0.0))):
        fail("fused: the duplicate-heavy write_scores_global is not "
             "last-write-wins bitwise on the card")
    res = {"steps": FUSED_STEPS, "probe_every": FUSED_PROBE,
           "launches": launches, "probe_launches": per_probe,
           "fused_step_ms_median": fused_ms, "probe_ms_median": probe_ms,
           "relaxed_step_ms_median": relaxed_ms, "card_vs_cpu_rel_err": errs}
    print(f"fused: mlp_svhn full width, {FUSED_STEPS} steps, probe every "
          f"{FUSED_PROBE}: launches {launches}; a fused step 0 multi-tap "
          f"launches, a probe 1; median fused step {fused_ms:.3f} ms, probe "
          f"{probe_ms:.3f} ms, relaxed step {relaxed_ms:.3f} ms (CUDA "
          f"events); card vs CPU largest relative error {errs[worst]:.3e} "
          f"({worst}); 64 writes over 8 rows last-write-wins, bitwise as "
          f"the CPU and run to run", flush=True)
    return res


def score_pass(ref, scorer, params, batch, rounds, what):
    """(scores, median ms of ``rounds`` timed passes after the counted
    one, peak GiB, launches of one pass); every plain version forbidden
    in the counted pass, and its attention and ghost-norm launches all of
    the tensor-core instances."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sc = run_forbidding_plain(ref, lambda: scorer(params, batch))
    launches = read_counts()
    check_tc(launches, what)
    launches["flash_attention_bwd scored"] = \
        kernel_wrappers()["flash_attention_bwd"].scored
    ms = statistics.median(step_times(lambda: scorer(params, batch),
                                      rounds))
    peak = torch.cuda.max_memory_allocated() / 2**30
    return sc, ms, peak, launches


def phase_ghost_rev(train_mod, ref):
    """glm4-9b at full width on the flash path: (a) ghost_rev against
    ghost at the 4-layer cut, fused then separate, (b) one ghost_rev pass
    at full depth, (c) a --strategy ghost_rev trainer at phase 7's cut."""
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    out = {"cut": {}}
    cfg = lm_config()
    params = transformer.init_transformer(
        torch.Generator("cuda").manual_seed(31), cfg, "cuda")
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (REV_B, REV_S + 1),
        generator=torch.Generator("cuda").manual_seed(32), device="cuda")}
    for variant in ("fused", "separate"):
        row = {}
        for strategy in ("ghost", "ghost_rev"):
            sc, ms, peak, launches = score_pass(ref, make_lm_scorer(
                cfg, strategy, attn_impl="flash", attn_scores=variant),
                params, batch, 3, f"{strategy} {variant}")
            row[strategy] = {"scores": sc, "pass_ms": ms, "peak_gib": peak,
                             "launches": launches}
        err = ((row["ghost_rev"]["scores"] - row["ghost"]["scores"]).abs()
               / row["ghost"]["scores"]).max().item()
        if not err <= REV_RTOL:
            fail(f"ghost_rev {variant}: relative error {err:.3e} against "
                 f"ghost at {LM_LAYERS} layers")
        got = row["ghost_rev"]["launches"]
        want_rev = {"ghost_norm": 4 * LM_LAYERS + 1,
                    "flash_attention": 2 * LM_LAYERS,
                    "flash_attention_bwd": LM_LAYERS,
                    "attn_score_sweep": LM_LAYERS if variant == "separate"
                    else 0}
        if any(got[k] != v for k, v in want_rev.items()):
            fail(f"ghost_rev {variant}: launches {got}, expected {want_rev}")
        for r in row.values():
            del r["scores"]
        out["cut"][variant] = {"rel_err_vs_ghost": err, **row}
        print(f"ghost_rev ({variant}): glm4-9b × {LM_LAYERS} layers, seq "
              f"{REV_S}, score batch {REV_B}: relative error vs ghost "
              f"{err:.3e}; ghost {row['ghost']['pass_ms']:.2f} ms, peak "
              f"{row['ghost']['peak_gib']:.2f} GiB; ghost_rev "
              f"{row['ghost_rev']['pass_ms']:.2f} ms, peak "
              f"{row['ghost_rev']['peak_gib']:.2f} GiB; launches {got}",
              flush=True)
    del params
    torch.cuda.empty_cache()

    cfg = lm_config(REV_FULL_LAYERS)
    params = transformer.init_transformer(
        torch.Generator("cuda").manual_seed(33), cfg, "cuda")
    sc, ms, peak, launches = score_pass(ref, make_lm_scorer(
        cfg, "ghost_rev", attn_impl="flash", attn_scores="fused"), params,
        batch, 2, "ghost_rev full depth")
    want = {"ghost_norm": 4 * REV_FULL_LAYERS + 1,
            "flash_attention": 2 * REV_FULL_LAYERS,
            "flash_attention_bwd": REV_FULL_LAYERS,
            "flash_attention_bwd scored": REV_FULL_LAYERS,
            "attn_score_sweep": 0, "per_example_sqnorm_multi": 0,
            "per_example_sqnorm": 0, "decode_attention": 0,
            "selective_scan": 0}
    if launches != want:
        fail(f"ghost_rev full depth: launches {launches}, expected {want}")
    if not bool(torch.isfinite(sc).all() and (sc > 0).all()):
        fail(f"ghost_rev full depth: scores {sc}")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    torch.cuda.empty_cache()
    out["full_depth"] = {"layers": REV_FULL_LAYERS, "params": n_params,
                         "pass_ms": ms, "peak_gib": peak,
                         "launches": launches,
                         "scores": [round(v, 4) for v in sc.tolist()]}
    print(f"ghost_rev full depth: glm4-9b × {REV_FULL_LAYERS} layers "
          f"({n_params / 1e9:.2f} B params, bf16), seq {REV_S}, score batch "
          f"{REV_B}, attn_scores='fused': one pass {ms:.1f} ms (CUDA events, "
          f"median of 2 after a warm-up), peak {peak:.2f} GiB, launches "
          f"{launches}, scores {sc.min().item():.4f}..{sc.max().item():.4f}",
          flush=True)

    # (c) the trainer: phase 7's cut with --strategy ghost_rev
    reset_counts()
    argv = [a if a != "ghost" else "ghost_rev" for a in LM_ARGV]
    result = run_forbidding_plain(ref, lambda: train_mod.main(
        argv + ["--steps", str(REV_TRAIN_STEPS), "--log-every", "1"],
        lm_config()))
    launches = read_counts()
    if launches["ghost_norm"] != (7 * LM_LAYERS + 1) * REV_TRAIN_STEPS:
        fail(f"ghost_rev trainer: ghost_norm {launches['ghost_norm']} in "
             f"{REV_TRAIN_STEPS} steps; expected {7 * LM_LAYERS + 1} a step")
    check_tc(launches, "ghost_rev trainer")
    losses = [r["loss"] for r in result.history]
    if not all(math.isfinite(v) for v in losses):
        fail(f"ghost_rev trainer: losses {losses}")
    out["trainer"] = {"steps": REV_TRAIN_STEPS, "launches": launches,
                      "losses": losses, "step_ms": result.step_ms}
    del result
    torch.cuda.empty_cache()
    print(f"ghost_rev trainer: glm4-9b × {LM_LAYERS} layers, seq {LM_S}, "
          f"{REV_TRAIN_STEPS} steps, losses {losses}, launches {launches}",
          flush=True)
    return out


def same_tree(a, b) -> bool:
    from repro_torch.optim import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def phase_checkpoint(train_mod):
    """2K relaxed steps of mlp_svhn at full width against K steps, save,
    restore into a template built from another seed, K more: bitwise; a
    glm4-9b period's bf16 params round trip on the card."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves, tree_map
    k = CKPT_K
    args = train_mod.parse_args(mlp_argv())
    full = train_mod.build(args)
    state, drawn = full.state, []
    for _ in range(2 * k):
        state, m = full.step(state, full.data)
        drawn.append(m.sample_indices)
    half = train_mod.build(args)
    hstate = half.state
    for _ in range(k):
        hstate, _ = half.step(hstate, half.data)
    ck_dir = ROOT / "build" / "chip_smoke"
    path = ck_dir / "mlp_svhn.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, hstate, step=hstate.step)
    save_s = time.perf_counter() - t0
    size_mb = path.stat().st_size / 1e6
    template = train_mod.build(train_mod.parse_args(
        mlp_argv("--seed", "7"))).state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed, ck_step = restore_checkpoint(path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template, hstate
    for i in range(k):
        resumed, m = half.step(resumed, half.data)
        if not torch.equal(m.sample_indices, drawn[k + i]):
            fail(f"checkpoint: step {k + i + 1}'s draws differ after the "
                 f"restore")
    if not (ck_step == k and resumed.step == state.step
            and same_tree(resumed.params, state.params)
            and same_tree(resumed.stale_params, state.stale_params)
            and torch.equal(resumed.store.weights, state.store.weights)
            and torch.equal(resumed.store.scored_at,
                            state.store.scored_at)):
        fail("checkpoint: the resumed run differs from the uninterrupted "
             "one")
    del full, half, state, resumed
    # a glm4-9b period's params at full width, bf16, on the card
    period = transformer.init_transformer(
        torch.Generator("cuda").manual_seed(41), lm_config(1),
        "cuda")["layers"]
    ppath = ck_dir / "glm4_period.npz"
    save_checkpoint(ppath, period, step=0)
    tmpl = tree_map(torch.zeros_like, period)
    back, _ = restore_checkpoint(ppath, tmpl)
    pairs = list(zip(tree_leaves(back), tree_leaves(period)))
    if not all(a.dtype == b.dtype == torch.bfloat16 and a.device == b.device
               and torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in pairs):
        fail("checkpoint: a glm4-9b period's bf16 params did not round trip "
             "bitwise on the card")
    psize = ppath.stat().st_size / 1e6
    path.unlink()
    ppath.unlink()
    res = {"k": k, "save_s": save_s, "restore_s": restore_s,
           "file_mb": size_mb, "period_file_mb": psize}
    print(f"checkpoint: mlp_svhn relaxed, {2 * k} steps == {k} + save + "
          f"restore (template of seed 7) + {k}, bitwise incl. the draws; "
          f"save {save_s:.3f} s, restore {restore_s:.3f} s, file "
          f"{size_mb:.1f} MB; a glm4-9b period ({psize:.1f} MB bf16) "
          f"round trips bitwise", flush=True)
    return res


def phase_asgd(ref):
    """The ASGD baseline's §6 issgd mode at full width, delay 4: steps
    with finite losses, the store's last-write-wins rows, and one step
    card vs CPU from the state the card reached, with injected draws."""
    from repro_torch.configs.mlp_svhn import CONFIG as cfg
    from repro_torch.core import asgd
    from repro_torch.core.sampler import sample_indices
    from repro_torch.core.weight_store import read_proposal
    from repro_torch.data import gather_batch, make_svhn_like
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.optim import sgd, tree_leaves, tree_map
    fused = lambda p, b: mlp_mod.per_example_loss_and_score(p, b, cfg)
    pel = lambda p, b: mlp_mod.per_example_loss(p, b, cfg)
    acfg = asgd.ASGDConfig(batch_size=64, delay=ASGD_DELAY, mode="issgd")
    n = 65536
    train, _ = make_svhn_like(torch.Generator("cuda").manual_seed(51), n=n,
                              dim=cfg.input_dim)
    params = mlp_mod.init_mlp_classifier(
        torch.Generator("cuda").manual_seed(52), cfg, "cuda")
    opt = sgd(0.01)
    step = asgd.make_asgd_step(pel, opt, acfg, n, fused_score=fused)
    state = asgd.init_asgd_state(params, opt, acfg, n, "cuda", seed=53)
    reset_counts()
    losses, ms = [], []
    for i in range(ASGD_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = run_forbidding_plain(
            ref, lambda: step(state, train.arrays))
        end.record()
        ms.append((start, end))
        losses.append(m.loss)
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in ms]
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        fail(f"asgd: losses {losses}")
    launches = read_counts()
    if any(launches.values()):
        fail(f"asgd: kernel launches {launches}; the §6 step runs none")
    # last-write-wins at drawn indices that repeat: the rows hold the
    # last position's score, recomputed on the same card
    proposal = read_proposal(state.store, state.step, acfg.is_cfg)
    idx = sample_indices(proposal, 64,
                         generator=torch.Generator("cuda").manual_seed(54))
    idx[32:] = idx[:32].flip(0)          # every row drawn twice
    _, scores = fused(state.fifo[0], gather_batch(train.arrays, idx))
    after, _ = step(state, train.arrays, sample_indices=idx)
    rows = torch.unique(idx)
    want_w = lww(n, idx.cpu(), scores.detach().cpu(), 0.0)[rows.cpu()]
    if not (torch.equal(after.store.weights[rows].cpu(), want_w)
            and bool((after.store.scored_at[rows] == state.step).all())):
        fail("asgd: the store rows at the drawn indices are not the last "
             "write's")
    del after
    # card vs CPU: one step from the state the card reached (its store,
    # FIFO and step copied), with the same injected draws
    draws = torch.randint(0, n, (64,),
                          generator=torch.Generator().manual_seed(55))
    out = {}
    for dev in ("cuda", "cpu"):
        move = lambda tree: tree_map(lambda t: t.to(dev), tree)
        st = asgd.ASGDState(
            move(state.params), (), tuple(move(f) for f in state.fifo),
            type(state.store)(*(None if t is None else t.to(dev)
                                for t in state.store)),
            state.step, torch.Generator(dev))
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        stp = asgd.make_asgd_step(pel, opt, acfg, n, fused_score=fused)
        new, m = stp(st, data, sample_indices=draws)
        out[dev] = {"loss": m.loss, "grad_norm": m.grad_norm,
                    "delay_gap": m.delay_gap,
                    "written scores": new.store.weights[draws.to(dev)],
                    **{f"update {i}": a - b for i, (a, b) in
                       enumerate(zip(tree_leaves(new.params),
                                     tree_leaves(st.params)))}}
        del st, new, data
    errs = {k: rel_err(out["cuda"][k].cpu(), v)
            for k, v in out["cpu"].items()}
    worst = max(errs, key=errs.get)
    if errs[worst] > CARD_VS_CPU_RTOL:
        fail(f"asgd card vs CPU: {worst} relative error {errs[worst]:.3e}")
    step_ms = statistics.median(ms[ASGD_DELAY + 1:])
    print(f"asgd: mlp_svhn full width, issgd mode, delay {ASGD_DELAY}, "
          f"{ASGD_STEPS} steps, loss {losses[0]:.4f} → {losses[-1]:.4f}, "
          f"median step {step_ms:.3f} ms (CUDA events); 64 draws (each row "
          f"twice) written last-write-wins; one step card vs CPU from the "
          f"state after step {ASGD_STEPS}, largest relative error "
          f"{errs[worst]:.3e} ({worst})", flush=True)
    return {"steps": ASGD_STEPS, "delay": ASGD_DELAY, "losses": losses,
            "step_ms_median": step_ms, "card_vs_cpu_rel_err": errs}


# ------------------------------------ slice 12: telemetry, strategies and
# the controller, the billion-row sampling structures
def same_store(a, b) -> bool:
    """Every field of two weight stores bitwise equal."""
    return all((x is None and y is None)
               or (x is not None and y is not None and torch.equal(x, y))
               for x, y in zip(a, b))


def scratch_dir(name: str) -> Path:
    """An empty directory under the git-ignored build/ of the checkout."""
    d = ROOT / "build" / name
    d.mkdir(parents=True, exist_ok=True)
    for p in d.iterdir():
        if p.is_file():
            p.unlink()
    return d


def counted_run(train_mod, ref, argv, cfg=None, allow=(), **run_kw):
    """(TrainResult, launches) of one launcher run with every plain
    version forbidden (but ``allow``), the counts set to 0 just before
    it; ``run_kw`` go to ``run`` (attn_impl, attn_scores, ssm_mode)."""
    reset_counts()
    result = run_forbidding_plain(ref, lambda: train_mod.run(
        train_mod.parse_args(argv), cfg, **run_kw), allow=allow)
    return result, read_counts()


def expect_launches(launches: dict, want: dict, what: str) -> None:
    """Fail unless each kernel named in ``want`` launched that often and
    every other kernel never."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        fail(f"{what}: launches {launches}; expected {full}")


def phase_telemetry(train_mod, ref):
    """mlp_svhn at full width, relaxed, ghost, TEL_STEPS steps: telemetry
    off, then --monitors all with a JSONL every 10 steps; params and
    store bitwise the same; the monitors on the card against the CPU on
    the same store; the JSONL read back by tools/metrics_report.py; a
    --profile-dir window whose trace names the multi-tap kernel."""
    from repro_torch.core.importance import ISConfig
    from repro_torch.core.weight_store import read_proposal
    from repro_torch.telemetry import MONITOR_NAMES, MonitorSet
    from repro_torch.telemetry.events import read_events
    from repro_torch.telemetry.monitors import proposal_monitors
    d = scratch_dir("chip_smoke_telemetry")
    jsonl = d / "run.jsonl"
    steps = ["--steps", str(TEL_STEPS), "--seed", "7"]
    off, off_l = counted_run(train_mod, ref, mlp_argv(*steps))
    on, on_l = counted_run(train_mod, ref, mlp_argv(
        *steps, "--monitors", "all", "--metrics-jsonl", str(jsonl),
        "--metrics-every", "10"))
    for what, launches in (("telemetry off", off_l), ("telemetry on", on_l)):
        expect_launches(launches, {"per_example_sqnorm_multi": TEL_STEPS},
                        what)
    if not (same_tree(off.state.params, on.state.params)
            and same_store(off.state.store, on.state.store)):
        fail("telemetry: params or store with monitors on differ from off")
    off_ms = statistics.median(off.step_ms[WARMUP_STEPS:])
    on_ms = statistics.median(on.step_ms[WARMUP_STEPS:])

    # the monitors of the store the run reached, card vs CPU
    store, step = on.state.store, on.state.step
    mons = {}
    for dev in ("cuda", "cpu"):
        st = type(store)(*(None if t is None else t.to(dev) for t in store))
        q = read_proposal(st, step, ISConfig())
        mons[dev] = proposal_monitors(st, q, step, q.shape[0],
                                      MonitorSet.all())
    mon_err = {}
    for k in MONITOR_NAMES:
        a, b = mons["cuda"][k].cpu(), mons["cpu"][k]
        mon_err[k] = (0.0 if torch.equal(a, b) else
                      abs(a.double().item() - b.double().item())
                      / abs(b.double().item()))
    if max(mon_err.values()) > MON_RTOL:
        fail(f"telemetry: monitors card vs CPU {mon_err} > {MON_RTOL}")

    # the JSONL through the unmodified report
    recs = read_events(str(jsonl))
    mets = [r for r in recs if r["kind"] == "metrics"]
    mon_recs = [r for r in recs if r["kind"] == "monitors"]
    summary_path = d / "summary.json"
    rep = subprocess.run([sys.executable, str(ROOT / "tools" /
                                              "metrics_report.py"),
                          str(jsonl), "--json", str(summary_path)],
                         capture_output=True, text=True, timeout=120)
    if rep.returncode != 0:
        fail(f"metrics_report.py exited {rep.returncode}: "
             f"{rep.stderr[-1500:]}")
    summary = json.loads(summary_path.read_text())
    traj = summary["trajectory"]
    want_steps = sorted(set(range(0, TEL_STEPS, 10)) | {TEL_STEPS - 1})
    if [r["step"] for r in traj] != want_steps or \
            [r["step"] for r in mon_recs] != want_steps or \
            any(row[k] != m[k] for row, m in zip(traj, mets)
                for k in ("trace_ideal", "trace_stale", "trace_unif",
                          "loss")) or \
            summary["spans"]["train.step"]["count"] != TEL_STEPS:
        fail(f"telemetry: metrics_report's summary does not reproduce the "
             f"run's records: {json.dumps(summary)[:1500]}")

    # a profiler window over steps 2..3 of a short run
    prof_dir = scratch_dir("chip_smoke_profile")
    pj = d / "profile.jsonl"
    _, prof_l = counted_run(train_mod, ref, mlp_argv(
        "--steps", "5", "--profile-dir", str(prof_dir), "--profile-steps",
        "2:2", "--metrics-jsonl", str(pj)))
    expect_launches(prof_l, {"per_example_sqnorm_multi": 5}, "profile run")
    trace = json.loads((prof_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace.get("traceEvents", [])}
    multi = sorted(n for n in names if "sqnorm_multi_kernel" in n)
    marks = [(r["step"], r["action"]) for r in read_events(str(pj))
             if r["kind"] == "profile"]
    if not multi or marks != [(2, "start"), (3, "stop")]:
        fail(f"telemetry: the profile window's trace names "
             f"{multi or 'no multi-tap kernel'}; profile records {marks}")
    mon_last = {k: mon_recs[-1][k] for k in MONITOR_NAMES}
    print(f"telemetry: mlp_svhn full width, {TEL_STEPS} steps: median step "
          f"{off_ms:.3f} ms off, {on_ms:.3f} ms with --monitors all and a "
          f"JSONL every 10 steps (CUDA events, same call); params and store "
          f"bitwise equal; monitors at the end {mon_last}, card vs CPU "
          f"largest relative error {max(mon_err.values()):.3e}; "
          f"metrics_report.py reproduced {len(traj)} metrics records; the "
          f"profile window's trace names {multi[0][:60]}", flush=True)
    return {"steps": TEL_STEPS, "step_ms_median_off": off_ms,
            "step_ms_median_on": on_ms, "launches": on_l,
            "profile_launches": prof_l, "monitors_last": mon_last,
            "monitors_card_vs_cpu_rel_err": mon_err,
            "report_records": len(traj)}


def phase_strategies(train_mod, ref, lm_ghost_ms):
    """The adaptive controller at mlp_svhn full width with its decisions
    replayed from the JSONL; the gate against the uniform and relaxed
    steps bitwise; the zoo's scorers' step ms and launches; glm4-9b at
    phase 7's cut with upper_bound and every monitor."""
    from repro_torch.core.controller import replay_decisions
    from repro_torch.telemetry.events import read_events
    d = scratch_dir("chip_smoke_controller")
    jsonl = d / "adaptive.jsonl"
    res, ad_l = counted_run(train_mod, ref, mlp_argv(
        "--steps", str(ADAPT_STEPS), "--adaptive-is", "--adapt-every",
        str(ADAPT_EVERY), "--metrics-jsonl", str(jsonl)))
    expect_launches(ad_l, {"per_example_sqnorm_multi": ADAPT_STEPS},
                    "adaptive")
    live = [tuple(x) for x in res.decisions]
    replay = [tuple(x) for x in replay_decisions(read_events(str(jsonl)))]
    if len(live) != ADAPT_STEPS // ADAPT_EVERY or replay != live:
        fail(f"controller: live decisions {live} != replayed {replay}")
    adapt_ms = statistics.median(res.step_ms[WARMUP_STEPS:])
    del res

    # the gate, 10 steps a side, against the mode it selects
    gated = train_mod.build(train_mod.parse_args(mlp_argv("--adaptive-is")))
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    for use_is, mode in ((False, "uniform"), (True, "relaxed")):
        other = train_mod.build(train_mod.parse_args(mlp_argv(
            "--mode", mode)))
        a = gated.state._replace(rng=gen())
        b = gated.state._replace(rng=gen())
        for t in range(GATE_STEPS):
            a, ma = gated.step(a, gated.data, use_is)
            b, mb = other.step(b, gated.data)
            if not torch.equal(ma.sample_indices, mb.sample_indices):
                fail(f"gate {use_is}: step {t} draws differ from {mode}")
        if not (same_tree(a.params, b.params) and same_store(a.store,
                                                             b.store)):
            fail(f"gate {use_is}: state after {GATE_STEPS} steps differs "
                 f"from the {mode} step's")
        del other, a, b
    del gated

    # the zoo at mlp_svhn full width: step ms and a scoring pass's launches
    zoo = {}
    for name in ("ghost", "upper_bound", "bandit_mixed", "null"):
        built = train_mod.build(train_mod.parse_args(mlp_argv(
            "--proposal-strategy", name)))
        carry = {"s": built.state}

        def one():
            carry["s"], _ = built.step(carry["s"], built.data)
        reset_counts()
        run_forbidding_plain(ref, one)
        launches = read_counts()
        ms = statistics.median(step_times(one, ZOO_STEPS)[3:])
        zoo[name] = {"step_ms_median": ms, "launches_a_pass": launches}
        del built, carry
    want = {"ghost": 1, "upper_bound": 0, "bandit_mixed": 0, "null": 0}
    for name, n_multi in want.items():
        expect_launches(zoo[name]["launches_a_pass"],
                        {"per_example_sqnorm_multi": n_multi},
                        f"{name} scoring pass")

    # glm4-9b at phase 7's cut, upper_bound with every monitor
    torch.cuda.empty_cache()
    lj = d / "lm_upper_bound.jsonl"
    lm, lm_l = counted_run(train_mod, ref, LM_ARGV + [
        "--proposal-strategy", "upper_bound", "--monitors", "all",
        "--steps", str(LM_UB_STEPS), "--log-every", "1", "--metrics-jsonl",
        str(lj)], lm_config())
    expect_launches(lm_l, {}, "glm4-9b upper_bound (forward-only scorer, "
                              "ref attention)")
    mon = [r for r in read_events(str(lj)) if r["kind"] == "monitors"]
    if len(mon) != LM_UB_STEPS or not all(
            math.isfinite(r[k]) for r in mon for k in ("ess", "entropy")):
        fail(f"glm4-9b upper_bound: monitors {mon[-1:]}")
    if not all(math.isfinite(r["loss"]) for r in lm.history):
        fail(f"glm4-9b upper_bound: losses {lm.history}")
    lm_ms = statistics.median(lm.step_ms[LM_WARMUP:])
    del lm
    torch.cuda.empty_cache()
    print(f"strategies: adaptive mlp_svhn {ADAPT_STEPS} steps, decisions "
          f"{[(x[0], x[1], x[3], x[6]) for x in live]} (step, use_is, "
          f"var_ratio, reason) replayed exactly, median "
          f"step {adapt_ms:.3f} ms; gate closed == uniform and open == "
          f"relaxed bitwise over {GATE_STEPS} steps each; median step ms "
          + ", ".join(f"{k} {v['step_ms_median']:.3f}" for k, v in
                      zoo.items())
          + f"; glm4-9b × {LM_LAYERS} layers upper_bound + monitors "
          f"{lm_ms:.3f} ms a step, launches {lm_l} (ghost {lm_ghost_ms:.3f} "
          f"ms, phase 7, same call)", flush=True)
    return {"adaptive": {"steps": ADAPT_STEPS, "adapt_every": ADAPT_EVERY,
                         "decisions": live, "step_ms_median": adapt_ms,
                         "launches": ad_l},
            "gate_steps": GATE_STEPS, "zoo": zoo,
            "lm_upper_bound": {"step_ms_median": lm_ms, "launches": lm_l,
                               "ghost_step_ms_median_phase7": lm_ghost_ms,
                               "monitors_last": mon[-1]}}


def timed_ms(fn, rounds):
    """Median CUDA-event ms of ``rounds`` calls of fn() after one."""
    fn()
    return statistics.median(step_times(fn, rounds))


def tv_distance(p: torch.Tensor, q: torch.Tensor, parts: int = 16) -> float:
    """TV(p/Σp, q/Σq), summed in f64 over slices (bounded temporaries)."""
    sp = torch.sum(p, dtype=torch.float64)
    sq = torch.sum(q, dtype=torch.float64)
    tv = torch.zeros((), dtype=torch.float64, device=p.device)
    for a, b in zip(p.chunk(parts), q.chunk(parts)):
        tv += torch.sum(torch.abs(a.double() / sp - b.double() / sq))
    return 0.5 * tv.item()


def phase_large_tables(train_mod, ref):
    """(a) the mlp_svhn trainer with --index tree --table-dtype int8
    --index-chunk-size 1024 --score-ttl 20 against --index dense, bitwise;
    (b) the sampling structures at N = 2^30 rows, chunk 1024."""
    from repro_torch.core import mass_index as mi
    from repro_torch.core import weight_store as ws
    from repro_torch.core.importance import ISConfig
    from repro_torch.core.sampler import cumsum, two_stage_sample
    # the draws' CDF scan, run to run: over one row, torch.cumsum takes
    # CUB's look-back scan on the card, whose sums vary; sampler.cumsum
    # (the draws' scan) must not
    gs = torch.Generator(device="cuda").manual_seed(60)
    noise = torch.empty(2**24, device="cuda")
    scan_diff = {}
    for rows in (65536, 2**20):
        x = torch.rand(1, rows, generator=gs, device="cuda") * 4 + 1
        for name, fn in (("torch.cumsum", torch.cumsum),
                         ("sampler.cumsum", cumsum)):
            first, diff = fn(x, 1), 0
            for i in range(SCAN_REPEATS):
                if i % 3 == 0:
                    noise.normal_(generator=gs)   # other work in between
                diff += int(not torch.equal(fn(x, 1), first))
            scan_diff[f"{name} of {rows} rows"] = diff
    del noise, x
    if any(v for k, v in scan_diff.items() if k.startswith("sampler")):
        fail(f"large tables: the draws' CDF scan varies run to run: "
             f"{scan_diff} of {SCAN_REPEATS} repeats")
    big = ("--steps", str(BIG_STEPS), "--table-dtype", "int8",
           "--index-chunk-size", str(BIG_CHUNK), "--score-ttl", "20")
    runs = {}
    for index in ("tree", "dense"):
        runs[index] = counted_run(train_mod, ref,
                                  mlp_argv(*big, "--index", index))
        expect_launches(runs[index][1],
                        {"per_example_sqnorm_multi": BIG_STEPS},
                        f"int8 trainer, index {index}")
    (tr, tr_l), (dn, _) = runs["tree"], runs["dense"]
    if tr.state.store.weights.dtype != torch.int8 or not (
            same_tree(tr.state.params, dn.state.params)
            and same_store(tr.state.store, dn.state.store)):
        fail("large tables: the tree-index int8 trainer differs from the "
             "dense one")
    tr_ms = statistics.median(tr.step_ms[WARMUP_STEPS:])
    dn_ms = statistics.median(dn.step_ms[WARMUP_STEPS:])
    del runs, tr, dn

    # ---- N = 2^30 rows: the tables, the index, the draws, the bound
    n, cs = BIG_N, BIG_CHUNK
    c = n // cs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(61)
    w = torch.rand(n, generator=g, device="cuda").mul_(4.0)
    scored = torch.randint(-1, 100, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    step, cfg = 100, ISConfig()
    f32 = ws.WeightStore(w, scored)
    gib = lambda b: b / 2**30
    table_bytes = {"f32": w.numel() * 4, "bf16": n * 2,
                   "int8": n + c * 4, "scored_at": scored.numel() * 4}
    read_ms = timed_ms(lambda: ws.read_proposal(f32, step, cfg), 3)
    q = ws.read_proposal(f32, step, cfg)
    build_ms = timed_ms(lambda: mi.build_index(q, cs), 3)
    index0 = mi.build_index(q, cs)
    # a write into 8 chunks, refreshed against rebuilt
    ids = torch.randint(0, c, (8,), generator=g, device="cuda")
    rows = (ids[:, None] * cs + torch.randint(0, cs, (8, 4), generator=g,
                                              device="cuda")).reshape(-1)
    q_old = q[rows].clone()
    q[rows] = torch.rand(rows.shape[0], generator=g, device="cuda") * 9
    chunk_ids = rows // cs
    refresh_ms = timed_ms(lambda: mi.refresh_chunks(index0, q, cs,
                                                    chunk_ids), 5)
    rebuild_ms = timed_ms(lambda: mi.build_index(q, cs), 3)
    fresh = mi.refresh_chunks(index0, q, cs, chunk_ids)
    again = mi.build_index(q, cs)
    if not (torch.equal(fresh.mass, again.mass)
            and torch.equal(fresh.tree, again.tree)):
        fail("large tables: refresh_chunks != build_index at 2^30 rows")
    # the library reduction's bits depend on its row count: the reason
    # the leaves use the fixed pairwise halving
    rows_view, touched = q.view(c, cs), torch.unique(chunk_ids)
    n_touched = touched.shape[0]
    torch_sum_differ = int((torch.sum(rows_view[touched], 1)
                            != torch.sum(rows_view, 1)[touched]).sum())
    # 256 draws through the index vs the dense two-stage draw over
    # read_proposal (the proposal re-read, as a step does)
    dg = lambda: torch.Generator(device="cuda").manual_seed(62)
    draw_ms = timed_ms(lambda: mi.indexed_sample(q, fresh, cs, BIG_DRAWS,
                                                 generator=dg()), 5)
    dense_ms = timed_ms(lambda: two_stage_sample(
        ws.read_proposal(f32, step, cfg), BIG_DRAWS, generator=dg()), 3)
    idx = mi.indexed_sample(q, fresh, cs, BIG_DRAWS, generator=dg())
    if not (bool((idx >= 0).all()) and bool((idx < n).all())
            and bool((q[idx] > 0).all())):
        fail("large tables: indexed draws out of the support")
    q[rows] = q_old
    del fresh, again, index0, rows_view, touched, q_old

    # the quantized tables: TV against the bound, one int8 write
    tv, bound = {}, {}
    for dtype in ("bf16", "int8"):
        if dtype == "bf16":
            store = ws.WeightStore(w.to(torch.bfloat16), scored)
        else:
            codes, qscale = ws.quantize_weights(w, cs)
            store = ws.WeightStore(codes, scored, qscale)
            del codes, qscale
        pq = ws.read_proposal(store, step, cfg)
        tv[dtype] = tv_distance(q, pq)
        del pq
        bound[dtype] = ws.quantization_tv_bound(f32, step, cfg, cs,
                                                dtype).item()
        if dtype == "int8":
            wi = torch.unique(torch.randint(0, n, (BIG_DRAWS,), generator=g,
                                            device="cuda"))
            wv = torch.rand(wi.shape[0], generator=g, device="cuda") * 5
            write_ms = timed_ms(lambda: ws.write_scores(store, wi, wv, step),
                                2)
            after = ws.write_scores(store, wi, wv, step)
            got = ws.dequantize_weights(after)[wi]
            scale = after.qscale[wi // cs]
            if not bool((torch.abs(got - wv) <= scale / 254 * 1.001).all()):
                fail("large tables: the int8 write did not land within "
                     "half a step")
            del after, got
        del store
        torch.cuda.empty_cache()
        if not tv[dtype] <= bound[dtype]:
            fail(f"large tables: {dtype} TV {tv[dtype]:.3e} > bound "
                 f"{bound[dtype]:.3e}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if peak >= BIG_PEAK_GIB:
        fail(f"large tables: peak {peak:.2f} GiB at 2^30 rows")
    del w, scored, f32, q
    torch.cuda.empty_cache()
    res = {"scan_repeats_differing": scan_diff,
           "scan_repeats": SCAN_REPEATS,
           "trainer": {"steps": BIG_STEPS, "chunk": BIG_CHUNK,
                       "step_ms_median_tree": tr_ms,
                       "step_ms_median_dense": dn_ms, "launches": tr_l},
           "n": n, "chunk": cs, "chunks": c,
           "table_gib": {k: gib(v) for k, v in table_bytes.items()},
           "read_proposal_ms": read_ms, "build_index_ms": build_ms,
           "refresh_8_chunks_ms": refresh_ms, "rebuild_ms": rebuild_ms,
           "torch_sum_gather_vs_full_differing_chunks": torch_sum_differ,
           "touched_chunks": n_touched,
           "indexed_sample_ms": draw_ms, "dense_draw_ms": dense_ms,
           "draws": BIG_DRAWS, "int8_write_ms": write_ms, "tv": tv,
           "tv_bound": bound, "peak_gib": peak}
    print(f"large tables: repeated one-row scans differing from the first "
          f"(of {SCAN_REPEATS}): {scan_diff}; int8 trainer (chunk "
          f"{BIG_CHUNK}, ttl 20) tree == "
          f"dense bitwise over {BIG_STEPS} steps, median step "
          f"{tr_ms:.3f}/{dn_ms:.3f} ms; N = 2^{n.bit_length() - 1}: tables "
          + ", ".join(f"{k} {gib(v):.4f} GiB" for k, v in table_bytes.items())
          + f"; read_proposal {read_ms:.3f} ms, build_index {build_ms:.3f} "
          f"ms, refresh of 8 chunks {refresh_ms:.3f} ms vs rebuild "
          f"{rebuild_ms:.3f} ms (bitwise equal; torch.sum of the 8-chunk "
          f"gather differs from the full table's in {torch_sum_differ} of "
          f"{n_touched} chunks); {BIG_DRAWS} draws indexed "
          f"{draw_ms:.3f} ms vs dense over read_proposal {dense_ms:.3f} ms; "
          f"int8 write of {BIG_DRAWS} rows {write_ms:.3f} ms; TV bf16 "
          f"{tv['bf16']:.3e} ≤ {bound['bf16']:.3e}, int8 {tv['int8']:.3e} ≤ "
          f"{bound['int8']:.3e}; peak {peak:.2f} GiB", flush=True)
    return res


# ------------------------------------------------------- slice 13: the zoo
def zoo_config(arch, **kw):
    """``arch`` at its published widths (and depth), fields in ``kw``
    replaced."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **kw)


def median_after(ms, warm):
    return statistics.median(ms[warm:] if len(ms) > warm else ms)


def finite_history(result, what):
    keys = ("loss", "grad_norm", "trace_ideal", "trace_stale", "trace_unif")
    for rec in result.history:
        if not all(math.isfinite(rec[k]) for k in keys):
            fail(f"{what}: non-finite metrics at step {rec['step']}: {rec}")
    return [r["loss"] for r in result.history]


def tc_spy(ops, gn):
    """Patch ``ops.ghost_norm`` (the scorers' entry) with a pass-through
    that notes, for each call, ((din, dout), the path it takes: "tc" or
    "simt" for the kernel's instances by ``gn.uses_tensor_cores``, the
    wrapper's own rule, or "direct"); returns (notes, restore).  The
    kernel wrapper and its counts are untouched."""
    orig = ops.ghost_norm
    notes = []

    def spy(x, d, **kw):
        s, din, dout = x.shape[1], x.shape[-1], d.shape[-1]
        if ops.ghost_cost(s, din, dout) > ops.direct_cost(s, din, dout):
            path = "direct"
        else:
            path = "tc" if gn.uses_tensor_cores(x, d) else "simt"
        notes.append(((din, dout), path))
        return orig(x, d, **kw)

    ops.ghost_norm = spy

    def restore():
        ops.ghost_norm = orig
    return notes, restore


def instances(notes) -> dict:
    """'din->dout' → the paths its calls took, over ``notes``."""
    out = {}
    for (din, dout), path in notes:
        out.setdefault(f"{din}->{dout}", set()).add(path)
    return {k: "/".join(sorted(v)) for k, v in out.items()}


def phase_minicpm3(train_mod, ops, gn, ref):
    """minicpm3-4b (MLA) at full width: (a) the ghost_rev trainer at full
    depth, (b) ghost_rev against ghost at MINI_CUT layers, (c) one MLA
    layer and a one-layer ghost pass, f32, card vs CPU."""
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves, tree_map
    out = {}
    cfg = zoo_config("minicpm3-4b")
    # (a) full width, full depth, through the entry point
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    notes, restore = tc_spy(ops, gn)
    try:
        result, launches = counted_run(
            train_mod, ref, MINI_ARGV + ["--steps", str(MINI_STEPS),
                                         "--log-every", "1"])
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for t in tree_leaves(result.state.params))
    want = {"ghost_norm": (MLA_TAPS * cfg.num_layers + 1) * MINI_STEPS}
    expect_launches(launches, want, "minicpm3 trainer")
    tc = sum(path == "tc" for _, path in notes)
    losses = finite_history(result, "minicpm3 trainer")
    step_ms = median_after(result.step_ms, MINI_WARMUP)
    out["trainer"] = {
        "layers": cfg.num_layers, "params": n_params, "argv": MINI_ARGV,
        "steps": MINI_STEPS, "step_ms": result.step_ms,
        "step_ms_median": step_ms, "peak_gib": peak, "launches": launches,
        "ghost_norm_per_step": want["ghost_norm"] // MINI_STEPS,
        "ghost_norm_tc_per_step": tc / MINI_STEPS,
        "instances": instances(notes), "losses": losses}
    del result
    torch.cuda.empty_cache()
    print(f"minicpm3 trainer: minicpm3-4b × {cfg.num_layers} layers "
          f"({n_params / 1e9:.2f} B params, bf16), ghost_rev, seq 64, batch "
          f"32, score batch 128, {MINI_STEPS} steps: losses {losses}, "
          f"median step {step_ms:.1f} ms (CUDA events, {MINI_WARMUP} "
          f"warm-up), peak {peak:.2f} GiB; ghost_norm "
          f"{want['ghost_norm'] // MINI_STEPS} a step, {tc / MINI_STEPS:g} "
          f"of them tensor-core; instances (din->dout) "
          f"{out['trainer']['instances']}", flush=True)

    # (b) ghost_rev against ghost at the cut
    cut = zoo_config("minicpm3-4b", num_layers=MINI_CUT)
    params = transformer.init_transformer(
        torch.Generator("cuda").manual_seed(51), cut, "cuda")
    batch = {"tokens": torch.randint(
        0, cut.vocab_size, (MINI_CUT_B, MINI_CUT_S + 1),
        generator=torch.Generator("cuda").manual_seed(52), device="cuda")}
    row = {}
    for strategy in ("ghost", "ghost_rev"):
        reset_counts()
        sc, ms, pk, ln = score_pass(ref, make_lm_scorer(cut, strategy),
                                    params, batch, 3,
                                    f"minicpm3 {strategy}")
        row[strategy] = {"scores": sc, "pass_ms": ms, "peak_gib": pk,
                         "launches": ln}
    err = ((row["ghost_rev"]["scores"] - row["ghost"]["scores"]).abs()
           / row["ghost"]["scores"]).max().item()
    if not err <= REV_RTOL:
        fail(f"minicpm3 ghost_rev vs ghost at {MINI_CUT} layers: relative "
             f"error {err:.3e}")
    for strategy, n in (("ghost", MLA_TAPS + 1),
                        ("ghost_rev", MLA_TAPS * MINI_CUT + 1)):
        if row[strategy]["launches"]["ghost_norm"] != n:
            fail(f"minicpm3 {strategy}: launches "
                 f"{row[strategy]['launches']}; expected {n} ghost_norm")
    for r in row.values():
        del r["scores"]
    out["cut"] = {"layers": MINI_CUT, "rel_err_vs_ghost": err, **row}
    del params
    torch.cuda.empty_cache()
    print(f"minicpm3 ghost_rev vs ghost: × {MINI_CUT} layers, batch "
          f"{MINI_CUT_B}, seq {MINI_CUT_S}: relative error {err:.3e}; ghost "
          f"{row['ghost']['pass_ms']:.2f} ms, peak "
          f"{row['ghost']['peak_gib']:.2f} GiB; ghost_rev "
          f"{row['ghost_rev']['pass_ms']:.2f} ms, peak "
          f"{row['ghost_rev']['peak_gib']:.2f} GiB", flush=True)

    # (c) card vs CPU, f32, one layer
    one = zoo_config("minicpm3-4b", num_layers=1, dtype="float32")
    cpu_p = transformer.init_transformer(torch.Generator().manual_seed(53),
                                         one, "cpu")
    g = torch.Generator().manual_seed(54)
    x = torch.randn(2, 64, one.d_model, generator=g)
    toks = torch.randint(0, one.vocab_size, (4, 65), generator=g)
    errs = {}
    res = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), cpu_p)
        lp = transformer._period(p["layers"], 0)["l0"]["mixer"]
        pos = torch.arange(64, device=dev)[None].expand(2, 64)
        with torch.no_grad():
            y = attn_mod.mla(lp, x.to(dev), one, pos)
            loss, _ = transformer.per_example_loss(p, one,
                                                   {"tokens": toks.to(dev)})
        sc = make_lm_scorer(one, "ghost")(p, {"tokens": toks.to(dev)})
        res[dev] = {"mla": y.cpu(), "loss": loss.cpu(), "ghost": sc.cpu()}
    for k in res["cpu"]:
        errs[k] = rel_err(res["cuda"][k], res["cpu"][k])
    worst = max(errs.values())
    if worst > CARD_VS_CPU_RTOL:
        fail(f"minicpm3 card vs CPU: relative errors {errs}")
    out["card_vs_cpu_rel_err"] = errs
    print(f"minicpm3 card vs CPU (1 layer, f32, full width): relative "
          f"errors {errs}", flush=True)
    return out


def check_flash_shape(fa, fab, ref, b, s, h, hkv, hd, seed, name):
    """The bf16 flash forward and backward (with the fused score) at one
    main-path shape against their plain versions."""
    dt = torch.bfloat16
    q, k, v, o, lse, do = bwd_inputs(b, s, h, hkv, hd, 0, dt, seed, fa)
    po, plse = ref.flash_attention_kernel_ref(q, k, v, window=0,
                                              return_lse=True)
    ok, err = attn_close(o, po, dt)
    if not ok or not torch.allclose(lse, plse, **ATTN_F32):
        fail(f"{name}: forward vs plain max abs err {err:.3e}")
    *grads, sc = fab.flash_attention_bwd(q, k, v, o, lse, do, window=0,
                                         with_scores=True)
    *plain, psc = ref.flash_attention_bwd_kernel_ref(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        window=0, with_scores=True)
    errs = [err]
    for t, got, want in zip("qkv", grads, plain):
        ok, e = grads_close(got, want, dt)
        if not ok:
            fail(f"{name}: d{t} vs plain max abs err {e:.3e}")
        errs.append(e)
    sc_err = ((sc - psc).abs() / psc).max().item()
    if sc_err > SCORE_RTOL:
        fail(f"{name}: fused score vs plain rel err {sc_err:.3e}")
    print(f"{name}: (B, S, H, Hkv, hd)={(b, s, h, hkv, hd)} bf16, forward "
          f"and backward vs plain ok: max abs err {max(errs):.3e}, score "
          f"rel err {sc_err:.3e}", flush=True)
    return max(errs)


def moe_spy():
    """Patch ``models.moe.moe`` with a pass-through that keeps each call's
    dropped share (a device scalar), a forward's once: the backward's
    re-run of a rematerialised period is not kept; returns (shares,
    restore)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import remat
    orig = moe_mod.moe
    shares = []

    def spy(*a, **kw):
        out = orig(*a, **kw)
        if not remat.recomputing():
            shares.append(out.dropped_frac.detach())
        return out

    moe_mod.moe = spy

    def restore():
        moe_mod.moe = orig
    return shares, restore


def phase_dbrx(train_mod, fa, fab, ref):
    """dbrx-132b at full width, DBRX_LAYERS layers, the flash path with the
    fused score: (a) the trainer, (b) its flash shape against the plain
    versions, (c) two steps from one state and draws, bitwise, (d) one
    MoE layer, f32, card vs CPU with identical routing."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import tree_leaves, tree_map
    out = {}
    cfg = zoo_config("dbrx-132b", num_layers=DBRX_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shares, restore = moe_spy()
    try:
        result, launches = counted_run(
            train_mod, ref, DBRX_ARGV + ["--steps", str(DBRX_STEPS),
                                         "--log-every", "1"], cfg,
            allow=("ghost_norm_direct_ref",), attn_impl="flash",
            attn_scores="fused")
    finally:
        restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = {"flash_attention": 4 * DBRX_LAYERS,       # remat: 2 × 2
                "flash_attention_bwd": 2 * DBRX_LAYERS, "ghost_norm": 2}
    expect_launches(launches, {k: n * DBRX_STEPS for k, n in
                               per_step.items()}, "dbrx trainer")
    check_tc(launches, "dbrx trainer")
    scored = kernel_wrappers()["flash_attention_bwd"].scored
    if scored != DBRX_LAYERS * DBRX_STEPS:
        fail(f"dbrx trainer: {scored} scored backward launches; expected "
             f"{DBRX_LAYERS} a step")
    dropped = torch.stack(shares).float().cpu()
    n_params = sum(t.numel() for t in tree_leaves(result.state.params))
    losses = finite_history(result, "dbrx trainer")
    step_ms = median_after(result.step_ms, DBRX_WARMUP)
    out["trainer"] = {
        "layers": DBRX_LAYERS, "params": n_params, "argv": DBRX_ARGV,
        "attn_impl": "flash", "attn_scores": "fused", "steps": DBRX_STEPS,
        "step_ms": result.step_ms, "step_ms_median": step_ms,
        "peak_gib": peak, "launches": launches,
        "dropped_share": {"calls": len(shares),
                          "mean": dropped.mean().item(),
                          "max": dropped.max().item()},
        "losses": losses}
    del result, shares
    torch.cuda.empty_cache()
    print(f"dbrx trainer: dbrx-132b × {DBRX_LAYERS} layers "
          f"({n_params / 1e9:.2f} B params, bf16), flash + fused score, seq "
          f"{DBRX_S}, batch "
          f"{DBRX_B}, score batch {DBRX_SB}, {DBRX_STEPS} steps: losses "
          f"{losses}, median step {step_ms:.1f} ms (CUDA events, "
          f"{DBRX_WARMUP} warm-up), peak {peak:.2f} GiB, launches "
          f"{launches}; dropped share of replicas over "
          f"{dropped.numel()} MoE calls mean {dropped.mean().item():.4f}, "
          f"max {dropped.max().item():.4f}", flush=True)

    # (b) the GQA group of 6 at the trainer's attention shapes
    out["flash_max_abs_err"] = max(
        check_flash_shape(fa, fab, ref, b, DBRX_S, 48, 8, 128, 1700 + i,
                          f"dbrx flash ({tag})")
        for i, (tag, b) in enumerate((("master", DBRX_B),
                                      ("scorer", DBRX_SB))))

    # (c) two steps from one state and one draw: bitwise
    args = train_mod.parse_args(DBRX_ARGV + ["--steps", "1"])
    built = train_mod.build(args, cfg, attn_impl="flash",
                            attn_scores="fused")
    idx = torch.randint(0, DBRX_N, (DBRX_B,), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(61))
    runs = []
    for _ in range(2):
        st, m = run_forbidding_plain(ref, lambda: built.step(
            built.state, built.data, sample_indices=idx),
            allow=("ghost_norm_direct_ref",))
        # the first run's results wait on the host (15.5 GB of params)
        runs.append([t.cpu() for t in (*tree_leaves(st.params),
                                        st.store.weights, m.loss)])
        del st, m
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("dbrx: two steps from one state and one draw differ")
    del runs, built
    torch.cuda.empty_cache()
    out["bitwise_run_to_run"] = True
    print("dbrx: two steps from one state and one draw: params, scores and "
          "loss bitwise equal", flush=True)
    # where a step's time goes, and the expert bmms' sizes
    out["profile"] = phase_profile(
        train_mod, DBRX_ARGV, cfg, steps=2, warm=1, tag="dbrx profile",
        attn_impl="flash", attn_scores="fused")
    out["expert_bmms"] = {}
    for what, t in (("master", DBRX_B * DBRX_S), ("scorer", DBRX_SB * DBRX_S)):
        c = moe_mod.capacity(cfg, t)
        out["expert_bmms"][what] = {
            "tokens": t, "capacity": c, "buffer_rows": cfg.num_experts * c,
            "forward_gflop_a_layer": 3 * 2 * cfg.num_experts * c
            * cfg.d_model * cfg.d_ff / 1e9}
    print(f"dbrx expert bmms (E, C, {cfg.d_model}) x (E, {cfg.d_model}, "
          f"{cfg.d_ff}), E = {cfg.num_experts}: {out['expert_bmms']}",
          flush=True)
    torch.cuda.empty_cache()

    # (d) one MoE layer at full width, f32, card vs CPU
    one = zoo_config("dbrx-132b", num_layers=1, dtype="float32")
    p_card = moe_mod.init_moe(torch.Generator("cuda").manual_seed(62), one,
                              "cuda")
    x = torch.randn(2, 64, one.d_model,
                    generator=torch.Generator().manual_seed(63))
    res = {}
    for dev in ("cuda", "cpu"):
        p = p_card if dev == "cuda" else tree_map(lambda t: t.cpu(), p_card)
        xd = x.to(dev)
        with torch.no_grad():
            o = moe_mod.moe(p, xd, one)
            r = moe_mod.route((xd.reshape(-1, one.d_model)
                               @ p["router"]).float(), one)
        res[dev] = (o.y.cpu(), o.aux_loss.cpu(), o.dropped_frac.cpu(),
                    r.eidx.cpu(), r.keep.cpu())
        del p
    del p_card
    torch.cuda.empty_cache()
    (yc, ac, dc, ec, kc), (yh, ah, dh, eh, kh) = res["cuda"], res["cpu"]
    if not (torch.equal(ec, eh) and torch.equal(kc, kh)):
        fail("dbrx MoE layer: routing (expert ids or kept mask) differs "
             "card vs CPU")
    errs = {"y": rel_err(yc, yh), "aux_loss": rel_err(ac, ah),
            "dropped": abs(dc.item() - dh.item())}
    if max(errs.values()) > CARD_VS_CPU_RTOL:
        fail(f"dbrx MoE layer card vs CPU: {errs}")
    out["card_vs_cpu_rel_err"] = errs
    print(f"dbrx MoE layer card vs CPU (f32, full width, 16 experts of "
          f"10752, top-4, 128 tokens): routing identical, relative errors "
          f"{errs}", flush=True)
    return out


def phase_jamba(train_mod, ref):
    """jamba-v0.1-52b at full width in its smoke layout (l0 mamba + MLP,
    l1 attention + MoE): a logit_grad trainer on the scan kernel, then a
    ghost trainer (ref scan, flash attention)."""
    from repro_torch.optim import tree_leaves
    cfg = zoo_config("jamba-v0.1-52b", num_layers=2, attn_every=2,
                     attn_offset=1, moe_every=2, moe_offset=1)
    out = {}
    for leg, mode, impl, per_step in (
            ("logit_grad", "pallas", "ref", {"selective_scan": 1}),
            ("ghost", "ref", "flash",
             {"flash_attention": 4, "flash_attention_bwd": 2,   # remat
              "ghost_norm": 11})):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result, launches = counted_run(
            train_mod, ref, JAMBA_ARGV + ["--strategy", leg, "--steps",
                                          str(JAMBA_STEPS), "--log-every",
                                          "1"], cfg,
            allow=("ghost_norm_direct_ref",), attn_impl=impl, ssm_mode=mode)
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect_launches(launches, {k: n * JAMBA_STEPS
                                   for k, n in per_step.items()},
                        f"jamba {leg}")
        check_tc(launches, f"jamba {leg}")
        losses = finite_history(result, f"jamba {leg}")
        n_params = sum(t.numel() for t in tree_leaves(result.state.params))
        out[leg] = {"ssm_mode": mode, "attn_impl": impl,
                    "steps": JAMBA_STEPS, "step_ms": result.step_ms,
                    "peak_gib": peak, "launches": launches,
                    "losses": losses, "params": n_params}
        del result
        torch.cuda.empty_cache()
        print(f"jamba {leg}: jamba-v0.1-52b at full width, l0 mamba+MLP, "
              f"l1 attention+MoE ({n_params / 1e9:.2f} B params, bf16), "
              f"ssm_mode={mode!r}, attn_impl={impl!r}, {JAMBA_STEPS} steps: "
              f"losses {losses}, step ms {result_ms(out[leg])}, peak "
              f"{peak:.2f} GiB, launches {launches}", flush=True)
    return out


def result_ms(row):
    return ", ".join(f"{v:.1f}" for v in row["step_ms"])


def phase_musicgen(train_mod, ref):
    """musicgen-medium at full width and full depth: scoring with 64
    conditioning embeds before 64 tokens (logit_grad, ghost, ghost_rev on
    the flash path, the fused objective), then the trainer on tokens."""
    from repro_torch.core.scorer import make_lm_scorer
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    cfg = zoo_config("musicgen-medium")
    out = {}
    params = transformer.init_transformer(
        torch.Generator("cuda").manual_seed(71), cfg, "cuda")
    g = torch.Generator("cuda").manual_seed(72)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (MUSIC_SB, MUSIC_S + 1), generator=g,
                                     device="cuda"),
             "embeds": (torch.randn(MUSIC_SB, MUSIC_FRONT, cfg.d_model,
                                    generator=g, device="cuda")
                        * 0.02).to(torch.bfloat16)}
    layers = cfg.num_layers
    want = {"logit_grad": {},
            # remat: the forward runs again in the backward to the taps
            "ghost": {"ghost_norm": 8, "flash_attention": 2 * layers,
                      "flash_attention_bwd": layers},
            "ghost_rev": {"ghost_norm": 7 * layers + 1,
                          "flash_attention": 2 * layers,
                          "flash_attention_bwd": layers}}
    scores = {}
    for strategy, w in want.items():
        impl = "ref" if strategy == "logit_grad" else "flash"
        sc, ms, pk, ln = score_pass(ref, make_lm_scorer(
            cfg, strategy, attn_impl=impl), params, batch, 2,
            f"musicgen {strategy}")
        ln.pop("flash_attention_bwd scored")
        expect_launches(ln, w, f"musicgen {strategy}")
        if not bool(torch.isfinite(sc).all() and (sc > 0).all()):
            fail(f"musicgen {strategy}: scores {sc}")
        scores[strategy] = sc
        out[strategy] = {"attn_impl": impl, "pass_ms": ms, "peak_gib": pk,
                         "launches": ln}
    err = ((scores["ghost_rev"] - scores["ghost"]).abs()
           / scores["ghost"]).max().item()
    if not err <= REV_RTOL:
        fail(f"musicgen ghost_rev vs ghost: relative error {err:.3e}")
    with torch.no_grad():
        losses, fused = transformer.per_example_loss_and_score(params, cfg,
                                                               batch)
    if not torch.allclose(fused, scores["logit_grad"], rtol=1e-5,
                          atol=0) or not bool(torch.isfinite(losses).all()):
        fail("musicgen: the fused objective's score != the logit_grad "
             "scorer's")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, batch
    torch.cuda.empty_cache()
    out["ghost_rev_rel_err_vs_ghost"] = err
    out["params"] = n_params
    print(f"musicgen scoring: musicgen-medium × {layers} layers "
          f"({n_params / 1e9:.2f} B params, bf16), {MUSIC_FRONT} embeds + "
          f"{MUSIC_S} tokens, score batch {MUSIC_SB}: ghost_rev vs ghost "
          f"{err:.3e}; pass ms " + ", ".join(
              f"{k} {out[k]['pass_ms']:.1f} (peak {out[k]['peak_gib']:.2f} "
              f"GiB)" for k in want) + "; the fused objective's score == "
          "logit_grad's", flush=True)

    # the trainer on tokens alone, as the launcher runs it
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result, launches = counted_run(train_mod, ref, MUSIC_ARGV + [
        "--steps", str(MUSIC_STEPS), "--log-every", "1"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_launches(launches, {"ghost_norm": 8 * MUSIC_STEPS},
                    "musicgen trainer")
    check_tc(launches, "musicgen trainer")
    losses = finite_history(result, "musicgen trainer")
    out["trainer"] = {"steps": MUSIC_STEPS, "step_ms": result.step_ms,
                      "peak_gib": peak, "launches": launches,
                      "losses": losses}
    del result
    torch.cuda.empty_cache()
    print(f"musicgen trainer: × {layers} layers, tokens alone, seq 64, "
          f"ghost, {MUSIC_STEPS} steps: losses {losses}, step ms "
          f"{result_ms(out['trainer'])}, peak {peak:.2f} GiB, launches "
          f"{launches}", flush=True)
    return out


# ------------------------------------------- slice 14: the rest of serving
def zoo_serve_argv(arch, prompt, *extra):
    return ["--arch", arch, "--batch", str(ZOO_SERVE_B), "--prompt-len",
            str(prompt), "--steps", str(ZOO_SERVE_STEPS), "--device", "cuda",
            *extra]


def phase_zoo_serve(serve_mod, ref, tag, argv, cfg, per_prefill, per_step,
                    n_front=0):
    """One arch served at full width through the serve entry point, every
    plain version forbidden: the launches of the prefill and of each
    token step (the runner's warm-up steps included), all tensor-core;
    tokens, lengths and caches; then graphed == eager bitwise (logits,
    lengths, caches) from one cloned state, and the eager and graphed
    steps' times and idle shares."""
    from repro_torch.serving.engine import DECODE_WARMUP
    torch.cuda.empty_cache()
    reset_counts()
    result = run_forbidding_plain(ref, lambda: serve_mod.main(argv, cfg))
    launches = read_counts()
    steps = ZOO_SERVE_STEPS + DECODE_WARMUP
    expect_launches(launches, {k: per_prefill.get(k, 0)
                               + per_step.get(k, 0) * steps
                               for k in launches}, tag)
    check_tc(launches, tag)
    prompt = int(argv[argv.index("--prompt-len") + 1])
    toks = result.tokens
    if tuple(toks.shape) != (ZOO_SERVE_B, ZOO_SERVE_STEPS + 1) or \
            toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{tag}: tokens {tuple(toks.shape)} outside [0, "
             f"{cfg.vocab_size})")
    total = n_front + prompt + ZOO_SERVE_STEPS
    if result.state.lengths.tolist() != [total] * ZOO_SERVE_B:
        fail(f"{tag}: lengths {result.state.lengths.tolist()}")
    for name, buf in result.state.caches.items():
        if not torch.isfinite(buf).all():
            fail(f"{tag}: cache {name} holds a non-finite value")
    step_ms = statistics.median(result.step_ms)
    out = {"layers": cfg.num_layers, "batch": ZOO_SERVE_B, "prompt": prompt,
           "frontend_tokens": n_front, "steps": ZOO_SERVE_STEPS,
           "prefill_route": result.prefill_route,
           "prefill_ms": result.prefill_ms, "decode_step_ms_median": step_ms,
           "decode_step_ms": result.step_ms, "tok_per_s": result.tok_per_s,
           "decode_s": result.decode_s, "capture_ms": result.capture_ms,
           "peak_mem_gib": result.peak_bytes / 2**30, "launches": launches,
           "card_after": card_state()}
    print(f"{tag}: {cfg.name} × {cfg.num_layers} layers, batch "
          f"{ZOO_SERVE_B}, {n_front} embeds + prompt {prompt}, "
          f"{ZOO_SERVE_STEPS} graphed steps (after {DECODE_WARMUP} eager "
          f"warm-up steps and the capture, {result.capture_ms:.1f} ms), "
          f"prefill route {result.prefill_route}: launches {launches}; "
          f"prefill {result.prefill_ms:.3f} ms, median decode step "
          f"{step_ms:.3f} ms (CUDA events), {result.tok_per_s:.1f} tok/s, "
          f"peak memory {out['peak_mem_gib']:.2f} GiB; clock, power, "
          f"temperature after: {out['card_after']}", flush=True)
    out["graph_vs_eager"] = phase_serve_graph_equal(
        result, cfg, bitwise=True, tag=f"{tag} graph")
    out["profile"] = phase_serve_profile(result, cfg=cfg,
                                         tag=f"{tag} profile")
    return result, out


def op_split(fn, steps, tag):
    """Device time a call of fn() (eager), split by the aten op that
    launched it: the expert bmms (aten::bmm), the other GEMMs (mm, addmm)
    and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev = lambda r: (getattr(r, "self_device_time_total", None)
                     or getattr(r, "self_cuda_time_total", 0))
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CPU]
    total = sum(dev(r) for r in rows) / steps / 1e3
    if total <= 0:
        print(f"{tag}: device time not measured (no CUDA events traced)",
              flush=True)
        return None
    bmm = sum(dev(r) for r in rows if r.key == "aten::bmm") / steps / 1e3
    gemm = sum(dev(r) for r in rows
               if r.key in ("aten::mm", "aten::addmm")) / steps / 1e3
    out = {"device_ms": total, "expert_bmm_ms": bmm, "gemm_ms": gemm,
           "rest_ms": total - bmm - gemm}
    print(f"{tag}: device ms an eager step {total:.3f}: expert bmms "
          f"{bmm:.3f}, other GEMMs {gemm:.3f}, the rest "
          f"{out['rest_ms']:.3f}", flush=True)
    return out


def phase_serve_falcon(serve_mod, ref):
    """falcon-mamba-7b at full width and depth, served; then the batcher
    on its params (bucketed, pad-masked prefills) and the bucketed
    prefill's state against the unpadded one's."""
    cfg = zoo_config("falcon-mamba-7b")
    result, out = phase_zoo_serve(
        serve_mod, ref, "serve falcon-mamba",
        zoo_serve_argv("falcon-mamba-7b", FALCON_SERVE_PROMPT), cfg, {}, {})
    params = result.params
    del result
    torch.cuda.empty_cache()
    out["batcher"] = phase_zoo_batcher(params, ref, cfg)
    del params
    torch.cuda.empty_cache()
    return out


def phase_zoo_batcher(params, ref, cfg):
    """ContinuousBatcher over ``cfg``'s params, kernel route, 8 slots, 16
    seeded requests (prompts FALCON_BATCHER_PROMPT, 8–48 new tokens): all
    finish; then prompts of BUCKET_PROBES tokens prefilled unpadded and
    bucketed, their conv windows and states compared."""
    from repro_torch.serving import ContinuousBatcher, Request
    g = torch.Generator().manual_seed(33)
    lens = torch.randint(FALCON_BATCHER_PROMPT[0], FALCON_BATCHER_PROMPT[1]
                         + 1, (BATCHER_REQUESTS,), generator=g).tolist()
    news = torch.randint(BATCHER_NEW[0], BATCHER_NEW[1] + 1,
                         (BATCHER_REQUESTS,), generator=g).tolist()
    gd = torch.Generator(device="cuda").manual_seed(34)
    reqs = [Request(uid=i, prompt=torch.randint(
                0, cfg.vocab_size, (n,), generator=gd, device="cuda"),
                max_new_tokens=m) for i, (n, m) in enumerate(zip(lens, news))]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        batcher = ContinuousBatcher(
            params, cfg, num_slots=BATCHER_SLOTS,
            max_len=FALCON_BATCHER_MAX_LEN, decode_kernel="pallas",
            attn_impl="pallas")
        finished = run_forbidding_plain(ref, lambda: batcher.run(reqs))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    if sorted(finished) != list(range(BATCHER_REQUESTS)):
        fail(f"falcon batcher finished {sorted(finished)}")
    for r in reqs:
        if len(finished[r.uid]) != r.max_new_tokens:
            fail(f"falcon batcher: request {r.uid} got "
                 f"{len(finished[r.uid])} tokens, asked for "
                 f"{r.max_new_tokens}")
    expect_launches(launches, {}, "falcon batcher")
    traces = batcher.prefill_traces
    del batcher
    torch.cuda.empty_cache()
    out = {"requests": BATCHER_REQUESTS, "slots": BATCHER_SLOTS,
           "max_len": FALCON_BATCHER_MAX_LEN, "prompt_lens": lens,
           "max_new_tokens": news, "prefill_traces": traces,
           "wall_s": wall_s, "launches": launches}
    print(f"falcon batcher: × {cfg.num_layers} layers, {BATCHER_SLOTS} "
          f"slots, {BATCHER_REQUESTS} requests (prompts {min(lens)}–"
          f"{max(lens)}, {min(news)}–{max(news)} new tokens) all finished "
          f"in {wall_s:.2f} s, {traces} prefill shapes, launches "
          f"{launches}", flush=True)
    out["bucketed_vs_unpadded"] = [
        bucketed_state_diff(params, cfg, n, seed=35 + i)
        for i, n in enumerate(BUCKET_PROBES)]
    return out


def bucketed_state_diff(params, cfg, n, seed):
    """A seeded prompt of ``n`` tokens prefilled unpadded and right-padded
    to its bucket (``true_len``): each state buffer bitwise equal or not,
    its largest relative difference, and that difference layer by layer."""
    from repro_torch.serving.batcher import _bucket
    from repro_torch.serving.engine import prefill
    prompt = torch.randint(0, cfg.vocab_size, (1, n), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(seed))
    b = _bucket(n, 8)
    padded = torch.nn.functional.pad(prompt, (0, b - n))
    with torch.no_grad():
        _, plain = prefill(params, cfg, prompt, FALCON_BATCHER_MAX_LEN)
        _, bucketed = prefill(params, cfg, padded, FALCON_BATCHER_MAX_LEN,
                              true_len=n)
    diff = {}
    for k, v in plain.caches.items():
        w = bucketed.caches[k]
        diff[k] = {"bitwise": torch.equal(w, v),
                   "rel": rel_err(w.float(), v.float()),
                   "max_abs": (w.float() - v.float()).abs().max().item(),
                   "differing": int((w != v).sum().item()),
                   "rel_by_layer": [rel_err(w[p].float(), v[p].float())
                                    for p in range(w.shape[0])]}
    worst = max(diff, key=lambda k: diff[k]["rel"])
    by_layer = "; ".join(
        f"{k} " + ", ".join(f"{v['rel_by_layer'][i]:.2e}"
                           for i in (0, 1, len(v["rel_by_layer"]) // 2, -1))
        for k, v in diff.items())
    print(f"falcon bucketed prefill: {n} tokens bucketed to {b} vs "
          f"unpadded: {sum(v['bitwise'] for v in diff.values())} of "
          f"{len(diff)} state buffers bitwise equal, largest relative "
          f"difference {diff[worst]['rel']:.3e} ({worst}, max abs "
          f"{diff[worst]['max_abs']:.3e}), "
          f"{sum(v['differing'] for v in diff.values())} elements differ; "
          f"relative difference by layer (0, 1, middle, last): {by_layer}",
          flush=True)
    return {"prompt": n, "bucket": b, "buffers": diff}


def phase_serve_jamba(serve_mod, ref):
    """jamba-v0.1-52b at full width, one published period (8 layers):
    mamba at offsets 0–3 and 5–7, GQA attention at 4, MoE at 1, 3, 5, 7;
    the decode step's device time split (expert bmms, GEMMs, the rest)."""
    from repro_torch.serving.engine import decode_step
    cfg = zoo_config("jamba-v0.1-52b", num_layers=JAMBA_SERVE_LAYERS)
    specs = [(s.mixer, s.ff) for s in cfg.layer_specs()]
    if [m for m, _ in specs].count("attn") != 1 or \
            [f for _, f in specs].count("moe") != 4:
        fail(f"jamba period layout {specs}")
    result, out = phase_zoo_serve(
        serve_mod, ref, "serve jamba",
        zoo_serve_argv("jamba-v0.1-52b", JAMBA_SERVE_PROMPT), cfg,
        {"flash_attention": 1}, {"decode_attention": 1})
    carry = {"st": result.state, "tok": result.tokens[:, -1].contiguous()}

    @torch.no_grad()
    def eager():
        logits, carry["st"] = decode_step(result.params, cfg, carry["tok"],
                                          carry["st"], "pallas")
        carry["tok"] = torch.argmax(logits, -1).to(torch.int32)
    eager()
    out["step_split"] = op_split(eager, 4, "serve jamba split")
    out["params"] = sum(t.numel() for t in _leaves(result.params))
    del result, carry
    torch.cuda.empty_cache()
    return out


def _leaves(tree):
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def phase_serve_minicpm3(serve_mod, ref):
    cfg = zoo_config("minicpm3-4b")
    result, out = phase_zoo_serve(
        serve_mod, ref, "serve minicpm3",
        zoo_serve_argv("minicpm3-4b", MINI_SERVE_PROMPT), cfg, {}, {})
    if result.prefill_route != "ref":
        fail(f"minicpm3 prefill took route {result.prefill_route}")
    del result
    torch.cuda.empty_cache()
    return out


def phase_serve_musicgen(serve_mod, ref):
    cfg = zoo_config("musicgen-medium")
    layers = cfg.num_layers
    result, out = phase_zoo_serve(
        serve_mod, ref, "serve musicgen",
        zoo_serve_argv("musicgen-medium", MUSIC_SERVE_PROMPT,
                       "--frontend-tokens", str(MUSIC_SERVE_FRONT)), cfg,
        {"flash_attention": layers}, {"decode_attention": layers},
        n_front=MUSIC_SERVE_FRONT)
    del result
    torch.cuda.empty_cache()
    return out


def serve_run(cfg, params, toks, n_prefill, steps, dev, max_len,
              embeds=None):
    """A prefill of ``toks[:, :n_prefill]`` and ``steps`` teacher-forced
    decode steps on ``dev`` (kernels on the card, the plain route on the
    CPU): every logits and cache buffer, on the CPU, and the expert ids of
    every MoE routing."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import tree_map
    from repro_torch.serving.engine import (decode_step, prefill,
                                            prefill_attn_impl)
    route = "pallas" if dev == "cuda" else "ref"
    p = tree_map(lambda t: t.to(dev), params)
    t = toks.to(dev)
    orig, ids = moe_mod.route, []

    def spy(logits, cfg_, dropless=False):
        r = orig(logits, cfg_, dropless)
        ids.append(r.eidx.cpu())
        return r
    moe_mod.route = spy
    try:
        with torch.no_grad():
            last, st = prefill(p, cfg, t[:, :n_prefill], max_len,
                               attn_impl=prefill_attn_impl(cfg, route))
            res = {"prefill logits": last.cpu()}
            for i in range(steps):
                last, st = decode_step(p, cfg, t[:, n_prefill + i], st,
                                       route)
                res[f"decode {i} logits"] = last.cpu()
    finally:
        moe_mod.route = orig
    res.update({f"cache {k}": v.cpu() for k, v in st.caches.items()})
    del p, st, last
    return res, ids


def bucketed_state_err(cfg, params, toks) -> dict:
    """On the card, the relative difference of each state buffer between
    an unpadded prefill of ``toks[:, :ZOO_PARITY_S]`` and the same prompt
    right-padded to twice its length (``true_len``)."""
    from repro_torch.optim import tree_map
    from repro_torch.serving.engine import prefill
    p = tree_map(lambda t: t.to("cuda"), params)
    t = toks[:, :ZOO_PARITY_S].to("cuda")
    padded = torch.nn.functional.pad(t, (0, ZOO_PARITY_S))
    with torch.no_grad():
        _, plain = prefill(p, cfg, t, 4 * ZOO_PARITY_S)
        _, bucketed = prefill(p, cfg, padded, 4 * ZOO_PARITY_S,
                              true_len=ZOO_PARITY_S)
    out = {f"bucketed {k}": rel_err(bucketed.caches[k].float().cpu(),
                                    v.float().cpu())
           for k, v in plain.caches.items()}
    del p, plain, bucketed
    return out


def phase_serve_zoo_parity():
    """Full width, 1 layer, f32: a falcon-mamba layer, a minicpm3 MLA
    layer and a jamba mamba+MoE layer (experts cut to ZOO_PARITY_EXPERTS),
    a prefill and ZOO_PARITY_STEPS teacher-forced decode steps, card vs
    CPU (relative error ≤ CARD_VS_CPU_RTOL, expert ids equal), and for
    the falcon layer a bucketed prefill's state against the unpadded
    one's on the card (within the same bound); then
    minicpm3 at 2 layers with sliding_window 8 decoding past the ring's
    wrap on both, each against its windowed forward."""
    from repro_torch.models.transformer import forward, init_transformer
    from repro_torch.optim import tree_map
    cases = {
        "falcon-mamba layer": zoo_config("falcon-mamba-7b", num_layers=1,
                                         dtype="float32"),
        "minicpm3 MLA layer": zoo_config("minicpm3-4b", num_layers=1,
                                         dtype="float32"),
        "jamba mamba+MoE layer": zoo_config(
            "jamba-v0.1-52b", num_layers=1, attn_every=0, moe_every=1,
            moe_offset=0, num_experts=ZOO_PARITY_EXPERTS, dtype="float32"),
    }
    out = {}
    for ci, (tag, cfg) in enumerate(cases.items()):
        params = init_transformer(torch.Generator().manual_seed(81 + ci),
                                  cfg, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (ZOO_PARITY_B, ZOO_PARITY_S
                                                 + ZOO_PARITY_STEPS),
                             generator=torch.Generator().manual_seed(91 + ci))
        t0 = time.perf_counter()
        card, ids_card = serve_run(cfg, params, toks, ZOO_PARITY_S,
                                   ZOO_PARITY_STEPS, "cuda", 96)
        t1 = time.perf_counter()
        cpu, ids_cpu = serve_run(cfg, params, toks, ZOO_PARITY_S,
                                 ZOO_PARITY_STEPS, "cpu", 96)
        t2 = time.perf_counter()
        errs = {k: rel_err(card[k], v) for k, v in cpu.items()}
        if cfg.attention == "none":
            # the pad mask on the card: the prompt right-padded to twice
            # its length, its state against the unpadded one's
            errs.update(bucketed_state_err(cfg, params, toks))
        worst = max(errs, key=errs.get)
        same_routing = len(ids_card) == len(ids_cpu) and all(
            torch.equal(a, b) for a, b in zip(ids_card, ids_cpu))
        print(f"serve parity: {tag} (full width, f32), card {t1 - t0:.1f} "
              f"s vs CPU {t2 - t1:.1f} s: largest relative error "
              f"{errs[worst]:.3e} ({worst}); MoE routings {len(ids_card)}, "
              f"{'identical' if same_routing else 'DIFFER'}", flush=True)
        if errs[worst] > CARD_VS_CPU_RTOL:
            fail(f"serve parity {tag}: {worst} relative error "
                 f"{errs[worst]:.3e} > {CARD_VS_CPU_RTOL}")
        if not same_routing:
            fail(f"serve parity {tag}: the expert ids differ")
        out[tag] = {"rel_err": errs, "worst": worst,
                    "moe_routings": len(ids_card),
                    "routing_identical": same_routing}
        del params, card, cpu
        torch.cuda.empty_cache()
    # the MLA ring past its wrap: window 8, 4 prompt tokens, 10 steps
    cfg = zoo_config("minicpm3-4b", num_layers=2, sliding_window=8,
                     dtype="float32")
    params = init_transformer(torch.Generator().manual_seed(85), cfg, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (ZOO_PARITY_B, 14),
                         generator=torch.Generator().manual_seed(95))
    ring, vs_fwd = {}, {}
    for dev in ("cuda", "cpu"):
        res, _ = serve_run(cfg, params, toks, 4, 10, dev, 16)
        if tuple(res["cache l0.attn.latent"].shape)[2] != 8:
            fail("minicpm3 ring: the latent cache is not window-sized")
        with torch.no_grad():
            full, _ = forward(tree_map(lambda t: t.to(dev), params), cfg,
                              toks.to(dev))
        full = full.cpu()
        ring[dev] = res
        vs_fwd[dev] = max(rel_err(res[f"decode {i} logits"], full[:, 4 + i])
                          for i in range(10))
    errs = {k: rel_err(ring["cuda"][k], v) for k, v in ring["cpu"].items()}
    worst = max(errs, key=errs.get)
    print(f"serve parity: minicpm3 × 2 layers, sliding window 8, 4 prompt "
          f"tokens and 10 decode steps past the ring's wrap: card vs CPU "
          f"largest relative error {errs[worst]:.3e} ({worst}); decode vs "
          f"the windowed forward: card {vs_fwd['cuda']:.3e}, CPU "
          f"{vs_fwd['cpu']:.3e}", flush=True)
    if max(errs[worst], *vs_fwd.values()) > CARD_VS_CPU_RTOL:
        fail("serve parity: the MLA ring past its wrap")
    out["minicpm3 ring"] = {"card_vs_cpu": errs[worst],
                            "card_vs_forward": vs_fwd["cuda"],
                            "cpu_vs_forward": vs_fwd["cpu"]}
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------- slice 15: async planes
ASYNC_STEPS = 40
STREAM_N = 2 ** 19        # 524,288 examples: 6 GiB of f32 rows
STREAM_CHUNK = 1024
STREAM_WINDOW = 64        # chunks: 768 MiB of rows, 1/8 of the data
STREAM_SWAP = 4
# phase 39 scores 4 chunks a step, so that the scored chunks pass the cold
# window (chunks 0–63) at step 16, and drops scores older than 8 steps back
# to the uniform belief (appendix B.1), so that the window follows the
# sweep: from step 16 each prefetch admits chunks the window lacks
STREAM_SCORE_BATCH = 4096
STREAM_STALENESS = 8
LOOP_STEPS = 24
LOOP_PROFILE_STEPS = 4
LOOP_STREAM = ["--stream", "--async-scoring", "--swap-every", "2"]
LOOP_SERVE = ["--serve-loop", "--serve-slots", "8", "--serve-prompt-len",
              "64", "--serve-max-new", "16", "--serve-decode-steps", "2",
              "--serve-reserve-chunks", "2"]
PLANES_RTOL = 1e-5        # card vs CPU at smoke widths, f32 (phase 41)


def side_counts() -> dict:
    """The launches off the default stream of the scoring kernels."""
    w = kernel_wrappers()
    return {k: w[k].side_launches
            for k in ("per_example_sqnorm_multi", "ghost_norm")}


def reset_side_counts() -> None:
    w = kernel_wrappers()
    for k in ("per_example_sqnorm_multi", "ghost_norm"):
        w[k].side_launches = 0


def drive(built, steps, state=None):
    """``steps`` steps of a launcher-built path, as ``run``'s loop takes
    them (the serve loop's ingest after each): (state, each step's
    metrics, CUDA-event ms a step, wall ms a step).  The pipeline's
    scoring stream is joined before the clocks stop."""
    state = built.state if state is None else state
    mets, marks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m, *_ = built.step(state, built.data)
        end.record()
        if built.serve is not None:
            state = built.serve.ingest_into(state)
        mets.append(m)
        marks.append((start, end))
    if built.pipe is not None:
        built.pipe.join()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    return state, mets, [s.elapsed_time(e) for s, e in marks], wall


def stream_profile(fn, steps, tag):
    """Idle and overlap shares of ``steps`` calls of fn(), from the
    profiler's trace: each kernel's interval on its stream; busy = time
    with a kernel on any stream, overlap share = time with kernels on two
    streams at once over busy, idle share = 1 − busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = scratch_dir("chip_smoke_streams") / (
        re.sub(r"[^a-z0-9]+", "_", tag.lower()) + ".json")
    prof.export_chrome_trace(str(path))
    by_stream: dict = {}
    for e in json.loads(path.read_text()).get("traceEvents", []):
        if e.get("cat") == "kernel" and "dur" in e:
            s = str(e.get("args", {}).get("stream", e.get("tid")))
            by_stream.setdefault(s, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if not by_stream:
        print(f"{tag}: device time not measured (no kernel in the trace)",
              flush=True)
        return None
    points = sorted((t, d, s) for s, iv in by_stream.items()
                    for a, b in iv for t, d in ((a, 1), (b, -1)))
    active: dict = {}
    busy = both = 0.0
    last = None
    for t, d, s in points:
        if last is not None:
            n = sum(1 for c in active.values() if c > 0)
            busy += (t - last) if n >= 1 else 0.0
            both += (t - last) if n >= 2 else 0.0
        active[s] = active.get(s, 0) + d
        last = t
    streams = {s: {"kernels": len(iv),
                   "kernel_ms": sum(b - a for a, b in iv) / 1e3}
               for s, iv in by_stream.items()}
    out = {"steps": steps, "wall_ms": wall_ms, "busy_ms": busy / 1e3,
           "idle_share": 1 - busy / 1e3 / wall_ms,
           "overlap_share": both / busy if busy else 0.0,
           "overlap_ms": both / 1e3, "streams": streams,
           "card_after": card_state()}
    print(f"{tag}: {steps} steps, device busy {busy / 1e3:.3f} ms of "
          f"{wall_ms:.3f} ms wall (idle share {out['idle_share']:.3f}), "
          f"kernels on two streams at once {both / 1e3:.3f} ms (overlap "
          f"share {out['overlap_share']:.4f}); by stream "
          f"{json.dumps(streams)}", flush=True)
    return out


def same_buffers(a, b) -> bool:
    """Two stores (plain or buffered) bitwise equal."""
    if hasattr(a, "read_buf"):
        return (same_store(a.read_buf, b.read_buf)
                and same_store(a.write_buf, b.write_buf)
                and a.synced_at == b.synced_at)
    return same_store(a, b)


def same_steps(mets_a, mets_b,
               fields=("loss", "grad_norm", "trace_stale")) -> bool:
    """Each step's draws and ``fields`` bitwise equal."""
    return len(mets_a) == len(mets_b) and all(
        torch.equal(a.sample_indices, b.sample_indices)
        and all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
        for a, b in zip(mets_a, mets_b))


def phase_async(train_mod, ref):
    """38: mlp_svhn at the paper's width, --async-scoring at swap cadence 1
    and 4 beside the relaxed step; each bitwise the port's relaxed master
    fed the store as written through step K⌊t/K⌋ − 1; the scoring kernel
    on the side stream once a step; idle and overlap shares."""
    steps = ["--steps", str(ASYNC_STEPS)]

    def relaxed_ms():
        relaxed, r_l = counted_run(train_mod, ref, mlp_argv(*steps))
        expect_launches(r_l, {"per_example_sqnorm_multi": ASYNC_STEPS},
                        "relaxed")
        return statistics.median(relaxed.step_ms[WARMUP_STEPS:])

    r_ms = relaxed_ms()
    out = {"steps": ASYNC_STEPS, "relaxed_step_ms": r_ms}
    for k in (1, 4):
        built = train_mod.build(train_mod.parse_args(mlp_argv(
            *steps, "--async-scoring", "--swap-every", str(k))))
        gen0 = built.state.rng.get_state()
        reset_counts()
        reset_side_counts()
        state, mets, ms, wall = run_forbidding_plain(
            ref, lambda: drive(built, ASYNC_STEPS))
        launches, side = read_counts(), side_counts()
        expect_launches(launches, {"per_example_sqnorm_multi": ASYNC_STEPS},
                        f"async K={k}")
        if side["per_example_sqnorm_multi"] != ASYNC_STEPS:
            fail(f"async K={k}: {side} launches off the default stream; "
                 f"the scoring pass must launch on its own stream")
        # the port's relaxed master fed the lagged store, on one stream
        pipe, init = built.pipe, built.state
        gen = torch.Generator(device="cuda")
        gen.set_state(gen0)
        store = init.store.write_buf
        hist = [store]
        p, o, sp = init.params, init.opt_state, init.stale_params
        lag = []
        for t in range(ASYNC_STEPS):
            store, _ = pipe._scoring(sp, store, t, built.data)
            hist.append(store)
            p, o, sp, _, _, m = pipe._master(p, o, sp, hist[(t // k) * k], t,
                                             gen, built.data)
            lag.append(m)
        torch.cuda.synchronize()
        # (the lagged master's traces are NaN: it gets no fresh scores)
        if not (same_steps(mets, lag, ("loss", "grad_norm", "ess_frac"))
                and same_tree(state.params, p)
                and same_store(state.store.write_buf, store)
                and same_store(state.store.read_buf,
                               hist[(ASYNC_STEPS // k) * k])):
            fail(f"async K={k} is not bitwise the relaxed master fed the "
                 f"store of step K⌊t/K⌋ − 1")
        swaps = pipe.swaps
        cell = [state]

        def more():
            cell[0], _ = built.pipe.step(cell[0], built.data)

        prof = stream_profile(more, 8, f"async K={k}")
        out[f"k{k}"] = {
            "step_ms_median": statistics.median(ms[WARMUP_STEPS:]),
            "wall_ms_a_step": wall, "launches": launches,
            "side_launches": side, "swaps": swaps, "profile": prof}
        print(f"async K={k}: mlp_svhn full width, {ASYNC_STEPS} steps, "
              f"median step {out[f'k{k}']['step_ms_median']:.3f} ms against "
              f"relaxed {r_ms:.3f} ms (CUDA events, same call), "
              f"{wall:.3f} ms wall a step; {side['per_example_sqnorm_multi']}"
              f" multi-tap launches on the scoring stream; {swaps} "
              f"publishes; bitwise the lagged relaxed master", flush=True)
        del built, state, mets, hist, lag, p, o, sp, store, cell
        torch.cuda.empty_cache()
    out["relaxed_step_ms_after"] = relaxed_ms()
    print(f"async: relaxed median step {r_ms:.3f} ms before the async runs, "
          f"{out['relaxed_step_ms_after']:.3f} ms after (CUDA events)",
          flush=True)
    return out


def build_streamed(train_mod, argv):
    """A launcher build, and its seconds."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    built = train_mod.build(train_mod.parse_args(argv))
    torch.cuda.synchronize()
    return built, time.perf_counter() - t0


def h2d_rates(plane, n):
    """GB/s of the scoring stream's fetch (host gather + copy, 256 rows)
    and of a window build whose every chunk comes from the host; the
    swapped-in window's rows, gathered as hits, bitwise the host chunks'."""
    from repro_torch.data.streaming import host_score_slice
    row = sum(math.prod(plane.store.row_shape(k))
              * torch.empty((), dtype=plane.store.dtype(k)).element_size()
              for k in plane.store.keys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(20):
        plane.fetch_sharded(host_score_slice(t, 1, n, 256)[None])
    torch.cuda.synchronize()
    fetch_s = (time.perf_counter() - t0) / 20
    chunks = plane.store.num_chunks
    mass = torch.zeros(chunks)
    far = chunks // 2
    mass[far:far + plane.window_chunks] = 1.0
    t0 = time.perf_counter()
    swapped = plane.prefetch(mass) and plane.swap_window()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cs = plane.chunk_size
    idx = torch.arange(far * cs, (far + plane.window_chunks) * cs, 7)
    hits = plane.stats.hits
    got = plane.gather_global(idx.numpy())
    want = plane.store.fetch_rows(idx.numpy())
    if not swapped or plane.stats.hits - hits != idx.numel() or not all(
            torch.equal(got[k].cpu(), want[k].cpu()) for k in want):
        fail(f"streaming h2d: the window built from chunks {far}.. does "
             f"not serve their host rows bitwise as hits")
    win_bytes = plane.window_chunks * plane.chunk_size * row
    return {"fetch_rows": 256, "fetch_ms": fetch_s * 1e3,
            "fetch_gb_s": 256 * row / fetch_s / 1e9,
            "window_bytes": win_bytes, "window_build_ms": build_s * 1e3,
            "window_gb_s": win_bytes / build_s / 1e9}


def phase_streaming(train_mod, ref, n=STREAM_N):
    """39: mlp_svhn at the paper's width over ``n`` examples held in
    pinned host chunks behind a window of STREAM_WINDOW chunks: sync and
    async (swap STREAM_SWAP) streamed runs bitwise their resident runs;
    step ms, hit rate, misses, streamed rows, host→device GB/s, peaks.
    The dataset is halved (and the cut printed) if the host cannot pin
    it."""
    base = mlp_argv("--examples", str(n), "--steps", str(ASYNC_STEPS),
                    "--score-batch", str(STREAM_SCORE_BATCH),
                    "--staleness-threshold", str(STREAM_STALENESS))
    stream = ["--stream", "--chunk-size", str(STREAM_CHUNK),
              "--window-chunks", str(STREAM_WINDOW)]
    asyn = ["--async-scoring", "--swap-every", str(STREAM_SWAP)]
    out = {"examples": n, "chunk": STREAM_CHUNK, "window": STREAM_WINDOW,
           "steps": ASYNC_STEPS, "score_batch": STREAM_SCORE_BATCH,
           "staleness_threshold": STREAM_STALENESS}
    for comp, extra in (("sync", []), ("async", asyn)):
        runs = {}
        for where, more in (("resident", []), ("streamed", stream)):
            torch.cuda.reset_peak_memory_stats()
            try:
                built, build_s = build_streamed(train_mod,
                                                base + extra + more)
            except RuntimeError as e:
                if where == "streamed" and "pin" in str(e).lower() \
                        and n > STREAM_N // 8:
                    print(f"streaming: pinning {n} rows failed ({e}); "
                          f"halving the dataset", flush=True)
                    return phase_streaming(train_mod, ref, n // 2)
                raise
            reset_counts()
            reset_side_counts()
            state, mets, ms, wall = run_forbidding_plain(
                ref, lambda: drive(built, ASYNC_STEPS))
            rec = {"step_ms_median": statistics.median(ms[WARMUP_STEPS:]),
                   "wall_ms_a_step": wall, "build_s": build_s,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": read_counts(), "side_launches": side_counts()}
            expect_launches(rec["launches"],
                            {"per_example_sqnorm_multi": ASYNC_STEPS},
                            f"{where} {comp}")
            if where == "streamed":
                st = built.pipe.plane.stats
                rec.update(hit_rate=st.hit_rate, hits=st.hits,
                           misses=st.misses, streamed_rows=st.streamed_rows,
                           window_swaps=st.swaps,
                           pinned_host_gib=built.pipe.plane.store.nbytes()
                           / 2**30)
                if st.swaps == 0:
                    fail(f"streaming {comp}: the window never swapped, so "
                         f"the copy-stream build went unchecked")
                if comp == "sync":
                    rec["h2d"] = h2d_rates(built.pipe.plane, n)
            runs[where] = (state, mets, rec)
            del built
            torch.cuda.empty_cache()
        (rs, rm, rr), (ss, sm, sr) = runs["resident"], runs["streamed"]
        if not (same_steps(rm, sm) and same_tree(rs.params, ss.params)
                and same_buffers(rs.store, ss.store)):
            fail(f"streaming {comp}: the streamed run is not bitwise the "
                 f"resident run")
        out[comp] = {"resident": rr, "streamed": sr}
        print(f"streaming {comp}: {n} examples ({sr['pinned_host_gib']:.2f} "
              f"GiB in pinned chunks of {STREAM_CHUNK}), window "
              f"{STREAM_WINDOW} chunks; median step {sr['step_ms_median']:.3f}"
              f" ms streamed against {rr['step_ms_median']:.3f} ms resident "
              f"(CUDA events, same call; wall {sr['wall_ms_a_step']:.3f} / "
              f"{rr['wall_ms_a_step']:.3f} ms a step); hit rate "
              f"{sr['hit_rate']:.4f} ({sr['hits']} hits, {sr['misses']} "
              f"misses), {sr['streamed_rows']} rows streamed, "
              f"{sr['window_swaps']} window swaps; peak "
              f"{sr['peak_gib']:.2f} GiB streamed, {rr['peak_gib']:.2f} GiB "
              f"resident (data generation included); bitwise equal",
              flush=True)
        if comp == "sync":
            print(f"streaming h2d: {json.dumps(sr['h2d'])}", flush=True)
    return out


def phase_serve_loop(train_mod, ref):
    """40: glm4-9b at full width (phase 7's cut and trainer), streamed and
    async (swap 2), with and without the serve loop (8 slots, prompts of
    64, 16 new tokens, 2 decodes a tick, the kernels' route): step ms,
    rows ingested, dropped and live, flash launches a prefill and decode
    launches a tick (all tensor-core), the scoring kernels on the side
    stream, peaks, an overlap profile; a decode against the published
    snapshot bitwise a decode against an explicit copy of the params of
    the step it was taken at."""
    from repro_torch.core.weight_store import EMPTY
    from repro_torch.serving.engine import decode_step, prefill
    cfg = lm_config()
    base = LM_ARGV + ["--steps", str(LOOP_STEPS)] + LOOP_STREAM
    out = {"steps": LOOP_STEPS, "argv": base + LOOP_SERVE}
    for name, extra in (("no_serve", []), ("serve", LOOP_SERVE)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        built = train_mod.build(train_mod.parse_args(base + extra), cfg)
        serve, pipe = built.serve, built.pipe
        counts = {"prefills": 0, "decodes": 0}
        explicit = {}
        if serve is not None:
            batcher = serve.batcher
            insert, step = batcher.try_insert, batcher.step

            def counted_insert(req, insert=insert):
                ok = insert(req)
                counts["prefills"] += int(ok)
                return ok

            def counted_step(step=step, batcher=batcher):
                counts["decodes"] += int(any(not s.free
                                             for s in batcher.slots))
                return step()

            batcher.try_insert, batcher.step = counted_insert, counted_step

            # the explicit copy is taken at the run's last publish only, so
            # that one step of the timed run carries its clone
            last_pub = max(
                t for t in range(LOOP_STEPS) if t % serve.serve_every == 0
                and (t // serve.serve_every) % serve.publish_every == 0)

            def tick(state, serve=serve, last_pub=last_pub):
                serve.on_train_step(state)
                if int(state.step) == last_pub:
                    explicit["step"] = int(state.step)
                    explicit["params"] = _clone_tree(state.params)

            pipe.serve_tick = tick
        reset_counts()
        reset_side_counts()
        state, mets, ms, wall = run_forbidding_plain(
            ref, lambda: drive(built, LOOP_STEPS))
        launches, side = read_counts(), side_counts()
        rec = {"step_ms_median": statistics.median(ms[LM_WARMUP:]),
               "wall_ms_a_step": wall, "launches": launches,
               "side_launches": side,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "losses": [float(m.loss) for m in mets]}
        if not all(math.isfinite(v) for v in rec["losses"]):
            fail(f"serve loop {name}: non-finite losses {rec['losses']}")
        want_gn = len(GHOST_MAIN) * LOOP_STEPS
        if launches["ghost_norm"] != want_gn or side["ghost_norm"] != want_gn:
            fail(f"serve loop {name}: ghost_norm {launches['ghost_norm']} "
                 f"launches, {side['ghost_norm']} on the scoring stream; "
                 f"expected {want_gn}, all on it")
        check_tc(launches, f"serve loop {name}")
        if serve is not None:
            want = {"ghost_norm": want_gn,
                    "flash_attention": LM_LAYERS * counts["prefills"],
                    "decode_attention": LM_LAYERS * counts["decodes"]}
            expect_launches(launches, want, "serve loop")
            ws_ = state.store.write_buf.scored_at
            lo = serve.ingest.start_row
            rec.update(
                prefills=counts["prefills"], decodes=counts["decodes"],
                flash_a_prefill=launches["flash_attention"]
                / max(counts["prefills"], 1),
                decode_a_tick=launches["decode_attention"] / LOOP_STEPS,
                ingested=serve.ingest.ingested, dropped=serve.ingest.dropped,
                live=int((ws_[lo:] != EMPTY).sum()),
                finished=serve.finished, publishes=serve.publishes,
                hit_rate=pipe.plane.stats.hit_rate)
            if serve.ingest.ingested < 1 or rec["live"] != \
                    serve.ingest.ingested:
                fail(f"serve loop: {serve.ingest.ingested} rows ingested, "
                     f"{rec['live']} live")
            # the published snapshot against an explicit copy
            pub = serve.published
            if explicit.get("step") != pub.synced_at:
                fail("serve loop: no explicit copy of the published step")
            g = torch.Generator(device="cuda").manual_seed(11)
            prompt = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                                   device="cuda")
            logits = []
            for params in (pub.params, explicit["params"]):
                lg, st = prefill(params, cfg, prompt, 80, attn_impl="pallas")
                seq = [lg]
                tok = torch.argmax(lg, -1).to(torch.int32)
                for _ in range(2):
                    lg, st = decode_step(params, cfg, tok, st,
                                         decode_kernel="pallas")
                    seq.append(lg)
                    tok = torch.argmax(lg, -1).to(torch.int32)
                logits.append(seq)
            if not all(torch.equal(a, b) for a, b in zip(*logits)):
                fail("serve loop: a decode against the published snapshot "
                     "differs from one against the explicit copy")
            rec["snapshot_step"] = pub.synced_at
            rec["snapshot_vs_live_equal"] = same_tree(pub.params,
                                                      state.params)
            cell = [state]

            def more(built=built):
                cell[0], _, *_ = built.step(cell[0], None)
                cell[0] = built.serve.ingest_into(cell[0])

            rec["profile"] = stream_profile(more, LOOP_PROFILE_STEPS,
                                            "serve loop")
            del cell
        out[name] = rec
        print(f"serve loop {name}: glm4-9b × {LM_LAYERS}, {LOOP_STEPS} steps "
              f"streamed, async swap 2: median step "
              f"{rec['step_ms_median']:.3f} ms (CUDA events), {wall:.3f} ms wall a step, peak "
              f"{rec['peak_gib']:.2f} GiB, launches {launches}, on the "
              f"scoring stream {side}"
              + (f"; {rec['prefills']} prefills ({rec['flash_a_prefill']:.0f}"
                 f" flash launches each), {rec['decodes']} decodes "
                 f"({rec['decode_a_tick']:.0f} decode launches a tick), rows "
                 f"ingested {rec['ingested']}, dropped {rec['dropped']}, live"
                 f" {rec['live']}; snapshot of step {rec['snapshot_step']} "
                 f"decodes bitwise as its explicit copy"
                 if serve is not None else ""), flush=True)
        del built, state, mets, serve, pipe, explicit
        torch.cuda.empty_cache()
    return out


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(b.abs().max(), 1e-30))


def _tree_rel(a, b) -> float:
    if isinstance(a, dict):
        return max(_tree_rel(a[k], b[k]) for k in a)
    return _rel(a, b)


def phase_planes_parity():
    """41: card vs CPU in f32 at smoke widths, from the same params, data
    and uniforms: two async steps at swap cadence 2 (the scoring on the
    card's side stream), three streamed sync steps, and two serve ticks
    with an ingest.  Draws equal, values within PLANES_RTOL."""
    from repro_torch.configs import get_smoke_config, mlp_svhn
    from repro_torch.core.async_pipeline import (AsyncPipeline,
                                                 init_async_state,
                                                 make_async_steps)
    from repro_torch.core.importance import ISConfig
    from repro_torch.core.issgd import (ISSGDConfig, init_train_state,
                                        read_sampling_proposal)
    from repro_torch.core.sampler import two_stage_sample
    from repro_torch.core.scorer import make_mlp_scorer
    from repro_torch.core.weight_store import (init_store, read_proposal,
                                               reserve_tail)
    from repro_torch.data import make_svhn_like
    from repro_torch.data.store import ChunkedExampleStore
    from repro_torch.data.streaming import (StreamedISSGD,
                                            StreamingDataPlane,
                                            make_streamed_steps)
    from repro_torch.models import mlp, transformer
    from repro_torch.optim import sgd
    from repro_torch.serving import (ContinuousBatcher, ServeLoop,
                                     TrafficIngest, make_synthetic_traffic)
    n, steps = 1024, 4
    cfg = mlp_svhn.smoke()
    icfg = ISSGDConfig(batch_size=32, score_batch_size=128,
                       is_cfg=ISConfig(smoothing=0.5), score_shards=2)
    train, _ = make_svhn_like(torch.Generator().manual_seed(0), n=n,
                              dim=cfg.input_dim)
    params = mlp.init_mlp_classifier(torch.Generator().manual_seed(1), cfg,
                                     "cpu")
    u = torch.rand(steps, icfg.batch_size,
                   generator=torch.Generator().manual_seed(2))
    pel = lambda p, b: mlp.per_example_loss(p, b, cfg)
    scorer, opt = make_mlp_scorer(cfg, "ghost"), sgd(0.05)
    n_w = n // icfg.score_shards

    def shared_draw(store, step, dev):
        q = read_sampling_proposal(store, step, icfg, n_w)
        return two_stage_sample(q, icfg.batch_size,
                                num_shards=icfg.score_shards,
                                uniforms=u[step].to(dev))

    res = {}
    for dev in ("cpu", "cuda"):
        data = {k: v.to(dev) for k, v in train.arrays.items()}
        p0 = {k: {j: v.to(dev) for j, v in d.items()}
              for k, d in params.items()}
        # (a) async, K = 2, scoring on the card's side stream
        s_step, m_step = make_async_steps(pel, scorer, opt, icfg, n)

        def master(p, o, sp, read_buf, step, gen, data_, m_step=m_step,
                   dev=dev):
            return m_step(p, o, sp, read_buf, step, gen, data_,
                          sample_indices=shared_draw(read_buf, step, dev))

        pipe = AsyncPipeline(s_step, master, 2)
        st = init_async_state(p0, opt, n, dev)
        a_mets = []
        for _ in range(steps):
            st, m = pipe.step(st, data)
            a_mets.append(m)
        pipe.join()
        # (b) streamed sync
        sc, smp, ms_ = make_streamed_steps(pel, scorer, opt, icfg, n, 64)

        def sample(store, step, gen, smp=smp, dev=dev):
            _, mass = smp(store, step, gen)
            return shared_draw(store, step, dev), mass

        plane = StreamingDataPlane(ChunkedExampleStore.from_arrays(
            train.arrays, 64, pin_memory=dev == "cuda"), 4, device=dev)
        drv = StreamedISSGD(plane, sc, sample, ms_, icfg, n)
        sst = init_train_state(p0, opt, n, dev)
        s_mets = []
        for _ in range(steps - 1):
            sst, m = drv.step(sst)
            s_mets.append(m)
        res[dev] = (st, a_mets, sst, s_mets)
    errs = {}
    for i, what in ((0, "async"), (2, "streamed")):
        cpu_st, gpu_st = res["cpu"][i], res["cuda"][i]
        cm, gm = res["cpu"][i + 1], res["cuda"][i + 1]
        if not all(torch.equal(a.sample_indices, b.sample_indices.cpu())
                   for a, b in zip(cm, gm)):
            fail(f"planes parity {what}: the draws differ card vs CPU")
        errs[what] = max(
            max(_rel(b.loss, a.loss) for a, b in zip(cm, gm)),
            max(_rel(b.trace_stale, a.trace_stale) for a, b in zip(cm, gm)),
            _tree_rel(gpu_st.params, cpu_st.params))
        bufs = (("read_buf", "write_buf") if what == "async" else (None,))
        for buf in bufs:
            a = getattr(cpu_st.store, buf) if buf else cpu_st.store
            b = getattr(gpu_st.store, buf) if buf else gpu_st.store
            if not torch.equal(a.scored_at, b.scored_at.cpu()):
                fail(f"planes parity {what}: scored_at differs")
            errs[what] = max(errs[what], _rel(b.weights, a.weights))
    # (c) two serve ticks and an ingest, glm4-9b smoke (f32)
    lcfg = get_smoke_config("glm4-9b")
    lparams = transformer.init_transformer(torch.Generator().manual_seed(3),
                                           lcfg, "cpu")
    toks = torch.randint(0, lcfg.vocab_size, (64, 17),
                         generator=torch.Generator().manual_seed(4))
    loops = {}
    for dev in ("cpu", "cuda"):
        store = ChunkedExampleStore.from_arrays({"tokens": toks}, 8,
                                                pin_memory=dev == "cuda")
        store.append_chunk()
        lp = _to_dev(lparams, dev)
        serve = ServeLoop(
            ContinuousBatcher(lp, lcfg, num_slots=2, max_len=7,
                              decode_kernel="pallas", attn_impl="pallas"),
            TrafficIngest(store, seq_len=17, start_row=64, capacity_rows=8),
            make_synthetic_traffic(lcfg.vocab_size, 4, max_new_tokens=3,
                                   seed=5), decode_steps=2)
        state = init_train_state(lp, opt, 72, dev)._replace(
            store=reserve_tail(init_store(72, dev), 64))
        for _ in range(2):
            serve.on_train_step(state)
            state = serve.ingest_into(state)
        loops[dev] = (serve, state, store)
    (cs, cst, cstore), (gs, gst, gstore) = loops["cpu"], loops["cuda"]
    rows = torch.arange(64, 72)
    if cs.batcher.finished != gs.batcher.finished or \
            cs.ingest.ingested != gs.ingest.ingested or \
            cs.ingest.ingested < 1 or \
            not torch.equal(cstore.fetch_rows(rows)["tokens"],
                            gstore.fetch_rows(rows)["tokens"]) or \
            not torch.equal(cst.store.scored_at, gst.store.scored_at.cpu()):
        fail(f"planes parity serve: tokens, ingested rows or live rows "
             f"differ card vs CPU ({cs.batcher.finished} vs "
             f"{gs.batcher.finished})")
    errs["serve"] = max(_rel(gs.batcher.state.caches[k],
                             cs.batcher.state.caches[k])
                        for k in cs.batcher.state.caches)
    if max(errs.values()) > PLANES_RTOL:
        fail(f"planes parity: card vs CPU {errs} > {PLANES_RTOL}")
    print(f"planes parity: f32 smoke widths, card vs CPU from the same "
          f"params, data and uniforms: async K=2 ({steps} steps), streamed "
          f"sync ({steps - 1} steps), two serve ticks with "
          f"{cs.ingest.ingested} rows ingested: draws, finished tokens and live rows equal, "
          f"largest relative errors {errs}", flush=True)
    return errs


# --- phase 42: the sharded ISSGD step over torch.distributed
SHARD_STEPS = 40
SHARD_W = 4               # logical scoring shards: 2 a rank in the world of 2
SHARD_LM_STEPS = 4
SHARD_N = 65536           # the mlp_svhn rows: no width of the step is 65,536
SHARD_LOSS_RTOL = 1e-5
SHARD_DRAWS = 4096        # draws of the draw-alone check
SHARD_FIELDS = ("loss", "grad_norm", "trace_ideal", "trace_stale",
                "trace_unif", "ess_frac", "mean_weight")


class RowRecorder(TorchDispatchMode):
    """Every op input or output whose shape holds ``n``."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_flatten
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor) and self.n in tuple(t.shape):
                self.seen.append((str(func), tuple(t.shape)))
        return out


class StepRecorder:
    """While active, every step the launcher builds
    (``make_sharded_train_step``, with a group or None) keeps each step's
    metrics (device tensors: no host synchronisation), and its step
    number ``watch`` runs under a RowRecorder of ``n``-row tensors."""

    NAMES = ("make_sharded_train_step",)

    def __init__(self, train_mod, watch=-1, n=SHARD_N):
        self.mod, self.watch, self.n = train_mod, watch, n
        self.mets, self.seen = [], None

    def __enter__(self):
        self.saved = {k: getattr(self.mod, k) for k in self.NAMES}
        for k, orig in self.saved.items():
            setattr(self.mod, k, self._wrap(orig))
        return self

    def __exit__(self, *exc):
        for k, orig in self.saved.items():
            setattr(self.mod, k, orig)

    def _wrap(self, orig):
        def make(*a, **k):
            out = orig(*a, **k)
            step = out[0] if isinstance(out, tuple) else out

            def rec(*sa, **sk):
                if len(self.mets) == self.watch:
                    with RowRecorder(self.n) as r:
                        res = step(*sa, **sk)
                    self.seen = r.seen
                else:
                    res = step(*sa, **sk)
                self.mets.append(res[1])
                return res
            rec.with_monitors, rec.gated = step.with_monitors, step.gated
            return (rec, *out[1:]) if isinstance(out, tuple) else rec
        return make


def _sharded_rank(group, device, argv, out_dir):
    """One rank of phase 42b, in its own process: the trainer through
    ``run`` with the rank's group, every plain version forbidden; then
    the hierarchical draw over the group from the table it reached
    against the one-device draw from the whole table.  What it saw is
    saved for the parent."""
    import os
    from repro_torch.core import collectives
    from repro_torch.core.collectives import gather_rows
    from repro_torch.core.importance import ISConfig
    from repro_torch.core.sampler import two_stage_sample
    from repro_torch.core.weight_store import read_proposal
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_mod
    train_mod.use_full_f32()
    if group.rank:
        sys.stdout = open(os.devnull, "w")
    args = train_mod.parse_args(argv)
    args.device = device
    reset_counts()
    collectives.reset_counts()
    with StepRecorder(train_mod, watch=WARMUP_STEPS) as rec:
        result = run_forbidding_plain(
            ref, lambda: train_mod.run(args, group=group))
    torch.cuda.synchronize()
    idx, met = _stacked(rec.mets)
    out = {"indices": idx, "metrics": met,
           "store": [t.cpu() for t in result.state.store if t is not None],
           "params": (_to_dev(result.state.params, "cpu")
                      if group.rank == 0 else None),
           "data_rows": result.built.data["x"].shape[0],
           "seen": rec.seen, "step_ms": result.step_ms,
           "launches": read_counts(), "collectives": dict(collectives.COUNTS)}
    # the draw alone: the sharded draw from this rank's rows of the table
    # the run reached, against the one-device draw from the whole table
    q = read_proposal(result.state.store, result.state.step,
                      ISConfig(smoothing=args.smoothing))
    u = torch.rand(SHARD_DRAWS, device=q.device,
                   generator=torch.Generator(device=q.device).manual_seed(7))
    mine = two_stage_sample(q, SHARD_DRAWS, SHARD_W // group.size,
                            uniforms=u, group=group)
    whole = gather_rows(q, torch.arange(SHARD_N, device=q.device), group)
    out["draw_equal"] = torch.equal(
        mine, two_stage_sample(whole, SHARD_DRAWS, SHARD_W, uniforms=u))
    torch.save(out, f"{out_dir}/rank{group.rank}.pt")


def _stacked(mets):
    return (torch.stack([m.sample_indices for m in mets]).cpu(),
            {f: torch.stack([getattr(m, f) for m in mets]).cpu()
             for f in SHARD_FIELDS})


def phase_sharded(train_mod, ref):
    """42: the sharded ISSGD step.  (a) world 1 over NCCL on cuda:0
    through ``--mesh 1``, against the one-device step (group None) of the
    same call: mlp_svhn at full width, W = 4, 40 steps, and glm4-9b at
    phase 7's cut, 4 steps; bitwise (draws, metrics, params, store); the
    kernels' launches and the all-reduces a step.  A row's ghost score in
    a 256-row batch against a 128-row one, with the GEMMs over the batch
    and one a shard's slice.  (b) world 2 on the one card: two spawned
    ranks over a gloo group on CUDA tensors (NCCL takes one rank a
    device), the same mlp_svhn run, bitwise world 1's in every draw,
    loss, grad norm and Σw and in the final store and params; 32,768 rows
    of the store and the data a rank, no tensor of 65,536 rows in a step
    recorded op by op, 1 multi-tap launch a step a rank; the hierarchical
    draw over the group bitwise the one-device draw from the same table.
    And ``--mesh`` beyond the card count is refused, naming the count."""
    from repro_torch.configs import mlp_svhn
    from repro_torch.core import collectives
    from repro_torch.core.scorer import make_mlp_scorer
    from repro_torch.launch import mesh
    argv = mlp_argv("--steps", str(SHARD_STEPS), "--score-shards",
                    str(SHARD_W))
    out = {"steps": SHARD_STEPS, "score_shards": SHARD_W}

    def world1(what, argv, cfg, launches, warm):
        torch.cuda.empty_cache()
        with StepRecorder(train_mod) as plain_rec:
            plain, plain_l = counted_run(train_mod, ref, argv, cfg)
        torch.cuda.empty_cache()
        reset_counts()
        collectives.reset_counts()
        with StepRecorder(train_mod) as rec:
            w1 = run_forbidding_plain(ref, lambda: train_mod.main(
                argv + ["--mesh", "1"], cfg))
        w1_l, ar = read_counts(), dict(collectives.COUNTS)
        steps = len(rec.mets)
        for tag, got in (("group None", plain_l), ("world 1", w1_l)):
            expect_launches(got, {k: v * steps for k, v in launches.items()},
                            f"sharded {what} {tag}")
        if "ghost_norm" in launches:
            check_tc(w1_l, f"sharded {what} world 1")
        if not (same_steps(rec.mets, plain_rec.mets, SHARD_FIELDS)
                and same_tree(w1.state.params, plain.state.params)
                and same_tree(w1.state.stale_params,
                              plain.state.stale_params)
                and same_store(w1.state.store, plain.state.store)):
            fail(f"sharded {what}: world 1 over NCCL is not bitwise the "
                 f"one-device step")
        if ar["all_reduce"] % steps or ar["elements"] % steps:
            fail(f"sharded {what}: {ar} all-reduces in {steps} steps; a "
                 f"step's should not vary")
        res = {"steps": steps,
               "step_ms_none": statistics.median(plain.step_ms[warm:]),
               "step_ms_world1": statistics.median(w1.step_ms[warm:]),
               "launches": w1_l, "launches_none": plain_l,
               "all_reduce_a_step": ar["all_reduce"] // steps,
               "all_reduce_elements_a_step": ar["elements"] // steps}
        print(f"sharded {what}: world 1 over NCCL ≡ the one-device step "
              f"bitwise over {steps} steps (draws, metrics, params, "
              f"store); median step {res['step_ms_world1']:.3f} ms against "
              f"{res['step_ms_none']:.3f} ms one-device (CUDA events, "
              f"same call); {res['all_reduce_a_step']} all-reduces a step "
              f"of {res['all_reduce_elements_a_step']} elements; launches "
              f"{ {k: v for k, v in w1_l.items() if v} }", flush=True)
        return res, _stacked(rec.mets), w1

    out["mlp_world1"], (idx1, met1), w1 = world1(
        "mlp_svhn", argv, None, {"per_example_sqnorm_multi": 1},
        WARMUP_STEPS)
    out["lm_world1"], _, _ = world1(
        f"glm4-9b × {LM_LAYERS}", LM_ARGV + ["--steps", str(SHARD_LM_STEPS)],
        lm_config(), {"ghost_norm": len(GHOST_MAIN)}, LM_WARMUP)

    # a row of a 256-row scoring batch against the same row in a batch of
    # 128 (a rank's slice in world 2), the GEMMs over the whole batch and
    # one a logical shard's slice of 64 rows (the launcher's row block)
    rows = {k: v[:MAIN_B] for k, v in w1.built.data.items()}
    half = MAIN_B // 2
    sd = out["scores_batch_256_vs_2x128"] = {}
    for rb in (0, MAIN_B // SHARD_W):
        score = make_mlp_scorer(mlp_svhn.CONFIG, "ghost", row_block=rb)
        whole = score(w1.state.stale_params, rows)
        halves = torch.cat([score(w1.state.stale_params,
                                  {k: v[a:a + half] for k, v in rows.items()})
                            for a in (0, half)])
        sd[f"row_block_{rb}"] = {"rows_differing": int((whole != halves)
                                                       .sum()),
                                 "max_rel": rel_err(halves, whole)}
    print(f"sharded: rows of a 256-row ghost scoring batch that score other "
          f"bits in two batches of {half}: {sd}", flush=True)
    if sd[f"row_block_{MAIN_B // SHARD_W}"]["rows_differing"]:
        fail(f"sharded: with GEMMs of one shard's slice, a row still scores "
             f"other bits in another batch: {sd}")

    # (b) two ranks time-sharing the one card
    torch.cuda.empty_cache()
    d = scratch_dir("chip_smoke_sharded")
    t0 = time.perf_counter()
    mesh.run_world(_sharded_rank, 2, "cuda", backend="gloo",
                   args=(argv, str(d)))
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for r, got in enumerate(ranks):
        if [t.shape[0] for t in got["store"]] != [SHARD_N // 2] * 2 or \
                got["data_rows"] != SHARD_N // 2:
            fail(f"sharded world 2 rank {r}: store "
                 f"{[t.shape[0] for t in got['store']]} and data "
                 f"{got['data_rows']} rows; expected {SHARD_N // 2}")
        if got["seen"] is None or got["seen"]:
            fail(f"sharded world 2 rank {r}: a step made or took tensors of "
                 f"{SHARD_N} rows: {(got['seen'] or ['not recorded'])[:4]}")
        expect_launches(got["launches"],
                        {"per_example_sqnorm_multi": SHARD_STEPS},
                        f"sharded world 2 rank {r}")
        if not got["draw_equal"]:
            fail(f"sharded world 2 rank {r}: the hierarchical draw over the "
                 f"group differs from the one-device draw of the same table")
        if not (torch.equal(got["indices"], idx1) and all(
                torch.equal(got["metrics"][f], met1[f])
                for f in ("loss", "grad_norm", "mean_weight"))):
            differ = (got["indices"] != idx1).any(dim=1).nonzero()
            fail(f"sharded world 2 rank {r}: draws or losses differ from "
                 f"world 1's (steps drawing otherwise: "
                 f"{differ.flatten().tolist()[:8]}; losses "
                 f"{rel_err(got['metrics']['loss'], met1['loss']):.2e})")
    if not all(torch.equal(ranks[0]["metrics"][f], ranks[1]["metrics"][f])
               for f in SHARD_FIELDS):
        fail("sharded world 2: the ranks' metrics differ")
    from repro_torch.optim import tree_leaves
    w1_store = [t.cpu() for t in w1.state.store if t is not None]
    if not (all(torch.equal(torch.cat([r["store"][i] for r in ranks]),
                            w1_store[i]) for i in range(2))
            and all(torch.equal(a, b.cpu()) for a, b in zip(
                tree_leaves(ranks[0]["params"]),
                tree_leaves(w1.state.params), strict=True))):
        fail("sharded world 2: store or params not bitwise world 1's")
    metric_err = {f: rel_err(ranks[0]["metrics"][f], met1[f])
                  for f in SHARD_FIELDS}
    if max(metric_err.values()) > SHARD_LOSS_RTOL:
        fail(f"sharded world 2: metrics {metric_err} from world 1's > "
             f"{SHARD_LOSS_RTOL}")
    ar = ranks[0]["collectives"]
    out["mlp_world2"] = {
        "step_ms_time_shared": [statistics.median(r["step_ms"][WARMUP_STEPS:])
                                for r in ranks],
        "wall_s_with_spawn": wall_s, "metric_rel_err": metric_err,
        "draw_alone_equal": SHARD_DRAWS,
        "launches": [r["launches"] for r in ranks],
        "all_reduce_a_step": ar["all_reduce"] // SHARD_STEPS,
        "all_reduce_elements_a_step": ar["elements"] // SHARD_STEPS,
        "rows_a_rank": SHARD_N // 2}
    w2 = out["mlp_world2"]
    print(f"sharded world 2 (two processes over gloo on CUDA tensors, one "
          f"card): every step's draws, losses, grad norms and Σw, the store "
          f"and the params bitwise world 1's over {SHARD_STEPS} steps (the "
          f"trace monitors within {max(metric_err.values()):.2e}); "
          f"{SHARD_N // 2} rows a rank, no {SHARD_N}-row tensor in step "
          f"{WARMUP_STEPS}; the draw over the group ≡ the one-device draw "
          f"({SHARD_DRAWS} draws); median step "
          f"{w2['step_ms_time_shared'][0]:.3f} / "
          f"{w2['step_ms_time_shared'][1]:.3f} ms (time-shared between two "
          f"processes on one card: not a speed figure); "
          f"{w2['all_reduce_a_step']} all-reduces a step of "
          f"{w2['all_reduce_elements_a_step']} elements; {wall_s:.1f} s with "
          f"the spawn", flush=True)
    del w1
    torch.cuda.empty_cache()

    count = torch.cuda.device_count()
    try:
        train_mod.main(mlp_argv("--steps", "1", "--mesh", str(count + 1)))
    except ValueError as e:
        if f"{count} CUDA device" not in str(e):
            fail(f"--mesh {count + 1}: refused without the count: {e}")
    else:
        fail(f"--mesh {count + 1} ran on {count} card(s)")
    return out

PLANES_STEPS = 40
PLANES_SAVE_AT = 20        # (b) saves its gather-free checkpoint here
PLANES_WINDOW_W2 = 32      # chunks a rank's window holds in the world of 2
PLANES_WATCH = WARMUP_STEPS  # the step (b) records op by op
PLANES_LM_STEPS = 4
PLANES_LM_W = 2            # logical scoring shards of the LM world of 2
PLANE_FIELDS = ("loss", "grad_norm", "mean_weight")
PLANE_TRACES = ("trace_ideal", "trace_stale", "trace_unif", "ess_frac")


def planes_argv(*extra) -> list:
    """Phase 39's streamed mlp_svhn trainer at W = SHARD_W."""
    return mlp_argv("--examples", str(STREAM_N), "--steps",
                    str(PLANES_STEPS), "--score-batch",
                    str(STREAM_SCORE_BATCH), "--staleness-threshold",
                    str(STREAM_STALENESS), "--score-shards", str(SHARD_W),
                    "--stream", "--chunk-size", str(STREAM_CHUNK), *extra)


def expect_side(side: dict, want: dict, what: str) -> None:
    """Fail unless each scoring kernel named in ``want`` launched that
    often off the default stream."""
    for k, v in want.items():
        if side[k] != v:
            fail(f"{what}: {side[k]} {k} launches on the scoring stream; "
                 f"expected {v}")


def buffers_of(store) -> list:
    """The tensors of a plain or buffered store, in order."""
    bufs = (store.read_buf, store.write_buf) if hasattr(store, "read_buf") \
        else (store,)
    return [t for b in bufs for t in b if t is not None]


def plane_run(group, device, argv, cfg=None, save=None, restore=None,
              watch=None):
    """One launcher-built run of ``argv`` on ``group``'s rank (one device
    with None), driven step by step as ``run``'s loop drives it, every
    plain version forbidden, the counts set to 0 just before the first
    step.  ``save`` = (step, path) saves a gather-free checkpoint before
    that step (its all-reduces left out of the counts), ``restore`` a
    path to start from, ``watch`` a step run under a RowRecorder of
    N-row tensors.  (what it saw, the final state, the build)."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core import collectives
    from repro_torch.core.distributed import shard_train_state
    from repro_torch.data.store import ForeignChunkError
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_mod
    train_mod.use_full_f32()
    args = train_mod.parse_args(argv)
    args.device = device
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    built = train_mod.build(args, cfg, group=group)
    state = built.state
    if restore:
        state, _ = restore_checkpoint(restore, state)
    if group is not None:
        state = shard_train_state(state, group, torch.device(device))
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    mets, marks = [], []

    def loop():
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(args.steps):
            if save is not None and i == save[0]:
                built.pipe.join()
                torch.cuda.synchronize()
                counts = dict(collectives.COUNTS)
                ts = time.perf_counter()
                save_checkpoint(save[1], state, state.step, group=group)
                out["save_s"] = time.perf_counter() - ts
                collectives.COUNTS.update(counts)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if i == watch:
                with RowRecorder(args.examples) as rec:
                    state, m, *_ = built.step(state, built.data)
                out["seen"] = rec.seen
            else:
                state, m, *_ = built.step(state, built.data)
            end.record()
            mets.append(m)
            marks.append((start, end))
        if built.pipe is not None:
            built.pipe.join()
        torch.cuda.synchronize()
        out["wall_ms_a_step"] = (time.perf_counter() - t) * 1e3 / args.steps

    reset_counts()
    reset_side_counts()
    collectives.reset_counts()
    run_forbidding_plain(ref, loop)
    idx, met = _stacked(mets)
    out.update(indices=idx, metrics=met,
               step_ms=[s.elapsed_time(e) for s, e in marks],
               launches=read_counts(), side_launches=side_counts(),
               ghost_tc=kernel_wrappers()["ghost_norm"].tc_launches,
               all_reduce_a_step=collectives.COUNTS["all_reduce"]
               / args.steps,
               all_reduce_elements_a_step=collectives.COUNTS["elements"]
               / args.steps)
    plane = getattr(built.pipe, "plane", None)
    if plane is not None:
        st, store = plane.stats, plane.store
        held = store.held_chunks
        try:
            store.fetch_rows([(held.stop % store.num_chunks)
                              * store.chunk_size])
            refused = False
        except ForeignChunkError:
            refused = True
        out.update(hit_rate=st.hit_rate, hits=st.hits, misses=st.misses,
                   streamed_rows=st.streamed_rows, window_swaps=st.swaps,
                   held=(held.start, held.stop),
                   window=plane.window_ids.tolist(),
                   held_rows=sum(c[store.keys[0]].shape[0]
                                 for _, c in store.iter_chunks()),
                   foreign_refused=refused)
    return out, state, built


def _plane_rank(group, device, argv, out_dir, save=None, watch=None,
                cfg_layers=None, keep_state=True):
    """One spawned rank of phase 43: ``plane_run`` and what it saw saved
    for the parent, the final state on the host when ``keep_state``."""
    import os
    if group.rank:
        sys.stdout = open(os.devnull, "w")
    cfg = None if cfg_layers is None else lm_config(cfg_layers)
    out, state, _ = plane_run(group, device, argv, cfg, save=save,
                              watch=watch)
    if keep_state:
        out.update(store=[t.cpu() for t in buffers_of(state.store)],
                   params=_to_dev(state.params, "cpu"),
                   stale_params=_to_dev(state.stale_params, "cpu"))
    torch.save(out, f"{out_dir}/rank{group.rank}.pt")


def _plane_world1(group, device, argv, cfg=None):
    return plane_run(group, device, argv, cfg)[:2]


def same_plane_runs(a, b, what, traces_bitwise=True) -> None:
    """Fail unless two runs drew the same indices with the same losses,
    grad norms and Σw bitwise (and trace monitors bitwise, or within
    SHARD_LOSS_RTOL)."""
    if not (torch.equal(a["indices"], b["indices"]) and all(
            torch.equal(a["metrics"][f], b["metrics"][f])
            for f in PLANE_FIELDS)):
        differ = (a["indices"] != b["indices"]).any(dim=1).nonzero()
        fail(f"{what}: draws or losses differ (steps drawing otherwise: "
             f"{differ.flatten().tolist()[:8]}; losses "
             f"{rel_err(a['metrics']['loss'], b['metrics']['loss']):.2e})")
    for f in PLANE_TRACES:
        x, y = a["metrics"][f], b["metrics"][f]
        if traces_bitwise and not torch.equal(x, y):
            fail(f"{what}: {f} differs")
        if not traces_bitwise and rel_err(x, y) > SHARD_LOSS_RTOL:
            fail(f"{what}: {f} {rel_err(x, y):.2e} from the other run's")


def same_final(sa, sb) -> bool:
    """Two final states (on one device) bitwise: store buffers, params,
    stale params."""
    return (same_buffers(sa.store, sb.store)
            and same_tree(sa.params, sb.params)
            and same_tree(sa.stale_params, sb.stale_params))


def _slice_steps(run, a, b) -> dict:
    """A run's draws and metrics of steps [a, b)."""
    return {"indices": run["indices"][a:b],
            "metrics": {f: v[a:b] for f, v in run["metrics"].items()}}


def _plane_summary(r) -> dict:
    keys = ("build_s", "wall_ms_a_step", "launches", "side_launches",
            "all_reduce_a_step", "all_reduce_elements_a_step", "hit_rate",
            "hits", "misses", "streamed_rows", "window_swaps", "save_s")
    out = {k: r[k] for k in keys if k in r}
    ms = (r["step_ms"][WARMUP_STEPS:] if len(r["step_ms"]) > WARMUP_STEPS
          else r["step_ms"])
    out["step_ms_median"] = statistics.median(ms)
    out["step_ms_quartiles"] = (statistics.quantiles(ms, n=4)[::2]
                                if len(ms) > 1 else [ms[0], ms[0]])
    return out


def phase_sharded_planes(train_mod, ref):
    """43: the sharded planes (see the module docstring)."""
    from repro_torch.launch import mesh
    out = {"examples": STREAM_N, "chunk": STREAM_CHUNK, "steps":
           PLANES_STEPS, "score_batch": STREAM_SCORE_BATCH,
           "score_shards": SHARD_W}
    t_phase = time.perf_counter()
    asyn = ["--async-scoring", "--swap-every", str(STREAM_SWAP)]
    mlp_launch = {"per_example_sqnorm_multi": PLANES_STEPS}

    # (a) --mesh 1 over NCCL against one device, sync and async
    keep = {}
    for comp, extra in (("sync", []), ("async", asyn)):
        argv = planes_argv("--window-chunks", str(STREAM_WINDOW), *extra)
        one, one_state, built = plane_run(None, "cuda", argv)
        del built
        w1, w1_state = mesh.run_world(_plane_world1, 1, "cuda",
                                      args=(argv,))
        for tag, r in (("one device", one), ("world 1", w1)):
            expect_launches(r["launches"], mlp_launch,
                            f"planes (a) {comp} {tag}")
            if comp == "async":
                expect_side(r["side_launches"], mlp_launch,
                            f"planes (a) {comp} {tag}")
        same_plane_runs(w1, one, f"planes (a) {comp}: world 1 over NCCL "
                                 f"against one device")
        if not same_final(w1_state, one_state):
            fail(f"planes (a) {comp}: world 1's store, params or stale "
                 f"params are not bitwise the one-device run's")
        out[f"a_{comp}"] = {"one_device": _plane_summary(one),
                            "world1": _plane_summary(w1)}
        a = out[f"a_{comp}"]
        print(f"sharded planes (a) {comp}: world 1 over NCCL ≡ one device "
              f"bitwise over {PLANES_STEPS} steps (draws, metrics, both "
              f"buffers, params, stale params); median step "
              f"{a['world1']['step_ms_median']:.3f} ms (quartiles "
              f"{a['world1']['step_ms_quartiles'][0]:.3f}–"
              f"{a['world1']['step_ms_quartiles'][1]:.3f}) against "
              f"{a['one_device']['step_ms_median']:.3f} ms one-device "
              f"({a['one_device']['step_ms_quartiles'][0]:.3f}–"
              f"{a['one_device']['step_ms_quartiles'][1]:.3f}; CUDA "
              f"events, same call); hit rate "
              f"{w1['hit_rate']:.4f} / {one['hit_rate']:.4f}; "
              f"{w1['all_reduce_a_step']:.2f} all-reduces a step of "
              f"{w1['all_reduce_elements_a_step']:.0f} elements", flush=True)
        if comp == "async":
            keep = {"run": one, "state": one_state}
        del one_state, w1_state
        torch.cuda.empty_cache()

    # (b) a world of 2 over gloo on the one card, streamed async
    d = scratch_dir("chip_smoke_planes")
    ckpt = d / "planes_step20.npz"
    argv2 = planes_argv("--window-chunks", str(PLANES_WINDOW_W2), *asyn)
    t0 = time.perf_counter()
    mesh.run_world(_plane_rank, 2, "cuda", backend="gloo",
                   args=(argv2, str(d), (PLANES_SAVE_AT, str(ckpt)),
                         PLANES_WATCH))
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    half, per = STREAM_N // 2, STREAM_N // STREAM_CHUNK // 2
    for r, got in enumerate(ranks):
        what = f"planes (b) rank {r}"
        expect_launches(got["launches"], mlp_launch, what)
        expect_side(got["side_launches"], mlp_launch, what)
        if got.get("seen") is None or got["seen"]:
            fail(f"{what}: step {PLANES_WATCH} made or took tensors of "
                 f"{STREAM_N} rows: {(got.get('seen') or ['not recorded'])[:4]}")
        if (got["held"] != (r * per, (r + 1) * per)
                or got["held_rows"] != half or not got["foreign_refused"]
                or not all(r * per <= c < (r + 1) * per
                           for c in got["window"][0])):
            fail(f"{what}: holds chunks {got['held']} ({got['held_rows']} "
                 f"rows), window {got['window']}, foreign row refused "
                 f"{got['foreign_refused']}; expected chunks "
                 f"[{r * per}, {(r + 1) * per}) alone")
        if [t.shape[0] for t in got["store"]] != [half] * 4:
            fail(f"{what}: store buffers of {[t.shape[0] for t in got['store']]}"
                 f" rows; expected {half}")
        same_plane_runs(got, keep["run"], f"{what} against (a)'s async run",
                        traces_bitwise=False)
    whole = [torch.cat([r_["store"][i] for r_ in ranks]) for i in range(4)]
    a_state = keep["state"]
    if not (all(torch.equal(x, y.cpu()) for x, y in zip(
            whole, buffers_of(a_state.store), strict=True))
            and same_tree(_to_dev(a_state.params, "cpu"), ranks[0]["params"])
            and same_tree(_to_dev(a_state.stale_params, "cpu"),
                          ranks[0]["stale_params"])):
        fail("planes (b): the world of 2's store, params or stale params "
             "are not bitwise (a)'s async run's")
    out["b_world2"] = {"ranks": [_plane_summary(r_) for r_ in ranks],
                       "wall_s_with_spawn": wall_s,
                       "file_mb": ckpt.stat().st_size / 2**20,
                       "rows_a_rank": half}
    b = out["b_world2"]
    print(f"sharded planes (b): a world of 2 over gloo on one card ≡ (a)'s "
          f"async run bitwise over {PLANES_STEPS} steps (draws, losses, grad "
          f"norms, Σw, both buffers, params; traces within "
          f"{SHARD_LOSS_RTOL}); {half} rows a rank in its own pinned chunks, "
          f"window {PLANES_WINDOW_W2} chunks, no foreign chunk, no "
          f"{STREAM_N}-row tensor in step {PLANES_WATCH}; "
          f"{PLANES_STEPS} multi-tap launches a rank, all on its scoring "
          f"stream; hit rates {[round(r_['hit_rate'], 4) for r_ in ranks]}; "
          f"median step {[round(x['step_ms_median'], 3) for x in b['ranks']]}"
          f" ms a rank (time-shared: no speed figure); gather-free save at "
          f"step {PLANES_SAVE_AT} {[round(r_['save_s'], 3) for r_ in ranks]} "
          f"s a rank, file {b['file_mb']:.2f} MB; {wall_s:.1f} s with the "
          f"spawn", flush=True)

    # (c) one device resumes (b)'s file for the last steps
    rest = PLANES_STEPS - PLANES_SAVE_AT
    argv_c = planes_argv("--window-chunks", str(STREAM_WINDOW), *asyn)
    argv_c[argv_c.index("--steps") + 1] = str(rest)
    res_c, state_c, built = plane_run(None, "cuda", argv_c,
                                      restore=str(ckpt))
    del built
    expect_launches(res_c["launches"],
                    {"per_example_sqnorm_multi": rest}, "planes (c)")
    same_plane_runs(res_c, _slice_steps(keep["run"], PLANES_SAVE_AT,
                                        PLANES_STEPS),
                    "planes (c): the resumed run against the uninterrupted")
    if not same_final(state_c, a_state):
        fail("planes (c): the resumed run ends with another store or params "
             "than the uninterrupted run")
    out["c_resume"] = _plane_summary(res_c)
    print(f"sharded planes (c): one device restores (b)'s gather-free file "
          f"at step {PLANES_SAVE_AT} and runs {rest} steps ≡ the "
          f"uninterrupted run bitwise (draws, metrics, both buffers, params)",
          flush=True)
    del state_c, a_state, keep
    torch.cuda.empty_cache()

    # (d) glm4-9b at phase 7's cut, --mesh 1 --stream --async-scoring
    lm_argv = LM_ARGV + ["--steps", str(PLANES_LM_STEPS), "--stream",
                         "--async-scoring", "--swap-every", "2"]
    ghost = {"ghost_norm": len(GHOST_MAIN) * PLANES_LM_STEPS}
    one, one_state, built = plane_run(None, "cuda", lm_argv, lm_config())
    del built
    w1, w1_state = mesh.run_world(_plane_world1, 1, "cuda",
                                  args=(lm_argv, lm_config()))
    for tag, r in (("one device", one), ("world 1", w1)):
        expect_launches(r["launches"], ghost, f"planes (d) {tag}")
        expect_side(r["side_launches"], ghost, f"planes (d) {tag}")
        if r["ghost_tc"] != ghost["ghost_norm"]:
            fail(f"planes (d) {tag}: {r['ghost_tc']} of "
                 f"{ghost['ghost_norm']} ghost_norm launches tensor-core")
    same_plane_runs(w1, one, "planes (d): glm4-9b world 1 against one device")
    if not same_final(w1_state, one_state):
        fail("planes (d): glm4-9b world 1's store or params are not bitwise "
             "the one-device run's")
    out["d_lm"] = {"one_device": _plane_summary(one),
                   "world1": _plane_summary(w1)}
    print(f"sharded planes (d): glm4-9b × {LM_LAYERS} streamed async (swap "
          f"2) through --mesh 1 ≡ one device bitwise over "
          f"{PLANES_LM_STEPS} steps; {len(GHOST_MAIN)} ghost_norm launches "
          f"a step, all on the scoring stream and tensor-core; median step "
          f"{out['d_lm']['world1']['step_ms_median']:.3f} / "
          f"{out['d_lm']['one_device']['step_ms_median']:.3f} ms (CUDA "
          f"events, same call)", flush=True)
    del one_state, w1_state
    torch.cuda.empty_cache()

    # the LM row blocks: glm4-9b × LM_LAYERS as a resident world of 2
    out["lm_row_blocks"] = phase_lm_row_blocks(mesh)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"sharded planes: phase wall {out['wall_s']:.1f} s", flush=True)
    return out


def phase_lm_row_blocks(mesh) -> dict:
    """Phase 7's glm4-9b cut at W = PLANES_LM_W, resident: one device
    (2 row blocks a scoring pass, 16 ghost_norm launches a step) against
    a world of 2 over gloo on the one card (8 a rank): the same draws and
    losses.  The cut goes to 2 layers if two ranks of 4 do not fit."""
    from repro_torch.launch import train as train_mod
    for layers in (LM_LAYERS, 2):
        argv = LM_ARGV + ["--steps", str(PLANES_LM_STEPS), "--score-shards",
                          str(PLANES_LM_W)]
        n_ghost = len(GHOST_MAIN) * PLANES_LM_STEPS
        one = plane_run(None, "cuda", argv, lm_config(layers))[0]
        torch.cuda.empty_cache()
        expect_launches(one["launches"], {"ghost_norm": 2 * n_ghost},
                        f"LM row blocks one device × {layers}")
        d = scratch_dir("chip_smoke_lm_rows")
        try:
            mesh.run_world(_plane_rank, 2, "cuda", backend="gloo",
                           args=(argv, str(d), None, None, layers, False))
        except Exception as e:  # noqa: BLE001 - only an OOM falls back
            if "out of memory" not in str(e).lower() or layers == 2:
                raise
            print(f"LM row blocks: two ranks of glm4-9b × {layers} do not "
                  f"fit on one card ({str(e)[:200]}); cutting to 2 layers",
                  flush=True)
            continue
        ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        for r, got in enumerate(ranks):
            what = f"LM row blocks world 2 rank {r} × {layers}"
            expect_launches(got["launches"], {"ghost_norm": n_ghost}, what)
            if got["ghost_tc"] != n_ghost:
                fail(f"{what}: {got['ghost_tc']} of {n_ghost} ghost_norm "
                     f"launches tensor-core")
            same_plane_runs(got, one, f"{what} against one device",
                            traces_bitwise=False)
        res = {"layers": layers, "score_shards": PLANES_LM_W,
               "steps": PLANES_LM_STEPS,
               "one_device": _plane_summary(one),
               "ranks": [_plane_summary(r_) for r_ in ranks],
               "ghost_norm_a_step_one_device": 2 * len(GHOST_MAIN),
               "ghost_norm_a_step_a_rank": len(GHOST_MAIN)}
        print(f"LM row blocks: glm4-9b × {layers} at W = {PLANES_LM_W}, a "
              f"resident world of 2 on one card draws what one device draws "
              f"over {PLANES_LM_STEPS} steps (losses, grad norms, Σw "
              f"bitwise); ghost_norm {2 * len(GHOST_MAIN)} a step on one "
              f"device (2 row blocks), {len(GHOST_MAIN)} a rank", flush=True)
        return res
    fail("LM row blocks: no cut fits")


MP_STEPS = 20             # (a): relaxed mlp_svhn steps a world
MP_CHECK_STEPS = 5        # steps whose draws must equal one device's
MP_PLANE_STEPS = 4        # (a): async and streamed steps at M = 2
MP_LM_STEPS = 2           # (c): relaxed steps of the zoo's cuts
MP_GLM_STEPS = 2          # (b): relaxed glm4-9b steps a variant
MP_W = 4                  # (a): logical scoring shards (row blocks of 64)
MP_LM_SB = 32             # (b): glm4-9b's score batch (phase 7: 128)
MP_FLASH_B = 4            # (b): the flash step's batch (phase 16: 16)
MP_LM_RTOL = 5e-2         # bf16 ghost scores of M partial sums vs one GEMM
# the MoE archs: a token whose top-k experts are near a tie routes
# otherwise when the bf16 partial sums reassociate, which moves its
# example's score by more; their rows are held at the median, and at most
# MP_MOE_SHARE of them may lie beyond MP_LM_RTOL
MP_MOE = ("dbrx", "jamba")
MP_MOE_SHARE = 0.25
MP_FALCON_LAYERS, MP_DBRX_LAYERS, MP_MINI_LAYERS = 2, 1, 2


def mp_run(group, model_group, device, argv, cfg=None, run_kw=None,
           allow=(), save=None, keep_params=False):
    """One launcher-built run of ``argv`` on this rank's groups (one
    device with None), driven step by step as ``run``'s loop drives it,
    every plain version forbidden but ``allow``, the counts set to 0 just
    before the first step; ``save`` a path for a gather-free checkpoint
    after the last step (its all-reduces left out of the counts).  What
    it saw: draws, metrics, launches, tensor-core launches, the
    all-reduces of each axis, step ms, peak GiB, the final store and,
    with ``keep_params``, the params (this rank's shards) on the host
    (an LM's would fill the host: the ranks and the parent share it)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core import collectives
    from repro_torch.core.distributed import (shard_train_state,
                                              train_state_specs)
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_mod
    train_mod.use_full_f32()
    args = train_mod.parse_args(argv)
    args.device = device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    built = train_mod.build(args, cfg, group=group, model_group=model_group,
                            **(run_kw or {}))
    state = built.state
    if group is not None:
        state = shard_train_state(state, group, torch.device(device),
                                  param_specs=built.param_specs,
                                  model_group=model_group)
    mets, marks = [], []

    def loop():
        nonlocal state
        for _ in range(args.steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m, *_ = built.step(state, built.data)
            end.record()
            mets.append(m)
            marks.append((start, end))
        if built.pipe is not None:
            built.pipe.join()
        torch.cuda.synchronize()

    reset_counts()
    collectives.reset_counts()
    run_forbidding_plain(ref, loop, allow=allow)
    counts = dict(collectives.COUNTS)
    wrappers = kernel_wrappers()
    out = {"launches": read_counts(),
           "tc": {k: wrappers[k].tc_launches for k in TC_KERNELS},
           "scored": wrappers["flash_attention_bwd"].scored,
           "collectives": counts, "steps": args.steps,
           "step_ms": [s.elapsed_time(e) for s, e in marks],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "store": [t.cpu() for t in buffers_of(state.store)],
           "params": (_to_dev(state.params, "cpu") if keep_params
                      else None)}
    out["indices"], out["metrics"] = _stacked(mets)
    if save is not None:
        save_checkpoint(save, state, state.step, group=group,
                        model_group=model_group,
                        shard_specs=(None if built.param_specs is None else
                                     train_state_specs(state,
                                                       built.param_specs)))
    del built, state
    torch.cuda.empty_cache()
    return out


def _mp_rank(group, device, jobs, out_dir, model_group=None):
    """One spawned rank of phase 44: each job's ``mp_run`` on this rank's
    groups, what it saw saved for the parent."""
    import os
    world_rank = group.rank * model_group.size + model_group.rank
    if world_rank:
        sys.stdout = open(os.devnull, "w")
    out = {}
    for job in jobs:
        out[job["tag"]] = mp_run(group, model_group, device, job["argv"],
                                 job.get("cfg"), job.get("run_kw"),
                                 job.get("allow", ()), job.get("save"),
                                 job.get("keep_params", False))
    torch.save(out, f"{out_dir}/rank{world_rank}.pt")


def mp_world(n_data, m_size, jobs, name):
    """Phase 44's world of ``n_data`` × ``m_size`` ranks on the one card
    (gloo on CUDA tensors): each rank's results, in world-rank order."""
    from repro_torch.launch import mesh
    d = scratch_dir(name)
    t0 = time.perf_counter()
    mesh.run_world(_mp_rank, n_data * m_size, "cuda", backend="gloo",
                   args=(jobs, str(d)), model_parallel=m_size)
    wall = time.perf_counter() - t0
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(n_data * m_size)]
    return ranks, wall


def _mp_rank_summary(r) -> dict:
    c = r["collectives"]
    steps = r["steps"]
    return {"launches_a_step": {k: v / steps for k, v in r["launches"].items()
                                if v},
            "model_all_reduce_a_step": c["model_all_reduce"] / steps,
            "model_bytes_a_step": 4 * c["model_elements"] / steps,
            "model_max_message_elements": c["model_max_elements"],
            "data_all_reduce_a_step": c["all_reduce"] / steps,
            "step_ms_median_time_shared": statistics.median(r["step_ms"]),
            "peak_gib": r["peak_gib"]}


def _first_divergence(a, b) -> int:
    """The first step whose draws differ (the run's length if none)."""
    differ = (a != b).any(dim=1).nonzero().flatten().tolist()
    return differ[0] if differ else a.shape[0]


def _scored_rel(r, one) -> dict:
    """How far the scored rows' ω̃ of a rank's store (whole: one data
    rank) lie from the one-device run's: the largest difference over the
    largest ω̃ (``max``), each row's relative difference's median and
    the share of rows beyond MP_LM_RTOL."""
    w, at = r["store"][0].float(), r["store"][1]
    w1, at1 = one["store"][0].float(), one["store"][1]
    if not torch.equal(at, at1):
        fail("model parallel: the scored rows differ from one device's")
    rows = at >= 0
    each = ((w[rows] - w1[rows]).abs() / w1[rows].abs()).double()
    return {"max": rel_err(w[rows], w1[rows]),
            "median": each.median().item(),
            "share_over": (each > MP_LM_RTOL).double().mean().item()}


def phase_model_parallel(train_mod, ref):
    """44: model parallelism over the one card, ranks sharing it over
    gloo (no speed figure: per-rank counts, model-axis bytes and peak
    GiB).  (a) mlp_svhn at phase 3's width, W = 4, 20 relaxed steps at
    ``--model-parallel 4``, ``--model-parallel 2`` and ``--mesh 2
    --model-parallel 2`` against one device in the same call: the first
    steps' draws and losses (rtol 1e-4), the (2, 2) world bitwise the (1,
    2) one, the ranks of a model group bitwise alike; launches a step a
    rank: multi-tap 1, single-tap 1 at M = 4 (the replicated 10-class
    layer) and 0 at M = 2; then 4 async and 4 streamed steps at M = 2.
    (b) glm4-9b × 4 layers (phase 7's call at a score batch of 32) at M =
    2, sequence parallel on and off: 8 ghost_norm launches a step a rank,
    all tensor-core; the scored rows' ω̃ within MP_LM_RTOL of one
    device's and of each other (the MoE archs of (c): the median, and at
    most MP_MOE_SHARE of the rows beyond it), 2 steps each; one flash
    ``attn_scores="fused"`` step at phase 16's seq 512, batch 4.  (c) falcon-mamba-7b
    × 2, dbrx-132b × 1, minicpm3-4b × 2 (the cuts two ranks on one card
    hold in this phase's time) and jamba in phase 31's layout, 2 relaxed
    steps each against one device.  (d) the M = 2 mlp_svhn run's
    gather-free file restored on one device, bit for bit its shards."""
    from repro_torch.checkpoint import restore_checkpoint
    t_phase = time.perf_counter()
    out = {}
    mlp = mlp_argv("--steps", str(MP_STEPS), "--score-shards", str(MP_W))
    plane = mlp_argv("--steps", str(MP_PLANE_STEPS), "--score-shards",
                     str(MP_W))
    mp_flags = lambda m: ["--model-parallel", str(m)]
    ckpt = scratch_dir("chip_smoke_mp_ckpt") / "mp2.npz"
    # phase 7's call at a score batch of 32: two ranks on one card each
    # hold the gathered (rows, 64, 151552) f32 unembed tap, and gloo moves
    # the gathered logits through the host
    lm = LM_ARGV + ["--steps", str(MP_GLM_STEPS), "--score-batch",
                    str(MP_LM_SB)]
    zoo = {
        "falcon_mamba": dict(argv=MAMBA_ARGV + ["--strategy", "ghost",
                                                "--steps", str(MP_LM_STEPS)],
                             cfg=mamba_config(MP_FALCON_LAYERS)),
        "dbrx": dict(argv=DBRX_ARGV + ["--steps", str(MP_LM_STEPS)],
                     cfg=zoo_config("dbrx-132b", num_layers=MP_DBRX_LAYERS),
                     allow=("ghost_norm_direct_ref",)),
        "minicpm3": dict(argv=MINI_ARGV + ["--steps", str(MP_LM_STEPS)],
                         cfg=zoo_config("minicpm3-4b",
                                        num_layers=MP_MINI_LAYERS)),
        "jamba": dict(argv=JAMBA_ARGV + ["--strategy", "ghost", "--steps",
                                         str(MP_LM_STEPS)],
                      cfg=zoo_config("jamba-v0.1-52b", num_layers=2,
                                     attn_every=2, attn_offset=1,
                                     moe_every=2, moe_offset=1),
                      run_kw={"attn_impl": "flash"},
                      allow=("ghost_norm_direct_ref",))}
    # phase 16's seq 512 at a batch of MP_FLASH_B: gloo moves the gathered
    # (batch, 512, 151552) logits through the host, and 16 rows' 2.5 GB
    # messages lost a rank's connection in two of four runs
    flash = dict(argv=FLASH_ARGV + ["--steps", "1", "--batch",
                                    str(MP_FLASH_B), "--score-batch",
                                    str(MP_FLASH_B)],
                 cfg=lm_config(),
                 run_kw={"attn_impl": "flash", "attn_scores": "fused"})

    # one device, the same call
    one = {"mlp": mp_run(None, None, "cuda", mlp),
           "async": mp_run(None, None, "cuda", plane + [
               "--async-scoring", "--swap-every", "2"]),
           "stream": mp_run(None, None, "cuda", plane + [
               "--stream", "--chunk-size", "1024", "--window-chunks", "16"]),
           "glm4": mp_run(None, None, "cuda", lm, lm_config()),
           "flash": mp_run(None, None, "cuda", flash["argv"], flash["cfg"],
                           flash["run_kw"])}
    for name, job in zoo.items():
        one[name] = mp_run(None, None, "cuda", job["argv"], job["cfg"],
                           job.get("run_kw"), job.get("allow", ()))

    # (a) the MLP worlds; (b), (c), (d) ride the (1, 2) world
    jobs2 = [dict(tag="mlp", argv=mlp + mp_flags(2), save=str(ckpt),
                  keep_params=True),
             dict(tag="async", argv=plane + mp_flags(2) + [
                 "--async-scoring", "--swap-every", "2"]),
             dict(tag="stream", argv=plane + mp_flags(2) + [
                 "--stream", "--chunk-size", "1024", "--window-chunks",
                 "16"]),
             dict(tag="glm4_sp", argv=lm + mp_flags(2), cfg=lm_config()),
             dict(tag="glm4_no_sp", argv=lm + mp_flags(2) + [
                 "--no-sequence-parallel"], cfg=lm_config()),
             dict(tag="flash", argv=flash["argv"] + mp_flags(2),
                  cfg=flash["cfg"], run_kw=flash["run_kw"])]
    jobs2 += [dict(tag=name, argv=job["argv"] + mp_flags(2), cfg=job["cfg"],
                   run_kw=job.get("run_kw"), allow=job.get("allow", ()))
              for name, job in zoo.items()]
    # the two MLP worlds side by side (8 ranks of ~2.3 GiB), then (1, 2)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w14 = pool.submit(mp_world, 1, 4, [dict(tag="mlp", argv=mlp
                                                + mp_flags(4))],
                          "chip_smoke_mp14")
        w22 = pool.submit(mp_world, 2, 2, [dict(tag="mlp", argv=mlp + [
            "--mesh", "2"] + mp_flags(2), keep_params=True)],
            "chip_smoke_mp22")
        worlds = {(1, 4): w14.result(), (2, 2): w22.result()}
    worlds[(1, 2)] = mp_world(1, 2, jobs2, "chip_smoke_mp12")

    # (a)
    res = out["a_mlp"] = {}
    for (n, m), (ranks, wall) in worlds.items():
        what = f"model parallel (a) ({n}, {m})"
        for r, got in enumerate(ranks):
            g = got["mlp"]
            expect_launches(g["launches"], {
                "per_example_sqnorm_multi": MP_STEPS,
                "per_example_sqnorm": MP_STEPS if m == 4 else 0},
                f"{what} rank {r}")
            if not all(torch.isfinite(g["metrics"][f]).all()
                       for f in ("loss", "grad_norm")):
                fail(f"{what} rank {r}: non-finite losses or grad norms")
        base = ranks[0]["mlp"]
        for r, got in enumerate(ranks[1:], 1):
            if not (torch.equal(got["mlp"]["indices"], base["indices"])
                    and all(torch.equal(got["mlp"]["metrics"][f],
                                        base["metrics"][f])
                            for f in SHARD_FIELDS)):
                fail(f"{what} rank {r}: draws or metrics differ from rank "
                     f"0's")
        k = _first_divergence(base["indices"], one["mlp"]["indices"])
        loss_err = rel_err(base["metrics"]["loss"][:k],
                           one["mlp"]["metrics"]["loss"][:k])
        if k < MP_CHECK_STEPS or loss_err > CARD_VS_CPU_RTOL:
            fail(f"{what}: draws equal one device's for {k} steps (need "
                 f"{MP_CHECK_STEPS}), losses {loss_err:.2e} from its")
        res[f"{n}x{m}"] = {"same_draws_steps": k, "loss_rel_err": loss_err,
                           "wall_s_with_spawn": wall,
                           "ranks": [_mp_rank_summary(x["mlp"])
                                     for x in ranks]}
        print(f"model parallel (a) mlp_svhn ({n}, {m}): the ranks alike "
              f"bitwise; one device's draws for {k} of {MP_STEPS} steps, "
              f"losses within {loss_err:.2e}; a rank a step: "
              f"{res[f'{n}x{m}']['ranks'][0]}; {wall:.1f} s with the spawn",
              flush=True)
    r12, r22 = worlds[(1, 2)][0], worlds[(2, 2)][0]
    for mr in range(2):
        a, lo, hi = r12[mr]["mlp"], r22[mr]["mlp"], r22[2 + mr]["mlp"]
        # the trace monitors are sums over the data ranks: not bitwise
        if not all(torch.equal(x["indices"], a["indices"]) and all(
                torch.equal(x["metrics"][f], a["metrics"][f])
                for f in PLANE_FIELDS) for x in (lo, hi)):
            fail(f"model parallel (a): the (2, 2) world's model rank {mr} "
                 f"is not bitwise the (1, 2) world's")
        if not (same_tree(lo["params"], a["params"]) and all(
                torch.equal(torch.cat([x, y]), z) for x, y, z in zip(
                    lo["store"], hi["store"], a["store"]))):
            fail("model parallel (a): the (2, 2) world's params or store "
                 "are not the (1, 2) world's")
    for tag in ("async", "stream"):
        for r, got in enumerate(r12):
            g = got[tag]
            expect_launches(g["launches"], {
                "per_example_sqnorm_multi": MP_PLANE_STEPS},
                f"model parallel (a) {tag} rank {r}")
            err = rel_err(g["metrics"]["loss"], one[tag]["metrics"]["loss"])
            if not torch.equal(g["indices"], one[tag]["indices"]) or \
                    err > CARD_VS_CPU_RTOL:
                fail(f"model parallel (a) {tag} rank {r}: draws or losses "
                     f"({err:.2e}) differ from one device's")
        res[tag] = {"loss_rel_err": err,
                    "ranks": [_mp_rank_summary(x[tag]) for x in r12]}
    print(f"model parallel (a) async and streamed at M = 2: one device's "
          f"draws over {MP_PLANE_STEPS} steps, losses within "
          f"{res['async']['loss_rel_err']:.2e} / "
          f"{res['stream']['loss_rel_err']:.2e}", flush=True)

    # (b) and (c)
    for tag, per_step in (("glm4_sp", {"ghost_norm": len(GHOST_MAIN)}),
                          ("glm4_no_sp", {"ghost_norm": len(GHOST_MAIN)}),
                          ("flash", {"flash_attention": 4 * LM_LAYERS,
                                     "flash_attention_bwd": 2 * LM_LAYERS,
                                     "ghost_norm": len(FLASH_GHOST)}),
                          *((name, None) for name in zoo)):
        ref_run = one[tag if tag in one else "glm4"]
        ranks = [x[tag] for x in r12]
        what = f"model parallel {tag}"
        for r, g in enumerate(ranks):
            if per_step is not None:
                expect_launches(g["launches"],
                                {k: v * g["steps"]
                                 for k, v in per_step.items()},
                                f"{what} rank {r}")
                for k in TC_KERNELS:
                    if g["tc"][k] != g["launches"][k]:
                        fail(f"{what} rank {r}: {k} launched "
                             f"{g['launches'][k]} times, {g['tc'][k]} of "
                             f"them tensor-core")
            elif not any(g["launches"].values()):
                fail(f"{what} rank {r}: no kernel launched")
            if not torch.isfinite(g["metrics"]["loss"]).all():
                fail(f"{what} rank {r}: non-finite losses")
        if not (torch.equal(ranks[0]["metrics"]["loss"],
                            ranks[1]["metrics"]["loss"])
                and all(torch.equal(x, y) for x, y in
                        zip(ranks[0]["store"], ranks[1]["store"]))):
            fail(f"{what}: the two model ranks' losses or stores differ")
        err = _scored_rel(ranks[0], ref_run)
        if tag in MP_MOE:
            bad = (err["median"] > MP_LM_RTOL
                   or err["share_over"] > MP_MOE_SHARE)
        else:
            bad = err["max"] > MP_LM_RTOL
        if bad:
            fail(f"{what}: the scored rows' ω̃ from one device's: {err}")
        out[tag] = {"scored_rel_err": err,
                    "losses": ranks[0]["metrics"]["loss"].tolist(),
                    "one_device_losses": ref_run["metrics"]["loss"].tolist(),
                    "ranks": [_mp_rank_summary(g) for g in ranks]}
        print(f"{what}: ω̃ from one device's {err}; a rank a step: "
              f"{out[tag]['ranks'][0]}", flush=True)
    sp_err = _scored_rel(r12[0]["glm4_sp"], r12[0]["glm4_no_sp"])
    out["glm4_sp_vs_no_sp_scored_rel_err"] = sp_err
    if sp_err["max"] > MP_LM_RTOL:
        fail(f"model parallel (b): sequence parallelism moved the scores: "
             f"{sp_err}")
    print(f"model parallel (b): ω̃ with sequence parallelism from ω̃ "
          f"without: {sp_err}", flush=True)

    # (d) the gather-free file restored on one device
    template = train_mod.build(train_mod.parse_args(mlp)).state
    restored, step = restore_checkpoint(ckpt, template)
    whole = {k: {w: torch.cat([r12[0]["mlp"]["params"][k][w],
                               r12[1]["mlp"]["params"][k][w]], dim=-1)
                 for w in ("w", "b")}
             for k in r12[0]["mlp"]["params"]}
    if step != MP_STEPS or not (
            same_tree(_to_dev(restored.params, "cpu"), whole)
            and torch.equal(restored.store.weights.cpu(),
                            r12[0]["mlp"]["store"][0])):
        fail("model parallel (d): the M = 2 file does not restore on one "
             "device as the ranks' shards")
    import numpy as np
    with np.load(ckpt) as z:
        shard = z["params/fc0/w::shard0"].shape
        out["d_checkpoint"] = {"file_mb": ckpt.stat().st_size / 1e6,
                               "fc0_w_shard": list(shard)}
    if shard != (3072, 1024):
        fail(f"model parallel (d): fc0's chunk in the file is {shard}")
    del template, restored
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"model parallel (d): the M = 2 file ({out['d_checkpoint']}) "
          f"restores on one device bit for bit; phase 44 "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


# --- slice 19: serving on the (data, model) groups; the dry run on the card
SG_SLOTS, SG_REQUESTS, SG_MAX_LEN = 8, 16, 256
SG_PROMPT, SG_NEW = (17, 128), (8, 24)
SG_TF_B, SG_TF_S, SG_TF_STEPS = 8, 64, 4   # teacher-forced prefill, steps
SG_BF16 = 2e-2           # bf16 logits of M partial sums vs one device's
SG_ATTN = dict(rtol=2e-5, atol=2e-6)       # f32 merge vs the f32 oracle
# sharded_decode_attention: glm4-9b's decode shape and one long sequence,
# (B, W) with 32/2 heads of 128
SG_ATTN_CASES = {"decode_32k": (8, 32768), "long_500k": (1, 524288)}
SG_LOOP_STEPS = 4
SG_LOOP_ARGV = ["--arch", "glm4-9b", "--mode", "relaxed", "--strategy",
                "ghost", "--seq", "64", "--batch", "8", "--score-batch", "8",
                "--examples", "1024", "--lr", "0.01", "--device", "cuda",
                "--stream", "--async-scoring", "--swap-every", "2",
                "--steps", str(SG_LOOP_STEPS)]
SG_LOOP_SERVE = ["--serve-loop", "--serve-slots", "4", "--serve-prompt-len",
                 "16", "--serve-max-new", "4", "--serve-decode-steps", "2"]
# (d): the other families, cut as in phase 44, through the (1, 2) batcher
SG_ZOO_REQUESTS, SG_ZOO_PROMPT, SG_ZOO_NEW = 4, 32, 4
SG_ZOO_TF = (4, 32, 3)                     # teacher-forced B, S, steps
SG_MOE = ("dbrx", "jamba")


def sg_zoo() -> dict:
    return {"minicpm3": zoo_config("minicpm3-4b", num_layers=2),
            "falcon_mamba": mamba_config(2),
            "jamba": zoo_config("jamba-v0.1-52b", num_layers=2, attn_every=2,
                                attn_offset=1, moe_every=2, moe_offset=1),
            "dbrx": zoo_config("dbrx-132b", num_layers=1)}


def sg_params(cfg, seed, mg, n_data):
    """The whole params from ``seed`` on the card, this model rank's shards
    kept (all of them for one device)."""
    from repro_torch.dist.sharding import mesh_shape, param_pspecs, shard_tree
    from repro_torch.models.transformer import (init_transformer,
                                                transformer_specs)
    params = init_transformer(torch.Generator(device="cuda").manual_seed(seed),
                              cfg, "cuda")
    if mg is not None:
        specs = param_pspecs(transformer_specs(cfg), params,
                             mesh_shape(n_data, mg.size))
        params = shard_tree(params, specs, mg.rank, mg.size)
    torch.cuda.empty_cache()
    return params


def sg_requests(cfg, n, prompt, new, seed):
    """``n`` requests of seeded prompt lengths in ``prompt`` (or all of
    that one length) and budgets in ``new``, tokens drawn on the host."""
    from repro_torch.serving import Request
    g = torch.Generator().manual_seed(seed)
    lo, hi = prompt if isinstance(prompt, tuple) else (prompt, prompt)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    a, b = new if isinstance(new, tuple) else (new, new)
    news = torch.randint(a, b + 1, (n,), generator=g).tolist()
    return [Request(uid=i, prompt=torch.randint(
        0, cfg.vocab_size, (k,), generator=g).to("cuda", torch.int32),
        max_new_tokens=m) for i, (k, m) in enumerate(zip(lens, news))]


def sg_serve(cfg, seed, mg, n_data, ref, reqs, tf):
    """The batcher (the kernels' route, every plain version forbidden)
    over ``reqs``, then a teacher-forced prefill of ``tf`` = (B, S, steps)
    and its decode steps, on this rank's shards (one device when ``mg`` is
    None): tokens, launches, tensor-core launches, logits, wall s."""
    from repro_torch.serving import ContinuousBatcher, make_mesh_serving
    params = sg_params(cfg, seed, mg, n_data)
    b, s, steps = tf
    g = torch.Generator().manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    teacher = torch.randint(0, cfg.vocab_size, (steps, b), generator=g)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        batcher = ContinuousBatcher(params, cfg, num_slots=SG_SLOTS,
                                    max_len=SG_MAX_LEN, decode_kernel="pallas",
                                    attn_impl="pallas", model_group=mg)
        finished = run_forbidding_plain(ref, lambda: batcher.run(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    wrappers = kernel_wrappers()
    tc = {k: wrappers[k].tc_launches for k in TC_KERNELS}
    pre, dec = make_mesh_serving(cfg, s + steps, mg, decode_kernel="pallas",
                                 attn_impl="pallas")

    def forced():
        logits, st = pre(params, prompts.to("cuda", torch.int32), s)
        out = [logits.float()]
        for tok in teacher:
            logits, st = dec(params, tok.to("cuda", torch.int32), st, None)
            out.append(logits.float())
        return torch.stack(out)
    with torch.no_grad():
        logits = run_forbidding_plain(ref, forced).cpu()
    del batcher, params
    torch.cuda.empty_cache()
    return {"tokens": {u: list(t) for u, t in finished.items()},
            "launches": launches, "tc": tc, "wall_s": wall,
            "logits": logits}


def sg_attention(group) -> dict:
    """sharded_decode_attention over ``group`` (this rank's slots of the
    whole seeded cache) on SG_ATTN_CASES: bf16 K and V, the query's bf16
    values in f32, one sequence whose valid slots lie on rank 0 alone;
    rank 0 also gives the plain f32 oracle and the decode kernel (bf16)
    on the whole cache."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import sharded_decode_attention
    out = {}
    for name, (b, w) in SG_ATTN_CASES.items():
        g = torch.Generator(device="cuda").manual_seed(4500 + b)
        q = torch.randn(b, 32, 128, generator=g, device="cuda").to(
            torch.bfloat16)
        k = torch.randn(b, w, 2, 128, generator=g, device="cuda").to(
            torch.bfloat16)
        v = torch.randn(b, w, 2, 128, generator=g, device="cuda").to(
            torch.bfloat16)
        lengths = torch.randint(w // 2, w + 1, (b,), generator=g,
                                device="cuda", dtype=torch.int32)
        lengths[0] = w // (2 * group.size)
        w_loc = w // group.size
        sl = slice(group.rank * w_loc, (group.rank + 1) * w_loc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded_decode_attention(q.float(), k[:, sl], v[:, sl],
                                       lengths, group)
        torch.cuda.synchronize()
        res = {"out": got.cpu(), "ms": (time.perf_counter() - t0) * 1e3}
        if group.rank == 0:
            res["oracle"] = ref.decode_attention_ref(
                q.float(), k.float(), v.float(), lengths).cpu()
            res["kernel"] = ops.decode_attention(q, k, v, lengths).float().cpu()
        out[name] = res
        del q, k, v
    torch.cuda.empty_cache()
    return out


def sg_loop(train_mod, ref, group, mg, device) -> dict:
    """(b): SG_LOOP_ARGV on this rank's groups through the launcher's
    build, without and then with the serve loop, every plain version
    forbidden: step ms (CUDA events, time-shared), launches, rows ingested
    and live."""
    from repro_torch.core.distributed import shard_train_state
    from repro_torch.core.weight_store import EMPTY
    out = {}
    for name, extra in (("no_serve", []), ("serve", SG_LOOP_SERVE)):
        args = train_mod.parse_args(SG_LOOP_ARGV + extra)
        args.device = device
        torch.cuda.empty_cache()
        built = train_mod.build(args, lm_config(), group=group,
                                model_group=mg)
        built = built._replace(state=shard_train_state(
            built.state, group, torch.device(device),
            param_specs=built.param_specs, model_group=mg))
        reset_counts()
        state, mets, ms, wall = run_forbidding_plain(
            ref, lambda: drive(built, SG_LOOP_STEPS))
        r = {"step_ms": ms, "launches": read_counts(),
             "losses": [float(m.loss) for m in mets]}
        if built.serve is not None:
            store = state.store.write_buf if hasattr(state.store,
                                                     "write_buf") \
                else state.store
            n_live = args.examples
            r["ingested"] = built.serve.ingest.ingested
            r["live"] = int((store.scored_at[n_live:] != EMPTY).sum())
            r["finished"] = len(built.serve.batcher.finished)
        out[name] = r
        del built, state
        torch.cuda.empty_cache()
    return out


def _sg_rank(group, device, out_dir, model_group=None):
    """One spawned rank of phase 45."""
    import os
    from repro_torch.dist import DataGroup
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_mod
    world_rank = group.rank * model_group.size + model_group.rank
    world = group.size * model_group.size
    if world_rank:
        sys.stdout = open(os.devnull, "w")
    train_mod.use_full_f32()
    cfg = lm_config()
    out = {"glm4": sg_serve(cfg, 45, model_group, group.size, ref,
                            sg_requests(cfg, SG_REQUESTS, SG_PROMPT, SG_NEW,
                                        46),
                            (SG_TF_B, SG_TF_S, SG_TF_STEPS)),
           "attention": sg_attention(DataGroup(None, world_rank, world))}
    if (group.size, model_group.size) == (1, 2):
        out["loop"] = sg_loop(train_mod, ref, group, model_group, device)
        for i, (name, zcfg) in enumerate(sg_zoo().items()):
            out[name] = sg_serve(zcfg, 50 + i, model_group, 1, ref,
                                 sg_requests(zcfg, SG_ZOO_REQUESTS,
                                             SG_ZOO_PROMPT, SG_ZOO_NEW,
                                             60 + i), SG_ZOO_TF)
    torch.save(out, f"{out_dir}/rank{world_rank}.pt")


def sg_world(n_data, m_size, name):
    """Phase 45's world of ``n_data`` × ``m_size`` ranks sharing the card
    (gloo on CUDA tensors): each rank's results, world-rank order."""
    from repro_torch.launch import mesh
    d = scratch_dir(name)
    t0 = time.perf_counter()
    mesh.run_world(_sg_rank, n_data * m_size, "cuda", backend="gloo",
                   args=(str(d),), model_parallel=m_size)
    wall = time.perf_counter() - t0
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(n_data * m_size)], wall


def _row_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each row's largest |a − b| over its largest |b| (last axis)."""
    return ((a - b).abs().amax(-1) / b.abs().amax(-1)).flatten()


def _token_share(got: dict, want: dict) -> float:
    same = total = 0
    for uid, toks in want.items():
        same += sum(int(x == y) for x, y in zip(got[uid], toks))
        total += len(toks)
    return same / total


def phase_serving_groups(train_mod, ref):
    """45: serving on the (data, model) groups, ranks sharing the card over
    gloo (no speed figure: launches, agreement, bitwise contracts).  (a)
    glm4-9b at full width, 4 layers, bf16: 16 requests of seeded lengths
    through 8 slots of the model-group batcher at (data, model) = (1, 2)
    and (2, 2) against the one-device batcher of the same call, every
    plain version forbidden: teacher-forced logits (a (8, 64) prefill, 4
    steps) within SG_BF16, the share of greedy tokens that agree, each
    data world bitwise data world 1, the ranks of a model group alike, 4
    flash_attention launches a prefill and 4 decode_attention a token step
    a rank (16/1 local heads), all tensor-core.  (b) SG_LOOP_ARGV with
    --mesh 1 over NCCL in this process, and with --mesh 1
    --model-parallel 2 on the (1, 2) world, without and with the serve
    loop: rows ingested and live, step ms.  (c) sharded_decode_attention
    over the worlds' 2 and 4 ranks at SG_ATTN_CASES against the plain f32
    oracle on the whole cache (SG_ATTN), beside the decode kernel's
    result.  (d) minicpm3-4b × 2, falcon-mamba-7b × 2, jamba in phase
    31's layout and dbrx-132b × 1 through the (1, 2) batcher: teacher-
    forced logits against one device's (the MoE archs at the median
    row)."""
    import gc
    t_phase = time.perf_counter()
    out = {}
    # one device, the same call
    cfg = lm_config()
    one = {"glm4": sg_serve(cfg, 45, None, 1, ref,
                            sg_requests(cfg, SG_REQUESTS, SG_PROMPT,
                                        SG_NEW, 46),
                            (SG_TF_B, SG_TF_S, SG_TF_STEPS))}
    for i, (name, zcfg) in enumerate(sg_zoo().items()):
        one[name] = sg_serve(zcfg, 50 + i, None, 1, ref,
                             sg_requests(zcfg, SG_ZOO_REQUESTS,
                                         SG_ZOO_PROMPT, SG_ZOO_NEW,
                                         60 + i), SG_ZOO_TF)
    # (b) --mesh 1 over NCCL, in this process
    nccl = {}
    for name, extra in (("no_serve", []), ("serve", SG_LOOP_SERVE)):
        reset_counts()
        res = run_forbidding_plain(ref, lambda: train_mod.main(
            SG_LOOP_ARGV + ["--mesh", "1"] + extra, lm_config()))
        nccl[name] = {"step_ms": res.step_ms, "launches": read_counts()}
        if name == "serve":
            built = res.built
            from repro_torch.core.weight_store import EMPTY
            store = built.state.store.write_buf
            nccl[name]["ingested"] = built.serve.ingest.ingested
            nccl[name]["live"] = int(
                (store.scored_at[1024:] != EMPTY).sum())
            del built, store
        del res
        torch.cuda.empty_cache()
    # then the two worlds, one after the other: side by side (six ranks,
    # each building the whole params on the card before it keeps its
    # shards) while this process also served and trained, they once ran
    # the card out of memory at a rank's init (79 GiB in use)
    gc.collect()
    torch.cuda.empty_cache()
    worlds = {(1, 2): sg_world(1, 2, "chip_smoke_sg12"),
              (2, 2): sg_world(2, 2, "chip_smoke_sg22")}

    # (a)
    a = out["a_glm4"] = {"one_device_wall_s": one["glm4"]["wall_s"]}
    layers = LM_LAYERS
    for (n, m), (ranks, wall) in worlds.items():
        tag = f"{n}x{m}"
        for r, got in enumerate(ranks):
            g = got["glm4"]
            what = f"serving groups (a) ({n}, {m}) rank {r}"
            prefills = g["launches"]["flash_attention"]
            if prefills != layers * SG_REQUESTS or \
                    g["launches"]["decode_attention"] % layers:
                fail(f"{what}: launches {g['launches']}")
            for k in ("flash_attention", "decode_attention"):
                if g["tc"][k] != g["launches"][k]:
                    fail(f"{what}: {k} launched {g['launches'][k]} times, "
                         f"{g['tc'][k]} of them tensor-core")
            if sorted(g["tokens"]) != list(range(SG_REQUESTS)):
                fail(f"{what}: finished {sorted(g['tokens'])}")
            if not torch.isfinite(g["logits"]).all():
                fail(f"{what}: non-finite logits")
            if not torch.equal(g["logits"], ranks[0]["glm4"]["logits"]) or \
                    g["tokens"] != ranks[0]["glm4"]["tokens"]:
                fail(f"{what}: logits or tokens differ from rank 0's")
        g = ranks[0]["glm4"]
        err = rel_err(g["logits"], one["glm4"]["logits"])
        if err > SG_BF16:
            fail(f"serving groups (a) ({n}, {m}): teacher-forced logits "
                 f"{err:.2e} from one device's")
        a[tag] = {"logits_rel_err": err,
                  "token_agreement": _token_share(g["tokens"],
                                                  one["glm4"]["tokens"]),
                  "flash_attention_a_prefill":
                      g["launches"]["flash_attention"] / SG_REQUESTS,
                  "decode_attention_a_step": layers,
                  "decode_steps": g["launches"]["decode_attention"] // layers,
                  "launches_rank0": g["launches"],
                  "batcher_wall_s_time_shared": g["wall_s"],
                  "wall_s_with_spawn": wall}
        print(f"serving groups (a) glm4-9b × {layers} ({n}, {m}): logits "
              f"within {err:.2e} of one device's, {a[tag]['token_agreement']:.3f}"
              f" of the greedy tokens agree; a rank: {layers} flash_attention"
              f" a prefill, {layers} decode_attention a step "
              f"({a[tag]['decode_steps']} steps), all tensor-core; "
              f"{wall:.1f} s with the spawn",
              flush=True)
    r12, r22 = worlds[(1, 2)][0], worlds[(2, 2)][0]
    for d in range(2):
        for mr in range(2):
            x, y = r22[d * 2 + mr]["glm4"], r12[mr]["glm4"]
            if not (torch.equal(x["logits"], y["logits"])
                    and x["tokens"] == y["tokens"]):
                fail(f"serving groups (a): the (2, 2) world's rank ({d}, "
                     f"{mr}) is not bitwise the (1, 2) world's")
    a["data_world_2_is_data_world_1"] = "bitwise"

    # (b)
    loop = r12[0]["loop"]
    for name, res in (("mesh 1 (NCCL)", nccl), ("(1, 2) gloo", loop)):
        s = res["serve"]
        if s["ingested"] < 1 or s["live"] < 1:
            fail(f"serving groups (b) {name}: {s['ingested']} rows ingested, "
                 f"{s['live']} live")
        if s["launches"]["ghost_norm"] != len(GHOST_MAIN) * SG_LOOP_STEPS:
            fail(f"serving groups (b) {name}: launches {s['launches']}")
    out["b_loop"] = {
        tag: {"ingested": res["serve"]["ingested"],
              "live": res["serve"]["live"],
              "step_ms_no_tick": statistics.median(res["no_serve"]["step_ms"][1:]),
              "step_ms_with_tick": statistics.median(res["serve"]["step_ms"][1:]),
              "launches_with_tick": res["serve"]["launches"]}
        for tag, res in (("mesh1_nccl", nccl), ("mesh1_mp2_gloo_rank0", loop))}
    print(f"serving groups (b): {json.dumps(out['b_loop'])}", flush=True)

    # (c)
    c = out["c_attention"] = {}
    for (n, m), (ranks, _) in worlds.items():
        size = n * m
        for name in SG_ATTN_CASES:
            r0 = ranks[0]["attention"][name]
            oracle = r0["oracle"]
            for r, got in enumerate(ranks):
                x = got["attention"][name]["out"]
                if not torch.allclose(x, oracle, **SG_ATTN):
                    fail(f"serving groups (c) {name} over {size} ranks, rank "
                         f"{r}: {rel_err(x, oracle):.2e} from the oracle")
            c[f"{name}_world{size}"] = {
                "rel_err": rel_err(r0["out"], oracle),
                "kernel_bf16_rel_err": rel_err(r0["kernel"], oracle),
                "ms_rank0_time_shared": r0["ms"]}
    print(f"serving groups (c): {json.dumps(c)}", flush=True)

    # (d)
    dz = out["d_zoo"] = {}
    for name in sg_zoo():
        ranks = worlds[(1, 2)][0]
        g, want = ranks[0][name], one[name]
        if not torch.equal(g["logits"], ranks[1][name]["logits"]):
            fail(f"serving groups (d) {name}: the model ranks' logits differ")
        rows = _row_rel(g["logits"], want["logits"])
        bad = rows.median().item() if name in SG_MOE else rows.max().item()
        if not math.isfinite(bad) or bad > SG_BF16:
            fail(f"serving groups (d) {name}: teacher-forced logits {bad:.2e}"
                 f" from one device's")
        dz[name] = {"row_rel_err_max": rows.max().item(),
                    "row_rel_err_median": rows.median().item(),
                    "token_agreement": _token_share(g["tokens"],
                                                    want["tokens"]),
                    "launches_rank0": g["launches"]}
    print(f"serving groups (d): {json.dumps(dz)}", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"serving groups: phase 45 {out['wall_s']:.1f} s", flush=True)
    return out


# phase 46: a train shape one rank's share fits at 16×16 (launch/dryrun.py
# over the CPU: peak 43.35 GiB a rank), beside decode_32k
DRY_TRAIN_ARCH = "deepseek-7b"


def phase_dryrun_card():
    """46: one rank (rank 0 of 16×16) of the dry run's layout run for real
    on the card, the fake backend on real CUDA tensors (collectives do
    nothing: only the bytes mean anything): glm4-9b decode_32k and
    deepseek-7b at a train shape of seq 512, batch 32.  The fake run's
    argument bytes against the real tensors' (exactly) and the
    allocator's; its peak beside torch.cuda.max_memory_allocated."""
    from repro_torch.launch import dryrun, shapes
    t_phase = time.perf_counter()
    out = {}
    train = shapes.InputShape("train_512x32", "train", 512, 32)
    for tag, arch, shape in (("decode_32k", "glm4-9b",
                              shapes.SHAPES["decode_32k"]),
                             ("train_512x32", DRY_TRAIN_ARCH, train)):
        r = dryrun.run_real(arch, shape, False, device="cuda")
        pred = r["predicted"]
        if r["real_argument_bytes"] != pred["argument_bytes"]:
            fail(f"dry run {tag}: the real arguments hold "
                 f"{r['real_argument_bytes']} bytes, the fake run "
                 f"{pred['argument_bytes']}")
        gap = r["max_memory_allocated"] - pred["peak_bytes"]
        r["peak_gap_bytes"] = gap
        r["peak_gap_share"] = gap / pred["peak_bytes"]
        out[tag] = r
        print(f"dry run on the card ({arch} {tag}, rank 0 of 16×16): "
              f"argument bytes {pred['argument_bytes']} predicted = "
              f"{r['real_argument_bytes']} real ({r['allocated_argument_bytes']}"
              f" allocated); peak {pred['peak_bytes'] / 2**30:.3f} GiB "
              f"predicted, {r['max_memory_allocated'] / 2**30:.3f} GiB "
              f"max_memory_allocated ({gap / 2**30:+.3f} GiB); the step "
              f"{r['step_s']:.2f} s", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# phase 47: ModelConfig.remat on against off at the earlier phases' cuts
# (a), the depths remat opens (b) and phase 46's train shape (c)
REMAT_FALCON_LAYERS, REMAT_MINI_LAYERS, REMAT_DBRX_LAYERS = 2, 2, 1
REMAT_GLM_FULL, REMAT_FALCON_FULL = 40, 64
REMAT_PEAK_GAP_GIB = 0.1     # (c): the dry run's peak vs the allocator's


def remat_step(train_mod, ref, argv, cfg, allow=(), keep=True, **run_kw):
    """The build's state through one trainer step on fixed draws, after a
    warm-up step from the same state: the timed step's loss, store (the
    scores it wrote) and new params (on the host, with ``keep``), its ms
    (CUDA events) and wall s, peak GiB (``max_memory_allocated``, beside
    the GiB earlier phases left allocated before the build) and
    launches, and whether every weight but the norm scales moved (a bf16
    scale may round back to 1)."""
    from repro_torch.optim import tree_leaves
    base = torch.cuda.memory_allocated() / 2**30
    args = train_mod.parse_args(argv + ["--steps", "1"])
    built = train_mod.build(args, cfg, **run_kw)
    idx = torch.randint(0, args.examples, (args.batch,), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(47))
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        w0 = time.perf_counter()
        e0.record()
        st, m = run_forbidding_plain(ref, lambda: built.step(
            built.state, built.data, sample_indices=idx), allow=allow)
        e1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        launches = read_counts()
        scored = kernel_wrappers()["flash_attention_bwd"].scored
        peak = torch.cuda.max_memory_allocated() / 2**30
        if i == 0:
            del st, m
    check_tc(launches, f"remat {cfg.name} × {cfg.num_layers}")
    moved = all(not torch.equal(a, b) for a, b in
                zip(_weights(st.params), _weights(built.state.params)))
    out = {"ms": e0.elapsed_time(e1), "wall_s": wall, "peak_gib": peak,
           "base_gib": base, "launches": launches, "scored_bwd_calls": scored,
           "loss": m.loss.item(), "moved": moved}
    if keep:
        out["results"] = [t.cpu() for t in (m.loss, st.store.weights,
                                            *tree_leaves(st.params))]
    del built, st, m
    return out


def _weights(tree):
    """The leaves of a parameter tree but its norm scales."""
    return [w for k, v in tree.items() if k != "scale"
            for w in (_weights(v) if isinstance(v, dict) else [v])]


def remat_pair(train_mod, ref, tag, argv, cfg, allow=(), **run_kw):
    """``remat_step`` with remat off, then on: bitwise equal losses,
    scores and new params, or fail.  The results wait on the host, so
    that neither run's peak holds the other's."""
    runs = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        runs[remat] = remat_step(train_mod, ref, argv, dataclasses.replace(
            cfg, remat=remat), allow, **run_kw)
    off, on = runs[False].pop("results"), runs[True].pop("results")
    same = len(on) == len(off) and all(torch.equal(a, b)
                                       for a, b in zip(on, off))
    del off, on
    torch.cuda.empty_cache()
    if not same:
        fail(f"remat (a) {tag}: the step's loss, scores or params differ "
             f"with remat on and off")
    for remat, r in runs.items():
        if not (math.isfinite(r["loss"]) and r["moved"]):
            fail(f"remat (a) {tag} remat={remat}: loss {r['loss']}, params "
                 f"moved {r['moved']}")
    # the recompute runs each trained forward's flash kernel once more;
    # no other kernel is in a forward that runs under grad
    want = {k: n * (2 if k == "flash_attention" else 1)
            for k, n in runs[False]["launches"].items()}
    if runs[True]["launches"] != want or runs[True]["scored_bwd_calls"] != \
            runs[False]["scored_bwd_calls"]:
        fail(f"remat (a) {tag}: launches {runs[True]['launches']} with "
             f"remat; expected {want}")
    res = {"bitwise": same, "off": runs[False], "on": runs[True]}
    flash = {k: [runs[x]["launches"][k] for x in (False, True)]
             for k in ("flash_attention", "flash_attention_bwd")}
    print(f"remat (a) {tag}: {cfg.name} × {cfg.num_layers}, loss, scores "
          f"and params bitwise equal on and off; step "
          f"{runs[False]['ms']:.1f} / {runs[True]['ms']:.1f} ms, peak "
          f"{runs[False]['peak_gib']:.2f} / {runs[True]['peak_gib']:.2f} GiB "
          f"(off / on; {runs[True]['base_gib']:.2f} GiB allocated before "
          f"each build); flash launches a step {flash}", flush=True)
    return res


def phase_remat(train_mod, ref, dry_card):
    """47: ``ModelConfig.remat``.  (a) one trainer step with remat off and
    on at the cut depths of phases 7, 16, 20, 30 and 31, bitwise; (b) the
    depths remat opens: glm4-9b × 40 at the flash trainer's shape with
    ghost_rev, falcon-mamba-7b × 64 with the scan-kernel scorer and the
    master on the ref scan; (c) phase 46's train shape, which now remats:
    its predicted peak against the allocator's."""
    t_phase = time.perf_counter()
    out = {"a": {}}
    flash = ("flash", "fused"), ("flash", "separate")
    for tag, argv, cfg, allow, kw in (
            ("glm4_ghost", LM_ARGV, lm_config(), (), {}),
            *((f"flash_{v}", FLASH_ARGV, lm_config(), (),
               dict(attn_impl=i, attn_scores=v)) for i, v in flash),
            ("falcon_ghost", MAMBA_ARGV + ["--strategy", "ghost"],
             mamba_config(REMAT_FALCON_LAYERS), (), {}),
            ("minicpm3_ghost", [a if a != "ghost_rev" else "ghost"
                                for a in MINI_ARGV],
             zoo_config("minicpm3-4b", num_layers=REMAT_MINI_LAYERS), (),
             {}),
            ("dbrx_flash", DBRX_ARGV, zoo_config(
                "dbrx-132b", num_layers=REMAT_DBRX_LAYERS),
             ("ghost_norm_direct_ref",),
             dict(attn_impl="flash", attn_scores="fused"))):
        out["a"][tag] = remat_pair(train_mod, ref, tag, argv, cfg, allow,
                                   **kw)

    out["b"] = {}
    rev = [a if a != "ghost" else "ghost_rev" for a in FLASH_ARGV]
    for tag, argv, cfg, kw in (
            ("glm4_full", rev, lm_config(REMAT_GLM_FULL),
             dict(attn_impl="flash", attn_scores="fused")),
            ("falcon_full", MAMBA_ARGV + ["--strategy", "logit_grad"],
             mamba_config(REMAT_FALCON_FULL), dict(ssm_mode="pallas"))):
        torch.cuda.empty_cache()
        r = remat_step(train_mod, ref, argv, cfg, keep=False, **kw)
        torch.cuda.empty_cache()
        if not (math.isfinite(r["loss"]) and r["moved"]):
            fail(f"remat (b) {tag}: loss {r['loss']}, params moved "
                 f"{r['moved']}")
        r["layers"] = cfg.num_layers
        out["b"][tag] = r
        print(f"remat (b) {tag}: {cfg.name} × {cfg.num_layers} with remat, "
              f"{' '.join(argv[argv.index('--strategy'):][:2])}, after one "
              f"warm-up step: {r['ms']:.1f} ms ({r['wall_s']:.1f} s wall), "
              f"peak {r['peak_gib']:.2f} GiB ({r['base_gib']:.2f} before the "
              f"build), loss {r['loss']:.4f}, every weight moved; "
              f"launches {r['launches']}", flush=True)

    t = dry_card["train_512x32"]
    gap = t["peak_gap_bytes"] / 2**30
    if abs(gap) > REMAT_PEAK_GAP_GIB:
        fail(f"remat (c): the dry run's remat peak "
             f"{t['predicted']['peak_bytes'] / 2**30:.3f} GiB is {gap:+.3f} "
             f"GiB from the allocator's")
    out["c"] = {"predicted_gib": t["predicted"]["peak_bytes"] / 2**30,
                "allocator_gib": t["max_memory_allocated"] / 2**30,
                "gap_gib": gap}
    print(f"remat (c): {DRY_TRAIN_ARCH} train_512x32 with remat: peak "
          f"{out['c']['predicted_gib']:.3f} GiB predicted, "
          f"{out['c']['allocator_gib']:.3f} GiB allocated ({gap:+.3f})",
          flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"remat: phase 47 {out['wall_s']:.1f} s", flush=True)
    return out


# --- slice 21: the batch-split master (split_batch, off by default)
SPLIT_MLP_STEPS = 10      # (a): refresh every 8: the draws equal to step 8
SPLIT_LM_STEPS = 2        # (b): the flash trainer's steps
SPLIT_DBRX_STEPS = 2      # (c): DBRX_ARGV refreshes every step, so that
#                           the stale params alias the params (a copy would
#                           be 8.4 GiB more a rank): equal draws at step 0
SPLIT_LM_W = 2            # the LMs' logical scoring shards, one a rank


def split_run(group, device, job):
    """``mp_run`` of ``job`` with the launcher's ``make_sharded_train_step``
    building the batch-split master (``split_batch=True``; on one device
    the step is the unsplit one) and, for an MoE arch (``job["moe"]``),
    the master's loss with the minibatch's ``BatchSplit``.  Beside what
    ``mp_run`` saw: the rows each master loss call took, the parameter
    leaves and elements, and the dropped share of each MoE layer in the
    master's forwards."""
    from repro_torch.dist import BatchSplit
    from repro_torch.launch import train as train_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import remat, transformer
    from repro_torch.optim import tree_leaves
    orig, real_moe = train_mod.make_sharded_train_step, moe_mod.moe
    seen = {"rows": [], "master": False, "dropped": [], "leaves": None}

    def make(pel, scorer, opt, tcfg, n, group_, **kw):
        if job.get("moe") and group_ is not None:
            cfg = job["cfg"]
            attn = (job.get("run_kw") or {}).get("attn_impl", "ref")
            split = BatchSplit(group_, tcfg.batch_size)
            pel = lambda p, b: transformer.per_example_loss(
                p, cfg, b, attn_impl=attn, batch_split=split)[0]
        inner = pel

        def master_loss(p, b):
            if seen["leaves"] is None:
                leaves = tree_leaves(p)
                seen["leaves"] = (len(leaves), sum(t.numel() for t in leaves))
            seen["rows"].append(next(iter(b.values())).shape[0])
            seen["master"] = True
            try:
                return inner(p, b)
            finally:
                seen["master"] = False
        return orig(master_loss, scorer, opt, tcfg, n, group_,
                    split_batch=True, **kw)

    def spy(*a, **kw):
        out = real_moe(*a, **kw)
        if seen["master"] and not remat.recomputing():
            seen["dropped"].append(out.dropped_frac.detach())
        return out

    train_mod.make_sharded_train_step, moe_mod.moe = make, spy
    try:
        res = mp_run(group, None, device, job["argv"], job.get("cfg"),
                     job.get("run_kw"), job.get("allow", ()),
                     keep_params=job.get("keep_params", False))
    finally:
        train_mod.make_sharded_train_step, moe_mod.moe = orig, real_moe
    res["master_rows"] = seen["rows"]
    res["param_leaves"], res["param_elements"] = seen["leaves"]
    res["dropped"] = (torch.stack(seen["dropped"]).cpu() if seen["dropped"]
                      else None)
    return res


def _split_rank(group, device, jobs, out_dir):
    """One spawned rank of phase 48: each job's ``split_run`` twice."""
    import os
    if group.rank:
        sys.stdout = open(os.devnull, "w")
    out = {job["tag"]: [split_run(group, device, job) for _ in range(2)]
           for job in jobs}
    torch.save(out, f"{out_dir}/rank{group.rank}.pt")


def _same_run(a, b) -> bool:
    """Two runs' draws, metrics, store, dropped shares and (when kept)
    params bitwise equal."""
    return (torch.equal(a["indices"], b["indices"])
            and all(torch.equal(a["metrics"][f], b["metrics"][f])
                    for f in SHARD_FIELDS)
            and all(torch.equal(x, y) for x, y in zip(a["store"],
                                                      b["store"]))
            and (a["dropped"] is None or torch.equal(a["dropped"],
                                                     b["dropped"]))
            and (a["params"] is None or same_tree(a["params"], b["params"])))


def _median_share(a: torch.Tensor, b: torch.Tensor, tol: float) -> dict:
    """Each element's relative difference of ``a`` from ``b``: its median
    and the share of elements beyond ``tol``."""
    each = ((a.double() - b.double()).abs()
            / b.double().abs().clamp_min(1e-30))    # 0 where both are 0
    return {"median": each.median().item(),
            "share_over": (each > tol).double().mean().item()}


def phase_batch_split(train_mod, ref):
    """48: the batch-split master (``split_batch=True``, the reference's
    ``constrain_batch``), a world of 2 ranks sharing the one card over
    gloo on CUDA tensors, each split run against the one-device run of
    the same call: (a) mlp_svhn at full width, relaxed, ghost, W = 4, 10
    steps; (b) glm4-9b at phase 7's cut on the flash path with the fused
    score (phase 16's shape), 2 steps; (c) dbrx-132b × 1, capacity drops
    on, 2 steps.  The draws equal one device's until the first refresh,
    the losses and grad norms within 1e-4 (f32) or 5e-2 (bf16; dbrx's
    dropped shares and scores at the median, at most a quarter beyond),
    the ranks alike and two split runs bitwise equal; a rank's master at
    its B/2 rows; launches a step a rank: 1 multi-tap (a); 16 flash
    forward, 8 backward (4 scored) and 5 ghost_norm (b); every
    tensor-core kernel on its tensor-core instance; the gradient
    all-reduces a step counted."""
    import gc
    import os
    from repro_torch.dist import DataGroup, batch_block
    from repro_torch.launch import mesh
    from repro_torch.optim import tree_leaves
    t_phase = time.perf_counter()
    # blocks: the scorer's launches on one device over a rank's (the MLP's
    # multi-tap kernel takes every row block in one launch)
    jobs = [dict(tag="mlp", keep_params=True, tol=CARD_VS_CPU_RTOL, blocks=1,
                 argv=mlp_argv("--steps", str(SPLIT_MLP_STEPS),
                               "--score-shards", str(SHARD_W)),
                 per_step={"per_example_sqnorm_multi": 1}),
            dict(tag="glm4_flash", tol=MP_LM_RTOL, cfg=lm_config(),
                 blocks=SPLIT_LM_W,
                 argv=FLASH_ARGV + ["--steps", str(SPLIT_LM_STEPS),
                                    "--score-shards", str(SPLIT_LM_W)],
                 run_kw={"attn_impl": "flash", "attn_scores": "fused"},
                 per_step={"flash_attention": 4 * LM_LAYERS,
                           "flash_attention_bwd": 2 * LM_LAYERS,
                           "ghost_norm": len(FLASH_GHOST)},
                 scored=LM_LAYERS),
            dict(tag="dbrx", tol=MP_LM_RTOL, moe=True, blocks=SPLIT_LM_W,
                 cfg=zoo_config("dbrx-132b", num_layers=MP_DBRX_LAYERS),
                 argv=DBRX_ARGV + ["--steps", str(SPLIT_DBRX_STEPS),
                                   "--score-shards", str(SPLIT_LM_W)],
                 allow=("ghost_norm_direct_ref",))]
    one = {}
    for job in jobs:
        torch.cuda.empty_cache()
        one[job["tag"]] = split_run(None, "cuda", job)
    # two ranks of dbrx × 1 (~34 GiB each at the f32 grad norm) and this
    # process share the card: free what the earlier phases left behind,
    # and let the ranks' allocators grow their segments in place (with
    # fixed segments ~5 GiB a rank stayed reserved but unallocated)
    gc.collect()
    torch.cuda.empty_cache()
    held = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    d = scratch_dir("chip_smoke_batch_split")
    t0 = time.perf_counter()
    try:
        mesh.run_world(_split_rank, 2, "cuda", backend="gloo",
                       args=(jobs, str(d)))
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    wall = time.perf_counter() - t0
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    out = {"wall_s_world_with_spawn": wall, "parent_at_spawn": held}
    for job in jobs:
        tag, tol = job["tag"], job["tol"]
        what = f"batch split {tag}"
        base = one[tag]
        steps = base["steps"]
        refresh, batch = (_argv_last(job["argv"], f)
                          for f in ("--refresh-every", "--batch"))
        if set(base["master_rows"]) != {batch}:
            fail(f"{what}: the one-device master took {base['master_rows']}"
                 f" rows")
        runs = [x[tag] for x in ranks]
        for r, (g, again) in enumerate(runs):
            if not _same_run(g, again):
                fail(f"{what} rank {r}: two split runs differ")
            lo, hi = batch_block(batch, DataGroup(None, r, 2))
            if set(g["master_rows"]) != {hi - lo}:
                fail(f"{what} rank {r}: the master took {g['master_rows']} "
                     f"rows; its block is {hi - lo}")
            if "per_step" in job:
                expect_launches(g["launches"], {
                    k: v * steps for k, v in job["per_step"].items()},
                    f"{what} rank {r}")
            elif not any(g["launches"].values()):
                fail(f"{what} rank {r}: no kernel launched")
            if "scored" in job and g["scored"] != job["scored"] * steps:
                fail(f"{what} rank {r}: {g['scored']} scored backward "
                     f"launches in {steps} steps")
            for k in TC_KERNELS:
                if g["tc"][k] != g["launches"][k]:
                    fail(f"{what} rank {r}: {k} launched {g['launches'][k]} "
                         f"times, {g['tc'][k]} of them tensor-core")
            # one device scores both shards' row blocks, a rank its own
            scorer = ("ghost_norm", "per_example_sqnorm_multi")
            if any(job["blocks"] * g["launches"][k] != base["launches"][k]
                   for k in scorer):
                fail(f"{what} rank {r}: scorer launches {g['launches']} "
                     f"against one device's {base['launches']}")
            c = g["collectives"]
            leaves, elements = g["param_leaves"], g["param_elements"]
            if c["all_reduce"] < steps * (leaves + 1) or \
                    c["elements"] < steps * (elements + 1):
                fail(f"{what} rank {r}: {c} in {steps} steps; the split "
                     f"sums {leaves} leaves of {elements} elements a step")
        r0, r1 = runs[0][0], runs[1][0]
        if not (torch.equal(r0["indices"], r1["indices"]) and all(
                torch.equal(r0["metrics"][f], r1["metrics"][f])
                for f in ("loss", "grad_norm", "mean_weight"))):
            fail(f"{what}: the two ranks' draws or metrics differ")
        k = _first_divergence(r0["indices"], base["indices"])
        if k < min(refresh, steps):
            fail(f"{what}: one device's draws for {k} steps, before the "
                 f"first refresh after step {refresh - 1}")
        err = {f: rel_err(r0["metrics"][f][:k], base["metrics"][f][:k])
               for f in ("loss", "grad_norm")}
        if max(err.values()) > tol:
            fail(f"{what}: losses and grad norms {err} from one device's "
                 f"over {k} steps; bound {tol}")
        store = [torch.cat([r0["store"][i], r1["store"][i]])
                 for i in range(len(r0["store"]))]
        scored = _scored_rel({"store": store}, base)
        res = {"same_draws_steps": k, "steps": steps, "rel_err": err,
               "scored_rel_err": scored,
               "master_rows": [runs[r][0]["master_rows"][0]
                               for r in range(2)],
               "ranks": [_mp_rank_summary(x[0]) for x in runs],
               "one_device": _mp_rank_summary(base),
               "param_leaves": r0["param_leaves"],
               "param_elements": r0["param_elements"]}
        if job.get("moe"):
            layers = job["cfg"].num_layers
            drop = _median_share(r0["dropped"][:k * layers],
                                 base["dropped"][:k * layers], tol)
            res["dropped"] = {"split": r0["dropped"].tolist(),
                              "one_device": base["dropped"].tolist(),
                              **drop}
            if drop["median"] > tol or drop["share_over"] > MP_MOE_SHARE \
                    or not bool((base["dropped"] > 0).any()):
                fail(f"{what}: dropped shares {res['dropped']} (one device "
                     f"must drop some)")
            bad = scored["median"] > tol or scored["share_over"] > \
                MP_MOE_SHARE
        else:
            bad = scored["max"] > tol
        if bad:
            fail(f"{what}: the scored rows' ω̃ from one device's: {scored}")
        if job.get("keep_params") and k == steps:
            res["params_rel_err"] = max(
                rel_err(a.float(), b.float()) for a, b in zip(
                    tree_leaves(r0["params"]), tree_leaves(base["params"])))
            if res["params_rel_err"] > tol:
                fail(f"{what}: final params {res['params_rel_err']:.2e} "
                     f"from one device's")
        out[tag] = res
        print(f"{what}: world 2 on one card (gloo), each rank's master at "
              f"{res['master_rows']} of {batch} rows; one device's draws for {k} of {steps} steps, loss and "
              f"grad norm within {err}, ω̃ {scored}"
              f"{'; dropped ' + str(res['dropped']) if 'dropped' in res else ''}"
              f"; two split runs bitwise equal, the ranks alike; a rank a "
              f"step: {res['ranks'][0]}", flush=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"batch split: phase 48 {out['wall_s']:.1f} s ({wall:.1f} s the "
          f"world with its spawn; this process held "
          f"{held['allocated_gib']:.2f} GiB allocated, "
          f"{held['reserved_gib']:.2f} reserved at the spawn)", flush=True)
    return out


def _argv_last(argv, flag) -> int:
    """The int value of ``flag``'s last occurrence (argparse's)."""
    return int(argv[max(i for i, a in enumerate(argv) if a == flag) + 1])


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.kernels import per_example_sqnorm as pes
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    train_mod.use_full_f32()
    build_s = phase_build(_build, card)
    lib = pes._lib()
    if lib.pes_threads() != ref.SQNORM_THREADS:
        fail(f"kernel block size {lib.pes_threads()} != emulator's "
             f"{ref.SQNORM_THREADS}")
    gn._lib()
    if fa._lib().fa_max_rep() != fa.MAX_REP or \
            da._lib().da_slots() != da.SLOTS or \
            da._lib().da_max_rep() != da.MAX_REP or \
            fab._lib().fab_max_rep() != fab.MAX_REP or \
            fab._lib().fab_sweep16_chunk() != ref.SWEEP16_CHUNK:
        fail("the attention wrappers' constants differ from their builds'")
    if [n for n in range(1, 33) if ss._lib().ss_supports(n)] != \
            list(ss.STATE_SIZES):
        fail("the scan wrapper's d_state sizes differ from its build's")
    if {n: ss._lib().ss_lanes(n) for n in ss.STATE_SIZES} != ss.LANES:
        fail(f"the scan wrapper's lanes {ss.LANES} differ from its build's")

    max_err = phase_kernels(pes, ref)
    max_err["ghost_norm"] = phase_ghost_kernels(gn, ref)
    max_err.update(phase_attn_kernels(fa, da, ref))
    counts_after_check = read_counts()
    launches, step_ms, peak_gib = phase_main(train_mod, pes, gn, ref)
    errs = phase_parity()
    rows = phase_times(pes, ref)
    prof = phase_profile(train_mod, ["--examples", "65536",
                                     "--device", "cuda"])
    lm_launches, lm_step_ms, lm_peak, lm_hist = phase_lm_main(
        train_mod, pes, gn, ref)
    lm_errs = phase_lm_parity()
    ghost_rows, ghost_steps, ghost_card = phase_ghost_times(gn, ref)
    lm_prof = phase_profile(train_mod, LM_ARGV, lm_config(), steps=3,
                            warm=2, tag="lm profile")
    serve_result, serve = phase_serve_main(serve_mod, ref)
    serve["graph_vs_eager"] = phase_serve_graph_equal(serve_result)
    serve_prof = phase_serve_profile(serve_result)
    serve_params = serve_result.params
    del serve_result
    batcher = phase_batcher(serve_params, ref)
    del serve_params
    torch.cuda.empty_cache()
    serve_errs = phase_serve_parity()
    serve_rows = phase_serve_times(fa, da, ref)
    max_err.update(phase_flash_bwd_kernels(fa, fab, ops, ref))
    flash = phase_flash_main(train_mod, ref)
    flash_errs = phase_flash_parity()
    flash_rows, flash_prof = phase_flash_times(train_mod, fa, fab, ref)
    max_err["selective_scan"] = phase_scan_kernels(ss, ops, ref)
    mamba = phase_mamba_main(train_mod, ref)
    mamba_errs = phase_mamba_parity()
    scan_row, mamba_prof = phase_mamba_times(train_mod, ss, ref)
    fused = phase_fused(train_mod, ref)
    rev = phase_ghost_rev(train_mod, ref)
    ckpt = phase_checkpoint(train_mod)
    asgd_res = phase_asgd(ref)
    tel = phase_telemetry(train_mod, ref)
    strat = phase_strategies(train_mod, ref, lm_step_ms)
    big = phase_large_tables(train_mod, ref)
    mini = phase_minicpm3(train_mod, ops, gn, ref)
    dbrx = phase_dbrx(train_mod, fa, fab, ref)
    jamba = phase_jamba(train_mod, ref)
    music = phase_musicgen(train_mod, ref)
    serve_falcon = phase_serve_falcon(serve_mod, ref)
    serve_jamba = phase_serve_jamba(serve_mod, ref)
    serve_mini = phase_serve_minicpm3(serve_mod, ref)
    serve_music = phase_serve_musicgen(serve_mod, ref)
    serve_zoo_errs = phase_serve_zoo_parity()
    async_res = phase_async(train_mod, ref)
    stream_res = phase_streaming(train_mod, ref)
    loop_res = phase_serve_loop(train_mod, ref)
    planes_errs = phase_planes_parity()
    sharded = phase_sharded(train_mod, ref)
    planes = phase_sharded_planes(train_mod, ref)
    model_par = phase_model_parallel(train_mod, ref)
    serving_groups = phase_serving_groups(train_mod, ref)
    dry_card = phase_dryrun_card()
    remat_res = phase_remat(train_mod, ref, dry_card)
    split_res = phase_batch_split(train_mod, ref)

    print("times " + json.dumps({
        "card": card, "build_s": build_s, "step_ms_median": step_ms,
        "steps": MAIN_STEPS, "warmup_steps": WARMUP_STEPS,
        "peak_mem_gib": peak_gib,
        "kernel_ms": rows, "library_ms": None,
        "library_note": "no single PyTorch call computes Σ‖x‖²‖d‖²",
        "card_vs_cpu_rel_err": errs, "profile": prof}), flush=True)
    print("lm times " + json.dumps({
        "card": card, "arch": "glm4-9b", "layers": LM_LAYERS,
        "argv": LM_ARGV, "steps": LM_STEPS, "warmup_steps": LM_WARMUP,
        "step_ms_median": lm_step_ms, "peak_mem_gib": lm_peak,
        "losses": [r["loss"] for r in lm_hist],
        "ghost_norm_ms": ghost_rows, "ghost_norm_per_step": ghost_steps,
        "ghost_norm_card_after": ghost_card,
        "library_ms": None,
        "library_note": "no single PyTorch call computes <XXᵀ, DDᵀ>; the "
                        "plain version is two cuBLAS bmm and a reduction",
        "card_vs_cpu_rel_err": lm_errs, "profile": lm_prof}), flush=True)
    print("serve times " + json.dumps({
        "card": card, "arch": "glm4-9b", "layers": serve_config().num_layers,
        "argv": SERVE_ARGV, **serve, "profile": serve_prof,
        "batcher": batcher, "card_vs_cpu_rel_err": serve_errs,
        "kernel_ms": serve_rows,
        "library_note": "scaled_dot_product_attention(is_causal / boolean "
                        "length mask, enable_gqa), timed only"}), flush=True)
    print("lm flash times " + json.dumps({
        "card": card, "arch": "glm4-9b", "layers": LM_LAYERS,
        "argv": FLASH_ARGV, "attn_impl": "flash", "attn_scores": "fused",
        "warmup_steps": FLASH_WARMUP, **flash, "kernel_ms": flash_rows,
        "card_vs_cpu_rel_err": flash_errs, "profile": flash_prof,
        "library_note": "torch.autograd.grad through one "
                        "scaled_dot_product_attention(is_causal, enable_gqa) "
                        "call, the backward only, timed only; no single "
                        "call computes the score sweep"}), flush=True)
    print("mamba times " + json.dumps({
        "card": card, "arch": "falcon-mamba-7b", "layers": MAMBA_LAYERS,
        "argv": MAMBA_ARGV, "warmup_steps": MAMBA_WARMUP, **mamba,
        "kernel_ms": {"selective_scan": scan_row},
        "card_vs_cpu_rel_err": mamba_errs, "profile": mamba_prof,
        "library_note": "no single PyTorch call computes the selective scan",
        }), flush=True)
    print("slice 11 times " + json.dumps({
        "card": card, "fused": fused, "ghost_rev": rev, "checkpoint": ckpt,
        "asgd": asgd_res, "wall_s": time.perf_counter() - t_start}),
        flush=True)
    print("slice 12 times " + json.dumps({
        "card": card, "telemetry": tel, "strategies": strat,
        "large_tables": big, "wall_s": time.perf_counter() - t_start}),
        flush=True)
    print("slice 13 times " + json.dumps({
        "card": card, "minicpm3": mini, "dbrx": dbrx, "jamba": jamba,
        "musicgen": music, "wall_s": time.perf_counter() - t_start}),
        flush=True)
    print("slice 14 times " + json.dumps({
        "card": card, "falcon_mamba": serve_falcon, "jamba": serve_jamba,
        "minicpm3": serve_mini, "musicgen": serve_music,
        "card_vs_cpu": serve_zoo_errs,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 15 times " + json.dumps({
        "card": card, "async": async_res, "streaming": stream_res,
        "serve_loop": loop_res, "card_vs_cpu": planes_errs,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 16 times " + json.dumps({
        "card": card, "sharded": sharded,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 17 times " + json.dumps({
        "card": card, "sharded_planes": planes,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 18 times " + json.dumps({
        "card": card, "model_parallel": model_par,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 19 times " + json.dumps({
        "card": card, "serving_groups": serving_groups,
        "dryrun_on_card": dry_card,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 20 times " + json.dumps({
        "card": card, "remat": remat_res,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    print("slice 21 times " + json.dumps({
        "card": card, "batch_split": split_res,
        "wall_s": time.perf_counter() - t_start}), flush=True)
    mp4 = model_par["a_mlp"]["1x4"]["ranks"][0]["launches_a_step"]
    main_counts = {"per_example_sqnorm_multi": launches,
                   "per_example_sqnorm": {"per_example_sqnorm": round(
                       mp4.get("per_example_sqnorm", 0) * MP_STEPS)},
                   "ghost_norm": lm_launches,
                   "flash_attention": serve["launches"],
                   "decode_attention": serve["launches"],
                   "flash_attention_bwd": flash["fused"]["launches"],
                   "attn_score_sweep": flash["separate"]["launches"],
                   "selective_scan": mamba["logit_grad"]["launches"]}
    timing = dict(rows)
    # ghost_norm: the work of one seq-64 LM step, its 8 calls; beside it
    # the flash-trainer and falcon-mamba ghost steps
    timing["ghost_norm"] = {
        k: ghost_steps["lm"][k]
        for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    timing["ghost_norm"]["steps"] = {
        step: {k: t[k] for k in ("calls", "ms", "plain_ms", "bound_ms",
                                 "bound_by")}
        for step, t in ghost_steps.items()}
    timing["flash_attention"] = serve_rows["flash_attention"]
    timing["decode_attention"] = serve_rows["decode_attention main"]
    timing["flash_attention_bwd"] = flash_rows["flash_attention_bwd"]
    timing["attn_score_sweep"] = flash_rows["attn_score_sweep"]
    timing["selective_scan"] = scan_row
    timed = {
        "per_example_sqnorm_multi": "one call at the MLP main-path shapes",
        "per_example_sqnorm": "one call at (256, 3072 | 2048); 'shapes' "
                              "gives the replicated fc4 tap of a "
                              "--model-parallel 4 step (256, 2048 | 10), "
                              "its launch on the main path: 1 a step a "
                              "rank, launches counted on rank 0 of phase "
                              "44's (1, 4) world over 20 steps",
        "ghost_norm": "the 8 calls of one seq-64 LM step; 'steps' gives "
                      "the 5 of a flash-trainer step and the 4 of a "
                      "falcon-mamba ghost step",
        "flash_attention": "one prefill call (B=8, S=2048, 32/2 heads, hd "
                           "128, bf16); 40 a prefill",
        "decode_attention": "one decode call at the last step's cache (B=8, "
                            "2112 slots, 32/2 heads, hd 128, bf16), device "
                            "time (profiler; 'serve times' gives the eager "
                            "loop's wall time and the 32k cache); 40 a "
                            "token step",
        "flash_attention_bwd": "one call without scores (B=16, S=512, 32/2 "
                               "heads, hd 128, bf16); 8 a step of the LM "
                               "flash trainer, 4 of them with scores",
        "attn_score_sweep": "one call at the same shape, device time "
                            "(profiler; 'lm flash times' gives the CUDA "
                            "events' time); 4 a step of the LM flash "
                            "trainer with attn_scores='separate', 0 with "
                            "'fused'",
        "selective_scan": "one call at the full-depth scoring pass's shape "
                          "(B=8, S=2048, d_inner 8192, d_state 16, bf16); "
                          f"{MAMBA_LAYERS} a step of the falcon-mamba trainer "
                          f"({MAMBA_LAYERS} layers, ssm_mode='pallas'), 64 a "
                          "full-depth scoring pass; 'shapes' gives the "
                          "trainer's (B=16, S=256) call beside it"}
    kernels = []
    for name in SOURCES:
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main_counts[name][name],
            "max_abs_err": max_err[name], "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"],
            "bound_by": timing[name]["bound_by"],
            "library_ms": timing[name].get("library_ms"),
            "tflop_s": timing[name].get("tflop_s"),
            "on_main_path": name != "attn_score_sweep",
            "timed": timed[name],
            "phases": {"kernels": counts_after_check[name],
                       "main_mlp": launches[name],
                       "main_lm": lm_launches[name],
                       "main_serve": serve["launches"][name],
                       "batcher": batcher["launches"][name],
                       "main_lm_flash": flash["fused"]["launches"][name],
                       "lm_flash_separate":
                           flash["separate"]["launches"][name],
                       "main_mamba": mamba["logit_grad"]["launches"][name],
                       "mamba_ghost": mamba["ghost"]["launches"][name],
                       "mamba_full_depth":
                           mamba["full_depth"]["launches"][name],
                       "fused_mlp": fused["launches"][name],
                       "ghost_rev_cut_fused":
                           rev["cut"]["fused"]["ghost_rev"]["launches"][name],
                       "ghost_rev_cut_separate":
                           rev["cut"]["separate"]["ghost_rev"]["launches"][
                               name],
                       "ghost_rev_full_depth":
                           rev["full_depth"]["launches"][name],
                       "ghost_rev_trainer":
                           rev["trainer"]["launches"][name],
                       "telemetry_mlp": tel["launches"][name],
                       "adaptive_mlp":
                           strat["adaptive"]["launches"][name],
                       **{f"zoo_{k}_pass": v["launches_a_pass"][name]
                          for k, v in strat["zoo"].items()},
                       "lm_upper_bound":
                           strat["lm_upper_bound"]["launches"][name],
                       "int8_tree_trainer":
                           big["trainer"]["launches"][name],
                       "minicpm3_trainer":
                           mini["trainer"]["launches"][name],
                       "minicpm3_cut_ghost":
                           mini["cut"]["ghost"]["launches"][name],
                       "minicpm3_cut_ghost_rev":
                           mini["cut"]["ghost_rev"]["launches"][name],
                       "dbrx_trainer": dbrx["trainer"]["launches"][name],
                       "jamba_logit_grad":
                           jamba["logit_grad"]["launches"][name],
                       "jamba_ghost": jamba["ghost"]["launches"][name],
                       **{f"musicgen_{k}_pass":
                          music[k]["launches"].get(name, 0)
                          for k in ("logit_grad", "ghost", "ghost_rev")},
                       "musicgen_trainer":
                           music["trainer"]["launches"][name],
                       "serve_falcon_mamba":
                           serve_falcon["launches"][name],
                       "batcher_falcon_mamba":
                           serve_falcon["batcher"]["launches"][name],
                       "serve_jamba": serve_jamba["launches"][name],
                       "serve_minicpm3": serve_mini["launches"][name],
                       "serve_musicgen": serve_music["launches"][name],
                       "async_mlp_k1": async_res["k1"]["launches"][name],
                       "async_mlp_k4": async_res["k4"]["launches"][name],
                       **{f"stream_{w}_{c}":
                          stream_res[c][w]["launches"][name]
                          for c in ("sync", "async")
                          for w in ("resident", "streamed")},
                       "serve_loop_glm4":
                           loop_res["serve"]["launches"][name],
                       "serve_loop_glm4_no_serve":
                           loop_res["no_serve"]["launches"][name],
                       **{f"sharded_{m}_{w}":
                          sharded[f"{m}_world1"][key][name]
                          for m in ("mlp", "lm")
                          for w, key in (("none", "launches_none"),
                                         ("world1", "launches"))},
                       **{f"sharded_mlp_world2_rank{r}":
                          sharded["mlp_world2"]["launches"][r][name]
                          for r in range(2)},
                       **{f"planes_mlp_{c}_{w}":
                          planes[f"a_{c}"][w]["launches"][name]
                          for c in ("sync", "async")
                          for w in ("one_device", "world1")},
                       **{f"planes_mlp_world2_rank{r}":
                          planes["b_world2"]["ranks"][r]["launches"][name]
                          for r in range(2)},
                       "planes_mlp_resume": planes["c_resume"]["launches"][
                           name],
                       **{f"planes_lm_{w}": planes["d_lm"][w]["launches"][
                           name] for w in ("one_device", "world1")},
                       "lm_row_blocks_one_device":
                           planes["lm_row_blocks"]["one_device"]["launches"][
                               name],
                       **{f"lm_row_blocks_world2_rank{r}":
                          planes["lm_row_blocks"]["ranks"][r]["launches"][
                              name] for r in range(2)},
                       **{f"model_parallel_{w}_rank0_a_step":
                          model_par["a_mlp"][w]["ranks"][0][
                              "launches_a_step"].get(name, 0)
                          for w in ("1x4", "1x2", "2x2")},
                       **{f"model_parallel_{t}_rank0_a_step":
                          model_par[t]["ranks"][0]["launches_a_step"].get(
                              name, 0)
                          for t in ("glm4_sp", "glm4_no_sp", "flash",
                                    "falcon_mamba", "dbrx", "minicpm3",
                                    "jamba")},
                       **{f"serving_groups_glm4_{w}_rank0":
                          serving_groups["a_glm4"][w]["launches_rank0"][name]
                          for w in ("1x2", "2x2")},
                       "serving_groups_loop_mesh1_nccl":
                           serving_groups["b_loop"]["mesh1_nccl"][
                               "launches_with_tick"][name],
                       "serving_groups_loop_mp2_rank0":
                           serving_groups["b_loop"]["mesh1_mp2_gloo_rank0"][
                               "launches_with_tick"][name],
                       **{f"serving_groups_{z}_rank0":
                          serving_groups["d_zoo"][z]["launches_rank0"][name]
                          for z in serving_groups["d_zoo"]},
                       **{f"remat_{t}_{w}": remat_res["a"][t][w][
                           "launches"][name]
                          for t in remat_res["a"] for w in ("off", "on")},
                       **{f"remat_{t}": remat_res["b"][t]["launches"][name]
                          for t in remat_res["b"]},
                       **{f"batch_split_{t}_rank{r}_a_step":
                          split_res[t]["ranks"][r]["launches_a_step"].get(
                              name, 0)
                          for t in ("mlp", "glm4_flash", "dbrx")
                          for r in range(2)}},
        })
        if name in ("per_example_sqnorm_multi", "ghost_norm"):
            kernels[-1]["side_stream_launches"] = {
                "async_mlp_k1": async_res["k1"]["side_launches"][name],
                "async_mlp_k4": async_res["k4"]["side_launches"][name],
                "stream_streamed_async":
                    stream_res["async"]["streamed"]["side_launches"][name],
                "serve_loop_glm4":
                    loop_res["serve"]["side_launches"][name],
                "planes_mlp_async_world1":
                    planes["a_async"]["world1"]["side_launches"][name],
                **{f"planes_mlp_world2_rank{r}":
                   planes["b_world2"]["ranks"][r]["side_launches"][name]
                   for r in range(2)},
                "planes_lm_world1":
                    planes["d_lm"]["world1"]["side_launches"][name]}
        if "steps" in timing[name]:
            kernels[-1]["steps"] = timing[name]["steps"]
        if "shapes" in timing[name]:
            kernels[-1]["shapes"] = {
                tag: {k: r[k] for k in ("shape", "lanes", "ms", "plain_ms",
                                        "bound_ms", "bound_by") if k in r}
                for tag, r in timing[name]["shapes"].items()}
    print(card, flush=True)   # as nvidia-smi gives it: name, power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
