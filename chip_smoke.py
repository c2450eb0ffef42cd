#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports nothing of JAX or of the JAX package.

Phases (any failure raises; the script then exits non-zero and prints no
result line). Every Executor.run, run_bundle, StepHandle.step,
Predictor.run and serving dispatch on the card runs the step artifact of
fluid/step_artifact.py: a signature's first call is its eager warm-up, the
second captures it into a CUDA graph, later calls replay it; so phases 3-7
check the captured paths, and their launch counts are counted under
replay (each graph adds the launches its capture recorded).
  1. build    — compile every hand-written kernel of the port from the
                sources in the checkout (one nvcc per source, all started
                together); print the build time, ptxas' resource lines and
                the card's name and power limit; fail if ptxas reports a
                spill in the flash-attention kernels (forward or
                backward) or in the paged attention, or if the SASS of a
                bf16 attention kernel, the forward or the backward pair
                (cuobjdump -sass), lacks HGMMA or holds HMMA, an atomic
                or a 16-bit shared load.
  2. kernels  — each kernel's wrapper against its plain torch version on
                the card, at the shapes the main paths give it (batch 16:
                the training batch and serving's largest bucket), within a
                stated tolerance; time kernel, plain version and the
                PyTorch library call computing the same function (for the
                two backward kernels, which no library call computes one
                at a time: the pair against SDPA's backward). The
                flash-attention kernels run their products on the tensor
                cores in 3xTF32: their bound counts FLOPs at 495 / 3
                TFLOP/s (`ops_rate`), the forward and the backward pair
                are each launched twice and the two results must be
                bitwise equal, and they, their plain versions and SDPA
                (forward, and backward through autograd) are timed by CUDA
                graph replay, the wrapper's eager time beside as eager_ms;
                the SDPA kernels torch.profiler shows are named
                (library_kernels). Their bf16 variants (q, k, v, dO and
                the outputs bf16; AMP's path) in the same four cases, the
                same draws rounded to bf16: O, dQ, dK and dV within
                BF16_ULPS bf16 ulps of the tensor's largest magnitude
                (lse within 1e-4), two launches bitwise equal, timed the
                same way beside SDPA's forward and backward on the same
                bf16 operands; their bound counts the FLOPs at the dense
                bf16 rate (989 TFLOP/s) and the bytes at bf16 widths. The
                sparse
                Adam and Adagrad kernels on DeepFM's [100000, D] tables in
                four merges: the first reader batch's 6,656 ids at D=10
                and D=1, duplicate-heavy ids from 0..63, and all slots
                invalid (bitwise the input); no library call computes a
                merged-row lazy update, so their library_ms is null.
                Their ms and plain_ms are device times from CUDA graph
                replays (the wrapper's Python per call is longer than the
                kernel); eager_ms is the time per call through the
                wrapper. Those four hold the merged form, the TPU kernel's
                contract. The rows form, which the sparse rules call (the
                ids' int32 sort, then one launch that sums each id's rows
                in sorted order and updates the tables), in five id
                vectors of 6,656: the reader's at D=10 and D=1, ids from
                0..63, skewed (one id 256 times, four 64 times) and a
                single id; two launches bitwise equal; ms is the route
                (sort and kernel), kernel_ms the kernel alone, beside the
                parent's route (_merge_sparse and the merged form,
                parent_route_ms), the sorts alone and each route's device
                kernels. The paged decode
                attention in seven cases: the decode path's shape (16
                slots, beam 3, page_size 16, 2 pages a slot, src_cap 32,
                D 1024), src_cap 29, a fully masked slot, beam 1 over 64
                slots, the test decoder's D 6, long sources (16 pages
                a slot, src_cap 250: four chunks) and the speculative
                step's beam 1 over 16 slots; two launches must be
                bitwise equal; its library_ms is SDPA over rows gathered
                beforehand (the gather not timed).
  3. serving  — full-width Transformer-base (6+6 layers, d_model 512, 8
                heads, d_inner 2048, vocab 10000, max_length 256) built
                with the port's layers, initialized on the card from a seed,
                saved with save_inference_model, loaded by Predictor (the
                default place: the card) behind a ServingEngine that answers
                concurrent requests (its warmup runs each bucket twice:
                the warm-up and the capture of its graph). Every answer
                is checked against Predictor.run on the same rows, one
                against the same artifact run on the CPU, and the kernel
                launch counts against what the path must launch.
  4. training — full-width Transformer-base from models.transformer.
                get_model (noam_decay, Adam) at batch 16, max_length 256,
                trained TRAIN_STEPS steps through Executor(CUDAPlace(0)) on
                its wmt16 reader: finite losses that fall, 18 launches per
                step of each attention kernel (forward, backward dQ,
                backward dK/dV), step-1 gradients on the card against the
                same step on the CPU, and the trained program's inference
                artifact answering a request through Predictor on the card.
  5. ctr_training — full-width DeepFM (26 fields, vocab 100,000,
                embed_dim 10, hidden [400, 400, 400]) with both FM tables
                is_sparse, auc and Adam(1e-3), trained CTR_STEPS steps at
                batch 256 through Executor() on synthetic_ctr_reader:
                finite losses, AUC in [0, 1], 2 sparse_adam launches per
                step; the same program from fresh weights on one batch
                repeated, whose loss must fall below 0.01; 3 steps on the
                card against 3 on the CPU; sparse against dense Adagrad
                on the card (2 sparse_adagrad launches per sparse step);
                the trained prob served through Predictor on the card.
                Phases 3-4 launch no sparse kernel.
  6. decode   — the paged DecodeEngine at the full width of the
                machine_translation decoder (E 512, encoder rows D 1024,
                H 512, vocab 30000, beam 3, max_len 50; random weights
                from the seed), DecodeConfig(slots=16, src_cap=32,
                page_size=16, pages=64): warmup, then 48 requests burst-
                submitted (sources of 4-29 rows, every third one of 4
                canonical sources so the prefix cache hits, limits 8-50).
                Checks: every result's shape; the same stream through the
                dense engine on the card (no kernel) gives equal tokens and
                scores within 1e-4 (1 + |s|); 4 requests through the paged
                engine on the CPU (the plain version) the same; one
                paged_attention launch per step dispatch, warmup's
                included; the history pool all free after the drain and
                prefix hits > 0. Then (a) machine_translation's
                generating program (seq_to_seq_net(is_generating=True) at
                get_model's widths, startup weights from the seed) on 16
                sources of the synthetic wmt14 reader (bucket 32): warm-up,
                capture, replays timed beside the eager walk (busy, idle,
                kernels a replay, graph pool); held against the same
                program on the CPU (4 sources) and LockstepDecoder on the
                card fed the encoder output (equal tokens, scores within
                1e-4 (1 + |s|)); no kernel launches. (b) The token-fed
                burst: 48 requests of source ids (every third one of 4
                canonical sources) through program_prefill over the
                program pruned at its encoder output (token_cap 32; each
                admission bucket's captured encoder and its graph pool)
                into the paged engine of DECODE_CONFIG: tokens/s, TTFT,
                prefill batches and their device ms, prefix hits; one
                paged_attention launch a dispatch; the requests of (a)'s
                sources at the default limit equal to (a). (c)
                Speculative decoding, DecodeConfig(beam_size=1, spec_k=4)
                paged, over the encoder-row burst with three drafts (the
                target, a draft of width 128, a random next-token table):
                tokens equal to the beam-1 paged engine on the card, the
                accept rate, tokens a dispatch and tokens/s; 2 (spec_k +
                1) paged_attention launches a dispatch with a weights
                draft, spec_k + 1 with the table. Phases 3-5 launch no
                paged_attention, and this phase none of the other
                kernels.
  7. image_training — the image and book configs through the entry
                points on the card. fit_a_line (get_model: fc 13 -> 1,
                SGD 0.01, batch 20) 10 epochs of the uci_housing reader
                through DataFeeder: the last epoch's mean loss below a
                tenth of the first's; its for_test clone through
                Predictor, card against CPU within 1e-5. MNIST LeNet
                (get_model: batch 128, Adam 1e-3) one epoch of 64 steps:
                finite losses, the for_test clone's accuracy on the test
                reader >= 0.9. ResNet-50 (get_model(data_set='imagenet',
                depth=50, batch_size=32): 1000 classes, 3x224x224, NCHW,
                Momentum(0.01, 0.9)) 20 steps on flowers batches read
                beforehand: finite losses, running stats moved; the median
                step over steps 2-20, images/s and peak memory; one batch
                repeated 30 steps from the startup weights ends below half
                its first loss; step 1 on the card against the CPU at
                batch 2 (the loss and every running stat within 1e-4, the
                median relative L2 of the gradients within 3x the CPU's
                own spread under a 1e-6 change of the input: the network
                is chaotic at its startup weights); one NHWC step's loss
                within 1e-4 of NCHW's;
                the trained for_test clone through Predictor and
                ServingEngine on the card against the CPU within 1e-4,
                its running stats bitwise unchanged by serving. The phase
                launches none of the port's kernels (conv, pool and norm
                are cuDNN library calls).
  7b. amp     — AMP through the entry points, bf16 on the tensor cores.
                Transformer-base get_model (batch 16) under
                fluid.amp.decorate_program, TRAIN_STEPS steps on its wmt16
                reader: finite losses that fall, 18 launches per step of
                each bf16 attention kernel and none of an fp32 one; its
                losses against the same program in fp32 on the card from
                the same weights (the JAX tests/test_amp.py bound); step 1
                card against CPU (AMP on both: the loss, and each
                gradient against the difference AMP itself makes on the
                CPU). ResNet-50 as the JAX bench.py:215-253 builds it for
                AMP (a bfloat16 data var fed bf16 flowers batches from the
                DataFeeder, resnet_imagenet(depth=50), Momentum(0.01,
                0.9)), NHWC (channels_last memory on the card) and NCHW,
                RESNET_STEPS steps each: finite losses, images/s, peak
                memory, one batch repeated falling below half, NHWC's
                step 1 against NCHW's. Transformer-base's inference
                artifact transpiled by fluid.contrib.Float16Transpiler in
                its Predictor's scope behind a ServingEngine (max batch
                16): fp32 answers against Predictor.run and against the
                CPU, 18 bf16 forward launches per forward and no fp32 one.
  7c. dense_training — the dense training surface. VGG-16
                (vgg.get_model(): cifar10 3x32x32, batch 32, Adam 1e-3,
                vgg16_bn_drop's dropouts) and SE-ResNeXt-50
                (se_resnext.get_model(): flowers 3x224x224, batch 16,
                102 classes, cardinality 32, Momentum(0.01, 0.9)), each
                DENSE_STEPS captured steps through Executor() on batches
                read beforehand: finite losses, one capture, the median
                replayed step, images/s, peak memory, device busy and
                idle share and the top device kernels (torch.profiler
                over 3 replays); the loss falling (VGG over its first 60
                reader steps, SE-ResNeXt on its first batch repeated 30
                steps); step 1 on the card against the CPU at batch 2 on
                the dropout-free program (loss and running stats within
                1e-4, the gradients within 3x the CPU's own spread).
                MNIST LeNet captured 5 steps under Adamax,
                DecayedAdagrad, Adadelta, RMSProp (momentum 0.9), Ftrl
                (l1, l2 > 0) and Momentum with LARS_weight_decay (its
                append_LARS rates fetched), each with one of the five
                decays and GradientClipByNorm on every parameter, against
                the CPU's eager steps from one state: every fetch and
                persistable within SURFACE_TOL (relative L2).
                ModelAverage on that path (captured, cudnn.deterministic):
                apply() gives the steps' mean in the scope's own tensors,
                restore() the trained weights bitwise, and the next
                replay is bitwise a twin's that never averaged.
                nets.scaled_dot_product_attention (B 16, T 256, 8 heads,
                D 64): one flash_attention op, its forward and 3 SGD
                steps against the CPU, and its launches (one forward a
                forward, one of each backward kernel a step), the
                nets_attention path of the kernels line. VGG, SE-ResNeXt
                and the optimizer surface launch no kernel of the port.
  7d. sequences — the LoD sequence models at full width through the
                entry points: stacked_dynamic_lstm (batch 32, emb and lstm
                512, vocab 5147, Adam), understand_sentiment (batch 32,
                emb and hid 32, Adagrad 0.002) and machine_translation's
                training program (batch 16, emb, encoder and decoder 512,
                dict 30000, Adam 2e-4), each SEQ_STEPS captured steps
                through Executor() on reader batches read beforehand
                through DataFeeder (the time axis bucketed to a power of
                two): finite losses; one capture per bucket seen twice or
                more (each bucket's graph pool logged); the median replayed
                step, sequences/s, valid tokens/s and peak memory; one
                batch's replay against debug_step's eager walk with device
                busy time, idle share and device kernels a step
                (torch.profiler over 3 replays) and the top device
                kernels; a replay on another batch of that bucket (other
                lengths) held to two eager walks from the same state, the
                loss and the written persistables bitwise or within twice
                the walks' spread, as in phase 8; the loss falling on
                the first batch repeated SEQ_LEARN_STEPS steps; step 1
                card against CPU at SEQ_CPU_BATCH sequences (the loss
                within 1e-4, the gradients within 3x the CPU's own
                spread under startup weights nudged by 1e-6); the two
                classifiers' for_test clones through Predictor with
                LoDTensor feeds, card against CPU within 1e-5. No kernel
                of the port launches on these paths.
  7e. book_models — the last three book models through the same
                checks and records (dense feeds: one signature, the
                replay held on another batch): word2vec (get_model: dict
                2073, embed 32, hidden 256, batch 64, SGD 1e-3),
                recommender_system (get_model: emb 32, towers 200, batch
                256, SGD 0.2) and label_semantic_roles at BOOK_SRL
                (hidden 512, depth 8, batch 10; SGD under the book's
                staircase exponential decay; the pretrained emb loaded
                on the card through scope.find_var().get_tensor().set()).
                word2vec's probabilities and the recommender's scores
                through Predictor, card against CPU within 1e-5; SRL's
                decode as BOOK_TIE_FACTOR's note says. The phase's
                seconds are logged. No kernel of the port launches.
  7f. control_flow — machine_translation's widths through the public
                control-flow API: (a) the contrib TrainingDecoder seq2seq
                (DynamicRNN) trained 20 captured steps through 7d's
                checks and records; (b) the contrib BeamSearchDecoder on
                (a)'s weights and (c) the book's While-loop LoD beam
                decoder on random weights, each on 16 wmt14 sources at
                beam 3: one capture, the replay bitwise the eager walk,
                ids (and (c)'s 2-level LoD) equal to the CPU's, scores
                within 1e-5 of max(1, |score|); each while's bound
                against its live iterations at exit, replay and eager
                ms, busy, idle, kernels a replay, graph pool,
                sentences/s. No kernel of the port launches.
  7g. trainer — the high-level Trainer on the card (TRAINER_* below).
                (a) Transformer-base at get_model's widths (batch 16,
                max_length 256; train_func models.transformer.transformer
                returning [avg_cost, token_count], optimizer_func
                get_model's Adam over the scaled noam_decay) through
                fluid.Trainer(place=CUDAPlace(0), double_buffer=True,
                CheckpointConfig(step_interval=6)) for 12 steps of the
                wmt16 reader (paddle.batch, pad_batch): finite losses that
                fall, 18 launches a step of each fp32 attention kernel
                (the main path of the phase: its counts go into the
                kernels line as the `trainer` path), periodic saves at
                steps 0 and 6 and none left after train(), one capture;
                the median replayed step (`trainer.step` spans), target
                tokens/s, the median `trainer.input_stage` wait a step,
                each serial's bytes and save seconds. (b) A SIGTERM sent
                from BeginStepEvent 4: train() returns preempted, its
                handler restored, an emergency serial whose meta says
                preempted: true; a fresh Trainer over the dir loads it
                (seconds) with every persistable bitwise the state at
                preemption (Adam moments, @LR_DECAY_COUNTER@) and resumes
                at step 5; its next periodic serial (step 6) passes the
                size and CRC32 gate. (c) The newest serial torn by one
                flipped byte: the next Trainer warns and resumes from the
                serial before, its state bitwise that serial. (d)
                bundle_steps=4 and (e) sync='async', async_window=2 from
                (a)'s start weights over (a)'s first 8 batches: losses
                against (a)'s within 1e-6 relative (bitwise or not is
                printed); the bundled loop's periodic gate saves at steps
                3 and 7. (f) test() on 2 test batches; save_params; an
                Inferencer on the card against the same Inferencer on the
                CPU (2 rows, logits within 1e-4 of max(1, |logit|)). (g)
                The conv MNIST net of tests/test_book_high_level_api.py at
                batch 128, Adam 1e-3, one epoch with double_buffer off
                and on: steps/s and the median input-stage wait (a
                finding, not a check). One JSON line {"trainer": {...}}.
  7h. stream  — online training with live serving freshness (STREAM_* below).
                (a) Full-width DeepFM (both FM tables is_sparse, Adam 1e-3,
                batch 256) through fluid.Trainer(double_buffer=True).
                train_stream over the JAX bench's drifting Zipf(1.5)
                stream, a VocabTable(100000, table='fm_embed',
                admit_count=2) preloaded full, a DeltaPublisher every 5
                steps into two ServingEngine replicas (buckets 1-16, the
                scorer saved from the startup state) behind a Router, and
                a client thread of 1-8-row requests and a 16-row probe
                through Router.predict: steps/s, rows admitted and evicted
                a step, rows a push, push ms, the freshness lag, the
                trainer.step median, the host split of a step, 2
                sparse_adam launches a step (the main path of the phase:
                the `stream` path of the kernels line) and one capture
                before and after the stream. (b) Each evicted row zero in
                fm_embed and both Adam moments after its boundary; every
                probe answer bitwise one of the answers at the push
                boundaries; after a final publish the replicas' answer
                against a Predictor of the scorer given the trainer's FM
                tables within 1e-6 of max(1, |score|); an identity vocab
                bitwise Trainer.train over 8 batches. (c) A SIGTERM at a
                boundary: the emergency serial holds streaming_vocab, and a
                fresh Trainer resumes the same map and every persistable
                bitwise. One JSON line {"stream": {...}}.
  7i. serving_stream — token streaming and the compiled serving artifact
                (TOKEN_* and COMPILED_* below). (a) Phase 6's paged
                DecodeEngine (its weights and DECODE_CONFIG) behind a
                Router: its 48 requests through Router.predict from 8
                client threads, then the same burst as Router.stream calls
                (the main path of the phase's decode half: the
                `token_stream` path of the kernels line): each stream's t
                1..n once each and in order, its result equal to
                Router.predict's (scores within DECODE_SCORE_TOL, bitwise
                or not printed); streamed and unstreamed tokens/s, client
                TTFT and inter-token gap p50/p99, one host copy a dispatch
                (stats['host_syncs']) and one paged_attention launch a
                dispatch. (b) The burst again with 8 streams cancelled
                after 3 tokens: cancelled 8, the history pages free and
                the encoder pages free or evictable as before, the other
                results unchanged. (c) 8 streams checkpointed every 4
                tokens on engine A and moved at their second checkpoint to
                engine B (same weights) behind the same TokenStream, as
                the JAX pod's failover does it: every t delivered once,
                the results equal to (a)'s, B's captures unchanged. (d)
                push_rows of 64 target-embedding rows: a probe equal to a
                fresh engine given the rows, no capture. (e) Transformer-
                base at batch 16 exported on the card with
                inference.export_compiled, fp32 and its Float16Transpiler
                program in bf16, each loaded with load_compiled in a fresh
                process that imports only paddle_tpu_torch and in this
                one (the `compiled` and `amp_compiled` paths: 18 flash
                forward launches a call of their dtype's kernel): logits
                against Predictor.run within COMPILED_TOL of max(1,
                |logit|) (fp32) and AMP_CROSS_DEVICE_TOL (bf16, relative
                L2); export and load seconds, bytes on disk, the replayed
                call beside Predictor.run; then Router.swap('tfm', path)
                with no builder from a Predictor generation to an artifact
                of a second seed under a client of 16-row requests: no
                future lost or failed, answers of generation 1 then 2. One
                JSON line {"serving_stream": {...}}.
  7j. tier    — tiered embedding storage and the run-log report (TIER_*
                below). (a) 7h's DeepFM through fluid.Trainer(double_buffer
                =True).train_stream over the JAX bench_tiered stream
                (Zipf(1.3) around a base moving 13 ids a step, 800,000 ids:
                8x the table), a TieredVocabTable(VocabTable(100000,
                table='fm_embed', admit_count=2), host_arena(dir,
                slots=800000)) preloaded full, a DeltaPublisher every 5
                steps into two replicas behind a Router; 300 timed steps
                (the main path of the phase: the `tier` path of the kernels
                line), then the same with a plain VocabTable: steps/s of
                each, hit rate, spilled, restored and dropped_full,
                restore and spill ms p50/p99, host waits a spilling
                boundary (one), the boundary's share of the wall and its
                host split, 2 sparse_adam launches a step, one capture
                before and after, the arena file's bytes, the freshness
                lag. (b) The JAX tests/test_tiers.py:513 drill at chip
                size (one Constant(0) table, 26 fields, batch 256, Adam
                1e-2, double_buffer off, 60 steps over 131,072 ids): the
                tiered leg at capacity 16,384 bitwise a reference that
                covers every id at every step, the plain leg diverging,
                spilled >= 3 and restored >= 1, no capture in any second
                half. (c) A SIGTERM at a boundary of (a)'s trainer: the
                emergency serial holds the vocab, the spill map and the
                pending ops; a fresh Trainer and host_arena over the same
                directory resume them (the manifest too) and every
                persistable bitwise, and 10 more steps are bitwise the
                uninterrupted run. (d) (c)'s run log through the port's
                obs.report (no malformed record, the streaming and tiers
                sections printed) and tools/slo_budgets.json graded over
                the process's registry (a violation fails). One JSON line
                {"tier": {...}}.
  7k. passes  — the pass pipeline and int8 weight quantization (PASSES_*
                below; PADDLE_TPU_OPT is set only inside this phase). (a)
                Transformer-base (phase 3's config and 8 requests) with
                passes.quant_pass.quantize_weights on its inference
                program, saved by save_inference_model (int8 weights and
                scales, no fp32 weight) beside the fp32 artifact of the
                same weights; the int8 Predictor on the card behind a
                ServingEngine: 18 flash_attention_fwd launches a forward,
                every answer within 0.05 of max |fp32| of the fp32
                Predictor's (the JAX tests/test_kernels.py:363-364 bound),
                one row against the int8 artifact on the CPU (phase 3's
                tolerance); artifact bytes, the batch-16 replay (int8 and
                fp32 in turns), kernel records a replay and each graph
                pool printed. (b) ResNet-50 at batch 32, NCHW (phase 7's
                get_model; its batch norms' running stats and affine drawn
                from the seed so the fold moves real numbers), served
                through Predictor before and after InferenceTranspiler:
                53 batch norms folded, the outputs within
                PASSES_FOLD_TOL, kernel records a replay and the replay
                before and after. (c) Transformer-base training at batch 16
                (get_model, dropout 0.1), 3 steps from one state at
                PADDLE_TPU_OPT off and default: losses and every
                persistable bitwise equal; under decorate_program the AMP
                pass's step (ctx.amp off, explicit casts) against runtime
                AMP's: each loss within one bf16 ulp; 18 launches a step of
                each attention kernel (the bf16 ones under the AMP pass,
                no fp32 one); the PassReports, kernel records a replay and
                the replay off against default. (d) no passes.error
                anywhere in the script (the passes.errors counter is 0 at
                its end). One JSON line {"passes": {...}}.
  7l. detection — the SSD family and the vision rules (SSD_*, RPN_*,
                VISION_TOL below). (a) MobileNet-SSD built from fluid.layers
                as PaddlePaddle/models' object_detection/mobilenet_ssd.py
                builds it (MobileNet-v1 at scale 1.0, 3x300x300, 21
                classes, multi_box_head over the 19, 10, 5, 3, 2 and 1
                maps: 2,278 priors), ssd_loss under RMSProp with L2Decay,
                SSD_STEPS captured steps at batch 32 (two time buckets of
                the LoD gt, each captured): the loss falls, step 1 card
                against CPU within 3x the CPU's spread under a 1e-6
                nudge; the replay, images/s, busy, idle, kernels a replay,
                graph pool, and ssd_loss's rule and its matching alone.
                The detection_output program saved and served through a
                captured Predictor at batch 8: every image's rows equal to
                the CPU rule's on the card's decoded boxes and scores
                (rows decided within 1e-5 of the NMS threshold printed and
                excused); replay, busy, kernels, and multiclass_nms and
                its suppression loop alone; detection_map over 4 served
                batches through fluid.metrics.DetectionMAP, card against
                CPU. (b) An RPN head on the 19x19 map (3,249 anchors,
                rpn_target_assign, sigmoid cross entropy and smooth_l1)
                RPN_STEPS captured steps at batch 16, step 1 card against
                CPU. (c) The 14 vision rules of nn_ops.py at vision sizes
                (conv2d_transpose 512->256 from 19x19 to 38x38, resize up
                and down, roi_pool of 128 ROIs, conv3d and pool3d on
                16^3 volumes), forward and VJP on the card under sync
                debug against the CPU rule. No kernel of the port runs.
                One JSON line {"detection": {...}}.
  7m. training_surface — the rest of the training surface (W2V_*,
                EXTRA_*, INIT_STD_TOL, RESIZE_* below). (a) word2vec's
                N-gram net at get_model's widths with layers.nce (10
                negatives) in place of its softmax, W2V_STEPS captured
                steps at batch 64 on imikolov.train: the loss falls, the
                negatives of replays 2 and 3 differ, a step's Cost equals
                the CPU's on its negatives and weights; (b) the same net
                with layers.hsigmoid: the loss falls, step 1 card against
                CPU within 3x the CPU's spread under a 1e-6 nudge; replay,
                samples/s, busy, idle, kernels a replay, graph pool. (c)
                The 25 extra_ops rules, nce and hierarchical_sigmoid, each
                one program captured through Executor() (generate_layer_fn
                where it fits), forward and VJP against the CPU, with
                device ms and records a replay; sampling_id by law, the
                proximal rules in place. (d) TruncatedNormal, MSRA,
                Bilinear and NumpyArrayInitializer in a startup program on
                the card, and a Bilinear depthwise conv2d_transpose. (e)
                bilinear_interp at output dims of 1. No kernel of the
                port runs. One JSON line {"training_surface": {...}}.
  7n. recordio — the recordio half of the data path (RIO_* below). The
                native host library (csrc/recordio.cpp, image_aug.cpp)
                built from the checkout by the host compiler. (a) 1,280 raw
                flowers samples (315 MB) written into 4 recordio shards;
                every record read back by the native prefetch scanner and
                by RecordIOReader bitwise the sample written; the
                scanners' MB/s (page cache warm). The chain open_files ->
                shuffle -> batch -> simple_transform_batch ->
                double_buffer(CUDAPlace) feeds ResNet-50 (flowers) 30
                captured steps fp32 NCHW and 30 of phase 7b's AMP NHWC
                tower (the batch cast to bf16 on the card at the feed):
                the first two batches Executor.run receives bitwise the
                plain path's (RecordIOReader, the same shuffle seed, the
                plain numpy transform), finite losses; images/s from the
                chain against the same captured step fed a batch already
                on the card, the input wait a step (median, p90), the
                transform's images/s at batch 32. (b) understand_sentiment
                (phase 7d's config) trained captured from 12 imdb batches
                written by fluid.recordio_writer and read by
                open_recordio_file -> double_buffer: the losses bitwise a
                second executor's fed the same batches through
                DataFeeder. (c) A Preprocessor block (cast, scale, the
                elementwise_sub of a mean parameter, transpose) on the card
                against the CPU within RIO_PREP_TOL. No kernel of the port
                runs. One JSON line {"recordio": {...}}.
  7o. parallel — data and expert parallelism on a one-rank NCCL group
                (parallel.init_distributed(), destroyed before the phase
                returns). (a) Transformer-base (phase 4's dropout-free
                program, batch 16) trained PARALLEL_STEPS captured steps
                from one state three ways: the plain Executor,
                ParallelExecutor(use_cuda=True) and set_mesh({'dp': 1});
                (b) with BuildStrategy.Reduce (ZeRO-3) and
                DistributeTranspiler(shard_parameters=True): each way's
                losses and every persistable within PARALLEL_TOL of the
                plain run (bitwise in practice); the ParallelExecutor
                replay traced (its NCCL kernels, at least one, and the
                attention kernels; 18 launches of each a step, the
                slice's main path `parallel`); the median replays. (c)
                The MoE encoder (MOE_ENCODER: Transformer-base's encoder,
                each FFN a moe_mlp of 8 experts, top 2) trained captured
                under set_mesh({'dp': 1}) (the mesh path, two one-rank
                all_to_alls a layer; path `moe_encoder`); step 1 mesh path
                against dense path on the card bitwise; card against CPU
                at MOE_CPU_BATCH rows within MOE_GRAD_SPREAD times the
                CPU's own spread (median and worst gradient logged,
                each layer's routes compared); at capacity factor
                MOE_OVERFLOW_CF the kept slots and routes equal to the
                CPU rule's. One JSON
                line {"parallel": {...}}.
  8. captured — each path's captured step against debug_step's eager
                walk in this call, at full width: Transformer-base
                training at batch 16 (get_model, dropout 0.1), fp32 and
                under AMP, the same step built by phase 7g's Trainer and
                replayed on its executor, DeepFM, a paged decode dispatch with 16 slots
                full, serving at batch 1 and 16 (fp32 and transpiled to
                bf16), LeNet, ResNet-50 at batch 32 (fp32 NCHW, and AMP
                with a bf16 feed in NHWC and NCHW). For each:
                the median step of the replay and of the eager walk
                (CAPTURED_STEPS_8 each, ending in the fetch on the host),
                device busy time, idle share and kernel records per step
                (torch.profiler over PROFILED_STEPS), peak memory
                allocated and memory reserved; one JSON line
                {"captured": [...]}. Checks: a replay against two eager
                walks from one state (fetches and written persistables:
                bitwise where the eager walks are bitwise equal, else
                within twice their difference; the image paths also in a
                capture under cudnn.deterministic, bitwise, whose median
                replay is timed beside the default one); captured run j
                against eager run j with dropout 0.1 (Transformer, fp32
                and AMP, 3 steps: losses and every persistable bitwise);
                run_bundle(K=4) against 4 run() calls (DeepFM, bitwise);
                a guarded LeNet
                step fed a NaN (every persistable bitwise unchanged,
                skipped_steps 1); launches per replay (18 of each
                attention kernel a training step, 18 forward launches a
                serving forward, the bf16 variants' under AMP, 2
                sparse_adam a DeepFM step, 1
                paged_attention a dispatch); a held device fetch unchanged
                by the next replay.
  9. a JSON line {"kernels": [...]} with each kernel's parity, launches,
     times and bound; then the card's name and power limit; then the last
     line {"ok": true, "device": {...}}.
"""
import concurrent.futures
import contextlib
import hashlib
import importlib
import importlib.util
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 2024
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, the fp32 rate outside the tensor cores (the paged and sparse
# kernels run fp32 FFMA), and the dense TF32 rate of the tensor cores. The
# flash-attention kernels (forward and backward) run their products in
# 3xTF32, three TF32 products per fp32 product, so their least time counts
# their FLOPs at PEAK_TF32_FLOPS / 3.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
# the dense bf16 rate of the tensor cores: the bound of the flash-attention
# kernels' bf16 variants counts the function's FLOPs at it
PEAK_BF16_FLOPS = 989e12
# kernel vs plain torch, fp32 on the card: the kernel sums q.k over D and
# p.v over keys in tile order (3xTF32 products) with an online softmax, the
# plain version in one cuBLAS product and one softmax — different summation
# orders
KERNEL_TOL = 1e-4
# the backward kernels vs their plain versions: the same orders again, over
# products of depth 64 (dP, dQ, dK, dV) fed by P recomputed from the lse;
# the tolerance of the Pallas backward's own test
# (tests/test_flash_attention.py:64)
KERNEL_BWD_TOL = 3e-4
# the bf16 variants against their plain versions: O, dQ, dK and dV are
# bf16, each the same fp32 function rounded once, from sums in other orders
# (and P, dS carried to 2^-16 by the kernels' hi/lo split); held to
# BF16_ULPS bf16 ulps of the tensor's largest magnitude. lse stays fp32:
# KERNEL_TOL
BF16_ULPS = 2
# the same artifact on the card and on the CPU: 12 layers of fp32 products
# and reductions summed in different orders on two devices
CROSS_DEVICE_TOL = 1e-3
# step-1 gradients on the card and on the CPU, each tensor's difference in
# L2 norm held to this fraction of its own norm. A ReLU unit whose
# pre-activation lies within rounding of 0 takes the other branch on the
# other device, which moves a few elements of the gradients upstream of it
# by their full size: measured at 1.2e-3 at most over Transformer-base's
# 183 gradients on an H100, where most agree within 1e-6 (PERF.md §6)
GRAD_TOL = 1e-2

TRANSFORMER_BASE = dict(src_vocab_size=10000, trg_vocab_size=10000,
                        max_length=256, n_layer=6, d_model=512, n_head=8,
                        d_inner=2048)
ATTENTION_OPS_PER_FORWARD = 18   # 6 encoder self, 6 decoder causal, 6 cross
TRAIN_BATCH = 16
TRAIN_STEPS = 20
# get_model's noam_decay lr, 2 * 512^-0.5 * step * WARMUP^-1.5, climbs from
# 3.1e-5 to 6.3e-4 over the 20 steps: a usable Adam lr from the start (the
# default 4000 would keep it under 1e-5). With 100 it passed 1e-3 at step
# 12 and the loss of this post-norm model rose from there.
TRAIN_WARMUP = 200

# the sparse optimizer kernels against their plain versions: the same fp32
# expression in the same order and rounding, so 0 or 1 ulp; the tolerance
# of the Pallas kernels' own test (tests/test_kernels.py:182)
SPARSE_TOL = 1e-6
# DeepFM at the model's own widths (paddle_tpu/models/deepfm.py:18-24): 26
# fields, vocab 100,000, embed_dim 10, hidden [400, 400, 400]; batch 256 and
# Adam(1e-3) as get_model sets them
CTR_BATCH = 256
CTR_EMBED_DIM = 10
CTR_LR = 1e-3
CTR_STEPS = 20
CTR_ADAGRAD_LR = 0.01
CTR_COMPARE_STEPS = 3
# card against CPU over CTR_COMPARE_STEPS Adam steps from the same weights:
# the sparse kernel sums the rows of a repeated id in the CPU's order (no
# atomics), but the fc products sum in another order on the card and the
# CPU's vectorised sqrt is not always correctly rounded, so the gradients
# and updates differ in their last bits and Adam's normalised steps carry
# that on (largest difference in PERF.md section 6)
CTR_CROSS_DEVICE_TOL = 1e-5
# sparse against dense Adagrad on the card: the same function (dense
# Adagrad leaves untouched rows unchanged), sums in another order; the
# tolerance of tests/test_sparse_embedding.py:98
ADAGRAD_RTOL, ADAGRAD_ATOL = 1e-4, 1e-6
# the single-batch learning check: the JAX package's run reached 4.0e-5
CTR_LEARN_LOSS = 0.01
# phase 7o (data and expert parallelism on a one-rank NCCL group): each way
# of Transformer-base trains PARALLEL_STEPS captured steps from one state
# and is held to the plain Executor's run: losses and every persistable
# within PARALLEL_TOL (relative; a one-rank average multiplies by 1.0)
PARALLEL_STEPS = 5
PARALLEL_TOL = 1e-6
# the MoE encoder: Transformer-base's encoder width with a moe_mlp in every
# position-wise FFN; loss + MOE_AUX_WEIGHT * the layers' auxiliary losses
MOE_ENCODER = dict(n_layer=6, d_model=512, n_head=8, num_experts=8,
                   hidden=2048, top_k=2, capacity_factor=2.0, vocab=10000,
                   max_length=256)
MOE_BATCH = 16
MOE_AUX_WEIGHT = 0.01
MOE_LR = 1e-4
# step 1 card against CPU at MOE_CPU_BATCH rows, the gradients within
# MOE_GRAD_SPREAD times the CPU's own spread (ResNet-50's rule); each
# layer's routes compared, since a near-tie of two gate logits can route a
# token to another expert on the card, which moves that expert's gradient
# far more than rounding does
MOE_CPU_BATCH = 2
MOE_GRAD_SPREAD = 3.0
# one batch forced to overflow: each expert holds a quarter of its tokens
MOE_OVERFLOW_CF = 0.5
# the paths each kernel may launch on (main() holds every path to it)
KERNEL_PATHS = {
    'flash_attention_fwd': ('serving', 'training', 'nets_attention',
                            'trainer', 'compiled'),
    'flash_attention_bwd_dq': ('training', 'nets_attention', 'trainer'),
    'flash_attention_bwd_dkv': ('training', 'nets_attention', 'trainer'),
    'flash_attention_fwd_bf16': ('amp_training', 'amp_serving',
                                 'amp_compiled'),
    'flash_attention_bwd_dq_bf16': ('amp_training',),
    'flash_attention_bwd_dkv_bf16': ('amp_training',),
    'sparse_adam': ('ctr_training', 'stream', 'tier'),
    'sparse_adagrad': ('ctr_training',),
    'paged_attention': ('decode', 'token_decode', 'spec_decode',
                        'token_stream'),
}
# phase 7k's paths: the int8 Transformer-base served, its training at
# PADDLE_TPU_OPT=default, and under the AMP pass
KERNEL_PATHS['flash_attention_fwd'] += ('int8_serving', 'opt_training')
KERNEL_PATHS['flash_attention_bwd_dq'] += ('opt_training',)
KERNEL_PATHS['flash_attention_bwd_dkv'] += ('opt_training',)
KERNEL_PATHS['flash_attention_fwd_bf16'] += ('amp_opt_training',)
KERNEL_PATHS['flash_attention_bwd_dq_bf16'] += ('amp_opt_training',)
KERNEL_PATHS['flash_attention_bwd_dkv_bf16'] += ('amp_opt_training',)
# phase 7o's paths: Transformer-base through ParallelExecutor, the MoE
# encoder (self-attention only) under set_mesh
KERNEL_PATHS['flash_attention_fwd'] += ('parallel', 'moe_encoder')
KERNEL_PATHS['flash_attention_bwd_dq'] += ('parallel', 'moe_encoder')
KERNEL_PATHS['flash_attention_bwd_dkv'] += ('parallel', 'moe_encoder')

# the paged decode attention against its plain version: an online softmax
# over pages against one softmax over the gathered rows; the Pallas
# kernel's own tolerance, 1e-5 + 1e-5 * |plain| (tests/test_kernels.py:127)
PAGED_TOL = 1e-5
# the machine_translation decoder at get_model's widths
# (paddle_tpu/models/machine_translation.py:137-138, seq_to_seq_net
# :82-100): target embedding 512, encoder rows 1024 (two 512-wide LSTMs
# concatenated), decoder LSTM 512, vocab 30000; beam 3, max_len 50
MT_DECODER = dict(E=512, D=1024, H=512, V=30000)
DECODE_CONFIG = dict(slots=16, beam_size=3, max_len=50, start_id=0,
                     end_id=1, src_cap=32, page_size=16, pages=64)
DECODE_REQUESTS = 48
DECODE_CANONICAL = 4        # sources every third request draws from
DECODE_CPU_REQUESTS = 4
# beam scores of two engines (dense on the card, paged on the CPU) against
# the paged engine on the card: the attention sums in another order, and
# log-probabilities of up to 50 steps accumulate the difference
DECODE_SCORE_TOL = 1e-4
# phase 6 (a): machine_translation's generating program at get_model's
# widths (MT_DECODER, beam and max_len of DECODE_CONFIG) on GEN_SOURCES
# sources of the synthetic wmt14 reader, timed over GEN_STEPS replays; the
# CPU decodes the first GEN_CPU_SOURCES of them
GEN_SOURCES = 16
GEN_CPU_SOURCES = 4
GEN_STEPS = 5
# (b): the token-fed burst's prefill pads every source to TOKEN_CAP ids
# (the wmt14 sources' 4-29 ids: the generating program's bucket 32)
TOKEN_CAP = 32
# (c): speculative decoding at beam 1, SPEC_K proposals a dispatch; the
# small weights draft's embedding and LSTM width
SPEC_K = 4
SPEC_DRAFT_WIDTH = 128

# phase 7: fit_a_line (get_model: batch 20, SGD 0.01) for FIT_EPOCHS epochs;
# its answers on the card and on the CPU: one fc of 13 products
FIT_EPOCHS = 10
FIT_SERVE_TOL = 1e-5
# MNIST LeNet (get_model: batch 128, Adam 1e-3): one epoch of the 8,192
# synthetic samples, then the test reader's accuracy
MNIST_STEPS = 64
MNIST_MIN_ACC = 0.9
# ResNet-50 as benchmark/fluid_benchmark.py trains it by default: batch 32,
# 1000 classes at 3x224x224, Momentum(0.01, 0.9)
RESNET_BATCH = 32
RESNET_STEPS = 20
RESNET_LEARN_STEPS = 30
# step 1 on the card against the CPU at this batch (1 when the CPU step
# takes over RESNET_CPU_STEP_S seconds), by the median over the tensors of
# |card - cpu| / |cpu| in L2 (the maximum printed beside it). The loss and
# the running stats are held to RESNET_GRAD_TOL. The gradients are not:
# ResNet-50 at its startup weights is chaotic, a perturbation of the input
# growing through each batch norm, so rounding-sized changes of the input
# alone move its step-1 gradients by percents (PERF.md section 6). cuDNN
# and the CPU's oneDNN round each convolution's sums (over 147-4,608
# products) differently, about 1e-6 relative, so the card's gradients are
# held to RESNET_GRAD_SPREAD times the CPU's own spread under an input
# perturbation of RESNET_INPUT_NOISE, measured in the same run
RESNET_CPU_BATCH = 2
RESNET_CPU_STEP_S = 30.0
RESNET_GRAD_TOL = 1e-4
RESNET_INPUT_NOISE = 1e-6
RESNET_GRAD_SPREAD = 3.0
# the NHWC tower's loss against the NCHW one's from the same weights, and
# the served probabilities on the card against the CPU and Predictor.run
RESNET_NHWC_TOL = 1e-4
RESNET_SERVE_TOL = 1e-4
# phase 7b (amp): AMP against fp32 losses on the card, step by step, within
# the JAX package's own bound for the same comparison (tests/test_amp.py)
AMP_FP32_RTOL, AMP_FP32_ATOL = 0.1, 1e-2
# step 1 under AMP, card against CPU (AMP on both): the loss (relative),
# and the gradients by the median over them of the relative L2
# difference, within AMP_GRAD_SPREAD times the CPU's own spread: its step
# again from the fp32 weights scaled by 1 + AMP_STATE_NOISE * noise. Under
# AMP that spread is not small: a value within fp32 rounding of a bf16
# rounding boundary lands on the other neighbour, 2^-8 relative, which
# moves the sums downstream by more than fp32 rounding and flips more of
# their roundings, so two sound runs that sum in other orders part by
# about as much as AMP itself parts from fp32 (PERF.md section 6). That
# comparison cannot tell a card that ignores AMP from one that keeps it;
# the op-by-op check can (below)
AMP_LOSS_TOL = 1e-3
AMP_GRAD_SPREAD = 3.0
AMP_STATE_NOISE = 1e-6
# the bf16 tower's spread: a share of its bf16 input moved to the next
# bf16 value (its inputs are integers less a channel mean, which no
# fp32-sized change moves to another bf16 value): the stem's sums of 147
# products carry about 2^-24 * sqrt(147) relative on another device,
# which rounds about 4e-4 of its bf16 outputs the other way
AMP_INPUT_FLIPS = 4e-4
# the AMP ResNet-50 loss's own spread on the CPU: the largest move over
# this many draws of such nudged inputs (one draw leaves the bf16 loss
# where it was in about half the runs)
AMP_LOSS_NUDGES = 4
# op by op (_ops_against_cpu): each forward op of the card's step against
# the CPU's rule on the same inputs, and at the AMP sites (the op's
# output and the inputs its vector-Jacobian product is taken for) the VJP
# too. An fp32 output within AMP_SITE_F32_TOL of its largest magnitude
# (the products' fp32 sums in other orders); a bf16 one within two bf16
# ulps of it, at most AMP_SITE_SHARE of its elements on another bf16
# neighbour. The hi + lo split of the products' cotangent and of the
# attention kernels' P and dS leaves 2^-16 of each term or less; where
# the terms cancel (the dS of a row sums to 0) that flips the rounding of
# a few elements in a hundred (measured up to 1.35% at the decoder's
# attention dQ on an H100, PERF.md), while one rounding more (the
# cotangent, or dS, rounded to bf16) moves about 40% of them
# (tests/test_torch_amp.py; the plain dQ with dS rounded, on the CPU)
AMP_SITES = {'mul': ('Out', ('X', 'Y')), 'matmul': ('Out', ('X', 'Y')),
             'conv2d': ('Output', ('Input', 'Filter')),
             'flash_attention': ('Out', ('Q', 'K', 'V'))}
AMP_SITE_F32_TOL = 1e-5
AMP_SITE_SHARE = 0.05
# bf16 serving: the engine's answers against Predictor.run (other batch
# shapes: other GEMM tilings) and the card against the CPU, by relative L2
# over the logits. The rounding flips compound through 12 layers here too:
# the card read 0.00399 against the CPU on an H100 (the same inputs and
# kernels give the same reading each run) and the card's fp32 artifact,
# the control, 0.00672 against the CPU's bf16 answer (PERF.md); the bound
# lies between them, and the control must exceed it. The transpiled step
# is also held op by op (_ops_against_cpu)
AMP_CROSS_DEVICE_TOL = 5e-3
# the AMP NHWC tower's step-1 loss against the NCHW one's from the same
# startup weights: other cuDNN algorithms round the bf16 activations
# differently
AMP_LAYOUT_TOL = 1e-2
# phase 8: steps timed per path and mode (captured, eager), and traced
# phase 7c: VGG-16 (vgg.get_model: cifar10, batch 32, Adam 1e-3) and
# SE-ResNeXt-50 (se_resnext.get_model: batch 16, 224x224) trained
# DENSE_STEPS captured steps; the loss falling: the mean of its last
# DENSE_WINDOW below the mean of its first DENSE_WINDOW, over VGG's first
# VGG_LEARN_STEPS reader steps (its dropouts keep the loss flat for about
# 25 steps) and SE-ResNeXt's first
# batch repeated SE_LEARN_STEPS steps (flowers' labels are noise)
VGG_BATCH = 32
SE_BATCH = 16
DENSE_STEPS = 20
VGG_LEARN_STEPS = 60
SE_LEARN_STEPS = 30
DENSE_WINDOW = 5
DENSE_TOP_KERNELS = 6
# the optimizer surface on LeNet, card against the CPU's eager steps from
# one state, SURFACE_STEPS steps at SURFACE_BATCH: every fetch and every
# persistable by relative L2. Adamax, RMSProp and Ftrl step by about the
# sign of a gradient where it is small, so an element whose gradient the
# two devices round to opposite signs steps the other way; the L2 over
# the tensor keeps such elements small beside the whole
SURFACE_BATCH = 128
SURFACE_STEPS = 5
SURFACE_TOL = 1e-3
SURFACE_CLIP_NORM = 1.0
SURFACE_OPTIMIZERS = (
    ('Adamax', dict(learning_rate=0.001)),
    ('DecayedAdagrad', dict(learning_rate=0.001)),
    ('Adadelta', dict(learning_rate=1.0, rho=0.9)),
    ('RMSProp', dict(learning_rate=0.0002, momentum=0.9)),
    ('Ftrl', dict(learning_rate=0.005, l1=1e-4, l2=1e-3)),
    ('Momentum', dict(learning_rate=0.01, momentum=0.9,
                      LARS_weight_decay=5e-4)),
)
SURFACE_SCHEDULES = ('exponential_decay', 'natural_exp_decay',
                     'inverse_time_decay', 'polynomial_decay',
                     'piecewise_decay')
# nets.scaled_dot_product_attention at Transformer-base's attention shape
NETS_ATTENTION = dict(B=16, T=256, H=8, D=64)
NETS_ATTENTION_STEPS = 3
# SGD's rate there: over the 3 steps the projections' weights move by 3e-3
# to 4e-3 of their norm, far above the fp32 rounding of the weights
NETS_ATTENTION_LR = 20.0
# the q, k and v projections' updates over those steps, card against CPU,
# by relative L2; on the CPU, dK and dV swapped in the plain backward read
# 1.44 and 1.10 (k, v), zeroed 1.0 each
NETS_UPDATE_TOL = 1e-2
CAPTURED_STEPS = 10
PROFILED_STEPS = 3
# phase 8 times this many replays and eager walks a path: its depth was
# cut from CAPTURED_STEPS when the whole script passed 1,000 s (its checks
# were not)
CAPTURED_STEPS_8 = 5
# phase 7d: the sequence models at full width (the JAX get_models'
# defaults) trained SEQ_STEPS captured steps each on their readers'
# batches; the loss falling on the first batch repeated SEQ_LEARN_STEPS
# steps (the mean of the last DENSE_WINDOW below that of the first); step
# 1 card against CPU at SEQ_CPU_BATCH sequences: the loss within
# SEQ_LOSS_TOL (relative), the gradients' median relative L2 within
# SEQ_GRAD_SPREAD x the CPU's own under startup weights nudged by
# AMP_STATE_NOISE (_nudged; the ids cannot be nudged); the classifiers'
# for_test clones through Predictor, card against CPU, within
# SEQ_SERVE_TOL of max(1, |p|) on SEQ_SERVE_ROWS LoDTensor sequences
SEQ_STEPS = 20
SEQ_LEARN_STEPS = 30
SEQ_CPU_BATCH = 4
SEQ_LOSS_TOL = 1e-4
SEQ_GRAD_SPREAD = 3.0
SEQ_SERVE_TOL = 1e-5
SEQ_SERVE_ROWS = 8
# phase 7e (book models): word2vec, recommender_system and
# label_semantic_roles through _sequence_model (the checks and records of
# phase 7d); SRL at the reference book's sizes, which are db_lstm's own
# defaults (word_dim 32, mark_dim 5, hidden 512, depth 8, batch 10), with
# SGD under exponential_decay(0.01, 100000, 0.5, staircase=True) and the
# pretrained `emb` loaded through scope.find_var(...).get_tensor().set().
# The served word2vec probabilities and recommender scores card against
# CPU within SEQ_SERVE_TOL; SRL's decode is discrete: the card's
# crf_decoding against the CPU rule on the card's own emissions, equal;
# the end-to-end paths of the card's and the CPU's Predictor token for
# token on every sequence whose Viterbi margins (best against second-best
# score at the last step and at each back-pointer of the path, in float64)
# exceed BOOK_TIE_FACTOR x the card-CPU emission difference summed over
# its steps, at least half of BOOK_SRL_SERVE_ROWS sequences.
BOOK_SRL = dict(word_dim=32, mark_dim=5, hidden_dim=512, depth=8,
                batch_size=10)
BOOK_SRL_LR = (0.01, 100000, 0.5)
BOOK_SRL_SERVE_ROWS = 32
BOOK_TIE_FACTOR = 4.0
# phase 7f (control flow and the LoD beam search) at machine_translation's
# widths (paddle_tpu/models/machine_translation.py:137-138): (a) the
# contrib TrainingDecoder seq2seq through _sequence_model (phase 7d's
# checks and records), Adam(2e-4) at batch 16; (b) the contrib
# BeamSearchDecoder (topk 10) on (a)'s weights; (c) the book's While-loop
# LoD beam decoder on random weights from SEED. Both decoders take 16
# wmt14 sources (bucket 32) at beam 3 (phase 6's), max_len 32, end id 1;
# their ids (and (c)'s 2-level LoD) equal to the CPU's on the same
# weights, scores within CONTROL_FLOW_SCORE_TOL x max(1, |score|) (a score
# sums 32 steps' log-probabilities: about -330 at this vocabulary, where an
# fp32 ulp is 3e-5); the replay bitwise equal to the eager walk.
CONTROL_FLOW = dict(dict_size=30000, word_dim=512, hidden=512)
CONTROL_FLOW_BATCH = 16
CONTROL_FLOW_LR = 2e-4
CONTROL_FLOW_BEAM = 3
CONTROL_FLOW_MAX_LEN = 32
CONTROL_FLOW_END_ID = 1
CONTROL_FLOW_TOPK = 10
CONTROL_FLOW_SCORE_TOL = 1e-5
# timed calls of each decode, captured and eager (the book decoder's eager
# walk takes about 0.64 s)
CONTROL_FLOW_TIMED = 5
# phase 7g (trainer): Transformer-base (TRANSFORMER_BASE, batch TRAIN_BATCH,
# warmup TRAIN_WARMUP: get_model's program and Adam over the scaled
# noam_decay) through fluid.Trainer on the card. (a) TRAINER_STEPS steps of
# the wmt16 reader with double_buffer on and a periodic checkpoint every
# TRAINER_INTERVAL steps (steps 0 and 6: two saves); (b) a SIGTERM at
# BeginStepEvent TRAINER_PREEMPT_AT, the resumed Trainer's periodic save at
# 6 and a second preemption at 7; (c) the newest serial torn by one flipped
# byte; (d) bundle_steps TRAINER_BUNDLE and (e) sync='async' over the
# first TRAINER_PARITY_STEPS steps from (a)'s start weights, against (a)'s
# losses within TRAINER_PARITY_RTOL (relative); (f) test() on
# TRAINER_TEST_BATCHES test batches, and the Inferencer's logits on the
# card against the CPU's within TRAINER_INFER_TOL of max(1, |logit|): the
# same artifact on two devices, as phase 4's Predictor is held; (g) the
# conv MNIST net of tests/test_book_high_level_api.py (8 filters) at
# models/mnist.py's batch 128, Adam 1e-3, one epoch with double_buffer
# off and on.
TRAINER_STEPS = 12
TRAINER_INTERVAL = 6
TRAINER_PREEMPT_AT = 4
TRAINER_RESUMED_STEPS = 8
TRAINER_BUNDLE = 4
TRAINER_PARITY_STEPS = 8
TRAINER_BUNDLE_INTERVAL = 5
TRAINER_PARITY_RTOL = 1e-6
TRAINER_TEST_BATCHES = 2
TRAINER_INFER_TOL = 1e-4
TRAINER_MNIST_BATCH = 128
# phase 7h (stream): online CTR training with live serving freshness.
# DeepFM at its full width (26 fields, vocab 100,000, embed_dim 10, hidden
# [400] x 3, both FM tables is_sparse, Adam(CTR_LR), batch CTR_BATCH)
# through fluid.Trainer(double_buffer=True).train_stream over the JAX
# bench.py:826-836 stream: Zipf(1.5) ids around a base that moves
# STREAM_DRIFT ids a step, in a 2^30 universe, starting at step
# STREAM_T0. A VocabTable(100000, table='fm_embed', admit_count=2) fronts
# the tables, preloaded with the 99,999 raw ids just below the first base
# (an earlier window), so it is full before the first step and every step
# admits and evicts. A DeltaPublisher(interval_steps=STREAM_PUBLISH_EVERY)
# pushes through a Router into two ServingEngine replicas of the DeepFM
# scorer saved from the startup state (buckets STREAM_BUCKETS), while a
# client thread sends 1-STREAM_CLIENT_ROWS-row requests (and every
# STREAM_PROBE_EVERY-th one the 16-row probe) through Router.predict.
# STREAM_WARM steps (the warm-up and the capture), STREAM_STEPS timed, then
# STREAM_CHECK_STEPS with the zero checks and a SIGTERM at their
# STREAM_PREEMPT_AT-th boundary; the identity drill over STREAM_IDENTITY
# batches of synthetic_ctr_reader.
STREAM_T0 = 10000
STREAM_DRIFT = 17
STREAM_UNIVERSE = 1 << 30
STREAM_ADMIT = 2
STREAM_PUBLISH_EVERY = 5
STREAM_BUCKETS = (1, 2, 4, 8, 16)
STREAM_CLIENT_ROWS = 8
STREAM_PROBE_EVERY = 4
STREAM_WARM = 2
STREAM_STEPS = 300
STREAM_CHECK_STEPS = 10
STREAM_PREEMPT_AT = 6
STREAM_IDENTITY = 8
# the served answer after the final publish against a Predictor of the same
# scorer given the trainer's FM tables: the same graphs on the same card,
# within 1e-6 of max(1, |score|)
STREAM_SERVE_TOL = 1e-6
# phase 7i (serving_stream): phase 6's paged DecodeEngine (MT_DECODER,
# DECODE_CONFIG, its 48 requests) behind a Router, each request streamed by
# one of TOKEN_CLIENTS client threads; (b) TOKEN_CANCELS of them cancelled
# after TOKEN_CANCEL_AFTER tokens; (c) TOKEN_RESUMES streams checkpointed
# every TOKEN_CKPT_EVERY tokens, moved to a second engine at their second
# checkpoint; (d) TOKEN_PUSH_ROWS target-embedding rows pushed (row 0, the
# start id every first step reads, among them)
TOKEN_CLIENTS = 8
TOKEN_CANCELS = 8
TOKEN_CANCEL_AFTER = 3
TOKEN_RESUMES = 8
TOKEN_CKPT_EVERY = 4
TOKEN_PUSH_ROWS = 64
# (e): Transformer-base exported at the largest serving bucket; the loaded
# artifact against Predictor.run of the same weights on the same card, fp32
# within 1e-6 of max(1, |logit|) (the same rules traced into one graph);
# the bf16 artifact of the transpiled program by relative L2 within
# AMP_CROSS_DEVICE_TOL, phase 7b's bound; COMPILED_CALLS timed replays
COMPILED_BATCH = 16
COMPILED_TOL = 1e-6
COMPILED_CALLS = 10
# phase 7j (tier): phase 5's DeepFM through fluid.Trainer(double_buffer=
# True).train_stream over the JAX bench.py:898-1006 (bench_tiered) stream:
# Zipf(TIER_ZIPF) ids around a base that moves TIER_DRIFT ids a step, over
# TIER_UNIVERSE ids (8x the 100,000 rows), 0/1 labels. The tiered leg's
# TieredVocabTable(VocabTable(100000, table='fm_embed', admit_count=
# TIER_ADMIT), host_arena(dir, slots=TIER_SLOTS)) and the plain leg's
# VocabTable are preloaded full (ids 1..99,999, the window the stream
# starts in), so nearly every step evicts; each leg runs TIER_WARM steps,
# then TIER_STEPS timed,
# with 7h's publisher into two replicas behind a Router. (c) SIGTERM at the
# STREAM_PREEMPT_AT-th boundary of STREAM_CHECK_STEPS, then
# TIER_RESUME_STEPS more steps, uninterrupted and resumed. (b) The bitwise
# drill: TIER_DRILL_STEPS batches of the same stream shape over
# TIER_DRILL_UNIVERSE ids, a one-table net (Adam TIER_DRILL_LR), capacity
# TIER_DRILL_CAP against a reference that covers every id.
TIER_UNIVERSE = 800000
TIER_DRIFT = 13
TIER_ZIPF = 1.3
TIER_ADMIT = 2
TIER_SLOTS = 800000
TIER_WARM = 2
TIER_STEPS = 300
TIER_RESUME_STEPS = 10
TIER_DRILL_UNIVERSE = 131072
TIER_DRILL_CAP = 16384
TIER_DRILL_STEPS = 60
TIER_DRILL_LR = 1e-2

# phase 7k (passes): the int8 answers against the fp32 Predictor of the same
# weights, max |int8 - fp32| over max |fp32|: the JAX package's bound and
# measure for a quantized output (tests/test_kernels.py:363-364)
PASSES_INT8_TOL = 0.05
PASSES_REQUESTS = 8
PASSES_BATCH = 16          # serving's largest bucket
PASSES_TIMED = 10          # replays timed a path, in turns
PASSES_STEPS = 3
# ResNet-50's logits before and after the conv+BN fold, max |diff| over max
# |logit|: the same function, rounded in other places (the folded weights,
# a bias add in place of the normalization) over 53 layers; phase 7's
# serving tolerance
PASSES_FOLD_TOL = 1e-4
RESNET_BN_FOLDS = 53       # 1 stem + 16 blocks x 3 + 4 projections

# phase 7l (detection): MobileNet-SSD as PaddlePaddle/models' fluid
# object_detection/mobilenet_ssd.py builds it (a MobileNet-v1 backbone at
# scale 1.0, 3x300x300 images, 21 VOC classes) with multi_box_head over the
# 19, 10, 5, 3, 2 and 1 maps at base_size 300, min_ratio 20, max_ratio 90,
# aspect_ratios [[2], [2, 3] x 5], offset 0.5, flip (the layer's derived
# sizes: 2,278 priors), ssd_loss and RMSProp(SSD_LR) with L2Decay(SSD_L2):
# SSD_STEPS captured steps at SSD_BATCH on seeded images and 1-8 gt boxes
# an image (labels 1-20); the batches SSD_WIDE_BATCHES hold an image of 9-16
# boxes (a second time bucket, warmed up and captured). Step 1 card against
# CPU at SSD_CPU_BATCH images as phase 7 holds ResNet-50. Serving: the
# detection_output program (SSD_NMS) through a captured Predictor at
# SSD_SERVE_BATCH, its rows equal to the CPU rule's on the card's decoded
# boxes and scores but for (image) rows decided by an IoU within
# SSD_NMS_TIE of the threshold; detection_map over SSD_MAP_BATCHES served
# batches through fluid.metrics.DetectionMAP, card against CPU within
# SSD_MAP_TOL. (b) An RPN head on the 19x19 map: anchor_generator (sizes
# 64, 128, 256, ratios 0.5, 1, 2, stride 16: 3,249 anchors),
# rpn_target_assign's defaults, sigmoid cross entropy and smooth_l1 masked
# to the sampled slots; RPN_STEPS captured steps at RPN_BATCH, step 1 card
# against CPU at RPN_CPU_BATCH. (c) The 14 nn_ops rules the slice added, each
# once at a vision size, forward and VJP against the CPU rule within
# VISION_TOL of max(1, |x|).
SSD_CLASSES = 21
SSD_IMAGE = 300
SSD_PRIORS = 2278
SSD_BATCH = 32
SSD_STEPS = 20
SSD_LR = 1e-3
SSD_L2 = 5e-5
SSD_WIDE_BATCHES = (10, 15)
SSD_IMAGE_POOL = 4          # distinct image batches the steps cycle through
SSD_WINDOW = 5
SSD_CPU_BATCH = 4
SSD_SERVE_BATCH = 8
SSD_NMS = dict(nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
               score_threshold=0.01)
SSD_NMS_TIE = 1e-5
SSD_MAP_BATCHES = 4
SSD_MAP_TOL = 1e-5
SSD_TIMED = 10
RPN_BATCH = 16
RPN_STEPS = 5
RPN_ANCHORS = 3249
RPN_CPU_BATCH = 4
VISION_TOL = 1e-4

# phase 7m (the rest of the training surface): word2vec's N-gram net at
# get_model's widths (dict 2073, embed 32, hidden 256, N 5, batch 64, SGD)
# with its softmax head swapped for layers.nce (W2V_NEG negatives, the
# layer's default; SGD at W2V_NCE_LR) and for layers.hsigmoid (SGD at
# get_model's W2V_LR), W2V_STEPS captured steps
# each on dataset.imikolov.train's batches (the reader cycled): the mean
# loss of the last W2V_WINDOW steps below the first W2V_WINDOW's. NCE: the
# negatives of replays 2 and 3 differ, and step W2V_COST_STEP's Cost
# equals the CPU's on that step's fetched negatives and the same weights
# within W2V_COST_TOL. hsigmoid: step 1 card against CPU within 3x the
# CPU's own spread under weights nudged by AMP_STATE_NOISE. (c) The 27
# rules one program each (generate_layer_fn where the rule's slots are X
# and Y, append_op otherwise), captured through Executor(), forward and
# VJP (the differentiable inputs made parameters) against the CPU within
# EXTRA_TOL of max(1, |x|); sampling_id by law over EXTRA_DRAWS draws a
# row; the proximal rules updating their parameter in place over
# EXTRA_UPDATES replays. (d) The four initializers in a startup program:
# INIT_STD_TOL on the std of the random ones, Bilinear's depthwise
# conv2d_transpose within RESIZE_TOL. (e) bilinear_interp at output dims of
# 1, forward and VJP within RESIZE_TOL.
W2V_DICT = 2073
W2V_STEPS = 200
W2V_WINDOW = 20
W2V_NEG = 10
W2V_LR = 1e-3
# at get_model's 1e-3 the NCE loss moves less than its step-to-step noise
# over W2V_STEPS: its gradient reaches a class's row only when the class is
# drawn (10 of 2,073 a step), so the rows move by about lr / 11 a draw
W2V_NCE_LR = 0.05
W2V_COST_STEP = 3
W2V_COST_TOL = 1e-4
EXTRA_TOL = 1e-4
EXTRA_DRAWS = 20000
EXTRA_UPDATES = 3
INIT_STD_TOL = 0.02
RESIZE_TOL = 1e-5
RESIZE_CASES = ((2, 1, 3, 1), (1, 2, 1, 3), (5, 4, 1, 1), (1, 1, 4, 4),
                (19, 19, 1, 38), (38, 38, 19, 1))

# phase 7n (the recordio half of the data path): RIO_SAMPLES raw samples of
# dataset.flowers' raw reader (256x320x3 uint8 and a label) written by
# reader.recordio.write_samples into RIO_SHARDS shards, read through
# layers.open_files -> shuffle(RIO_SHUFFLE) -> batch(RESNET_BATCH) ->
# dataset.image.simple_transform_batch(resize 256, crop 224, train,
# RIO_MEAN, seed: the batch index) -> double_buffer(CUDAPlace(0)) into
# ResNet-50 (flowers: 102 classes, Momentum 0.01/0.9), RIO_STEPS steps fp32
# NCHW and RIO_STEPS of phase 7b's AMP NHWC tower, then RIO_MEMORY_STEPS of
# each step fed one batch already on the card. Each step's input wait,
# to_feed time, garbage collections and device and pinned host
# allocations are logged. (b) RIO_LOD_BATCHES imdb
# batches of understand_sentiment through fluid.recordio_writer. (c) A
# Preprocessor block over RIO_PREP_BATCHES raw batches, card against CPU
# within RIO_PREP_TOL. The transform timed over RIO_TRANSFORM_REPS calls.
RIO_SAMPLES = 1280
RIO_SHARDS = 4
RIO_SHUFFLE = 256
RIO_MEAN = [103.94, 116.78, 123.68]
RIO_STEPS = 30
# the chain's images/s is also read from step RIO_SETTLED + 1 on: the first
# replays of the AMP step still grow the device allocator (cudaMalloc calls
# and 90-200 ms steps in replays 1-2 on an H100, PERF.md section 6)
RIO_SETTLED = 5
RIO_MEMORY_STEPS = 20
RIO_TRANSFORM_REPS = 10
RIO_LOD_BATCHES = 12
RIO_PREP_BATCHES = 2
RIO_PREP_TOL = 1e-6


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=50, warmup=5, rounds=3):
    """Device ms per call: CUDA events around `iters` back-to-back calls,
    the median of `rounds` such runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


_CAPTURE = []


def capture_stream():
    """The one side stream every graph is warmed up and captured on. An
    autograd backward launches its kernels on the stream its forward ran
    on, so a backward is captured here only after its forward ran on this
    stream."""
    import torch
    if not _CAPTURE:
        _CAPTURE.append(torch.cuda.Stream())
    return _CAPTURE[0]


def time_graph_ms(fn, iters=50, rounds=3):
    """Device ms per call with the host out of the way: `iters` calls
    captured in one CUDA graph, the replay timed with CUDA events, the
    median of `rounds` replays. For kernels shorter than the wrapper's
    own Python, where time_ms measures the host."""
    import torch
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def device_kernel_counts(fn):
    """{name: count} of the device kernels (memsets and copies included)
    one call of fn launches, as torch.profiler shows them (after one call
    to warm up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def device_kernels(fn):
    """The names of the device kernels one call of fn launches."""
    return sorted(device_kernel_counts(fn))


# -- phase 1 ----------------------------------------------------------------

# the SASS opcodes counted in the bf16 kernels (the forward and the backward
# pair): their products must run on wgmma (HGMMA), none on mma.sync (HMMA);
# no atomics on their outputs; no 16-bit shared loads (a tile read down its
# columns). {library's kernel: function names}; the fp32 kernels in the same
# libraries run mma.sync by design and are left out by name.
SASS_COUNTED = ('HGMMA', 'HMMA', 'ATOM', 'ATOMS', 'ATOMG', 'RED', 'REDG',
                'LDS.U16')
SASS_BF16 = {'KERNEL_BF16': ('fwd_bf16_kernel',),
             'KERNEL_BWD_DQ_BF16': ('bwd_dq_bf16_kernel',
                                    'bwd_dkv_bf16_kernel')}


def sass_counts(sass, names):
    """{kernel function: {opcode: count of SASS_COUNTED}} of the functions
    in `sass` (cuobjdump -sass output) whose (mangled) names hold one of
    `names`."""
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            current = m.group(1) if any(n in m.group(1)
                                        for n in names) else None
            if current:
                counts[current] = dict.fromkeys(SASS_COUNTED, 0)
            continue
        if current is None or '*/' not in line:
            continue
        words = line.split('*/', 1)[1].split()
        if words and words[0].startswith('@'):
            words = words[1:]
        if not words:
            continue
        op = words[0]
        key = 'LDS.U16' if op.startswith('LDS.U16') else op.split('.')[0]
        if key in counts[current]:
            counts[current][key] += 1
    return counts


def phase_build(strict=True):
    """Build every kernel source; returns {source: [(spill stores, spill
    loads), ...]} for the checked sources that spill. Strict (the default),
    it raises on any spill, and unless every bf16 kernel's SASS (the
    forward and the backward pair, SASS_BF16) holds HGMMA and no HMMA,
    atomic or 16-bit shared load;
    tools/torch_attention_bench.py times older checkouts, which may spill
    or predate wgmma, with strict=False and reports both."""
    from paddle_tpu_torch import ops
    t0 = time.perf_counter()
    logs = ops.build_all()
    secs = time.perf_counter() - t0
    log('[build] %d source(s) built in %.3f s, kernels: %s'
        % (len(logs), secs, ', '.join(sorted(ops.KERNELS))))
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line \
                    or 'entry function' in line or 'wgmma' in line:
                log('[build] %s: %s' % (name, line.strip()))
    # the flash-attention kernels keep their strips of s (and dP), the
    # forward's split Q and the outputs in registers, the paged attention
    # its partial scores and accumulators: a spill would put them in local
    # memory
    fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    pa = importlib.import_module(
        'paddle_tpu_torch.ops.kernels.paged_attention')
    spilled = {}
    for source in sorted({fa.KERNEL.source, fa.KERNEL_BWD_DQ.source,
                          pa.KERNEL.source}):
        spills = [m for m in re.findall(
            r'(\d+) bytes spill stores, (\d+) bytes spill loads',
            logs.get(source, '')) if m != ('0', '0')]
        if spills:
            spilled[source] = spills
    if spilled and strict:
        raise AssertionError('the kernels spill registers: %r' % spilled)
    cuobjdump = os.path.join(os.path.dirname(ops._cuda.nvcc_path()),
                             'cuobjdump')
    sass, names = {}, []
    for kernel, fns in sorted(SASS_BF16.items()):
        names.extend(fns)
        sass.update(sass_counts(subprocess.run(
            [cuobjdump, '-sass', getattr(fa, kernel).library.library_path()],
            check=True, capture_output=True, text=True).stdout, fns))
    for fn, c in sorted(sass.items()):
        log('[build] SASS %s: %s' % (fn, json.dumps(c)))
    bad = [fn for fn, c in sass.items()
           if not c['HGMMA'] or any(n for k, n in c.items()
                                    if k != 'HGMMA')]
    if strict and (bad or len(sass) < len(names)):
        raise AssertionError('the bf16 kernels must run wgmma (HGMMA) '
                             'alone, with no HMMA, atomic or 16-bit shared '
                             'load: %r' % sass)
    log('[build] card: %s' % nvidia_smi_line())
    return spilled


# -- phase 2 ----------------------------------------------------------------

def _attention_case(name, B, H, Tq, Tk, D, causal, gen):
    import torch
    dev = torch.device('cuda', 0)
    q = torch.randn((B, H, Tq, D), generator=gen, device=dev)
    k = torch.randn((B, H, Tk, D), generator=gen, device=dev)
    v = torch.randn((B, H, Tk, D), generator=gen, device=dev)
    # pad bias as the Transformer builds it: -1e9 past each row's length;
    # the first key is always live, so no row is fully masked
    lens = torch.randint(Tk // 2, Tk + 1, (B,), generator=gen, device=dev)
    bias = torch.where(torch.arange(Tk, device=dev)[None, :] < lens[:, None],
                       0.0, -1e9).to(torch.float32).contiguous()
    return dict(name=name, q=q, k=k, v=v, bias=bias, causal=causal,
                scale=D ** -0.5, shape=[B, H, Tq, Tk, D])


def _pairs(Tq, Tk, causal):
    """(query, key) pairs the kernels compute: under causal masking only
    those on or below the diagonal."""
    if causal:
        return sum(min(i + 1, Tk) for i in range(Tq))
    return Tq * Tk


def _bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """Least time for the work, ms, and what bounds it."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), 'operations' if t_ops >= t_bytes else 'bytes'


def _attention_bound(B, H, Tq, Tk, D, causal, bf16=False):
    """Forward: 2 tile products (s, P.V) of depth D per pair. fp32: each an
    fp32-accurate product from three TF32 ones (3xTF32), so at a third of
    the TF32 rate; bf16: at the dense bf16 rate. q, k, v and O read or
    written once at their width (4 or 2 bytes), bias and lse at 4."""
    flops = 4.0 * B * H * D * _pairs(Tq, Tk, causal)
    nbytes = (2.0 if bf16 else 4.0) * (B * H * Tq * D * 2
                                       + B * H * Tk * D * 2) \
        + 4.0 * (B * Tk + B * H * Tq)
    return _bound(flops, nbytes,
                  PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3)


def _attention_bwd_bound(B, H, Tq, Tk, D, causal, which, bf16=False):
    """Backward: dQ ('dq') does 3 tile products per pair (s, dP, dQ), dK/dV
    ('dkv') 4 (s, dP, dV, dK), the two ('both') 14 * B * H * D * pairs
    FLOPs, in 3xTF32 at a third of the TF32 rate, or in bf16 at the dense
    bf16 rate. Each reads q, k, v and dO (at their width) and bias, lse
    and delta (fp32) once and writes its outputs once."""
    products = {'dq': 3, 'dkv': 4, 'both': 7}[which]
    flops = 2.0 * products * B * H * D * _pairs(Tq, Tk, causal)
    tensors = (B * H * Tq * D * 2 + B * H * Tk * D * 2
               + B * H * Tq * D * (which != 'dkv')
               + 2 * B * H * Tk * D * (which != 'dq'))
    nbytes = (2.0 if bf16 else 4.0) * tensors \
        + 4.0 * (B * Tk + 2 * B * H * Tq)
    return _bound(flops, nbytes,
                  PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS / 3)


# the rate the flash-attention kernels' operations are counted at, beside
# their bound_by
TF32X3_OPS_RATE = '3xTF32: 495 / 3 TFLOP/s'
BF16_OPS_RATE = 'bf16: 989 TFLOP/s'


def _sdpa_mask(c):
    """The additive [B, 1, Tq, Tk] mask SDPA needs for the same function:
    the key bias, and NEG_BIG above the diagonal under causal masking."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import NEG_BIG
    B, H, Tq, Tk, D = c['shape']
    mask = c['bias'][:, None, None, :].expand(B, 1, Tq, Tk)
    if c['causal']:
        tri = torch.ones((Tq, Tk), dtype=torch.bool, device='cuda').tril()
        mask = mask.masked_fill(~tri, NEG_BIG)
    return mask.contiguous()


def _max_err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def bf16_tol(ref):
    """BF16_ULPS bf16 ulps of the largest magnitude of `ref`."""
    m = float(ref.detach().abs().max().float())
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _parity(got, want, tol):
    """(ok, max abs error) of kernel outputs against their plain versions:
    a bf16 output within bf16_tol of its plain version, an fp32 one within
    tol (absolute and relative)."""
    import torch
    ok, err = True, 0.0
    for g, w in zip(got, want):
        err = max(err, float((g.float() - w.float()).abs().max()))
        if g.dtype == torch.bfloat16:
            ok = ok and float((g.float() - w.float()).abs().max()) \
                <= bf16_tol(w)
        else:
            ok = ok and torch.allclose(g, w, atol=tol, rtol=tol)
    return ok, err


def _bits(t):
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _digest(*ts):
    """sha1 of the tensors' bits: tools/torch_attention_bench.py holds two
    checkouts' outputs on the same draws bitwise against each other."""
    h = hashlib.sha1()
    for t in ts:
        h.update(_bits(t.detach().contiguous()).cpu().numpy().tobytes())
    return h.hexdigest()


def _attention_cases(bf16=False, D=64):
    """The flash-attention kernels (forward, backward dQ and dK/dV), or
    their bf16 variants on the same draws rounded to bf16, against their
    plain versions in four cases at head dim D (the Transformer's 64;
    tools/torch_attention_bench.py times others); returns {kernel name:
    [case result, ...]}."""
    import torch
    import torch.nn.functional as F
    # the module (ops/__init__ exports a function of the same name)
    fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    dt = torch.bfloat16 if bf16 else torch.float32
    sfx = '_bf16' if bf16 else ''
    ops_rate = BF16_OPS_RATE if bf16 else TF32X3_OPS_RATE
    fwd_tol = '%d bf16 ulps of max |O|; lse %g' % (BF16_ULPS, KERNEL_TOL) \
        if bf16 else KERNEL_TOL
    bwd_tol = '%d bf16 ulps of max |grad|' % BF16_ULPS if bf16 \
        else KERNEL_BWD_TOL
    # the batch the training path gives every kernel, and the largest
    # bucket serving gives the forward
    B, H, T = TRAIN_BATCH, 8, 256
    cases = [
        _attention_case('encoder self, pad bias', B, H, T, T, D, False, gen),
        _attention_case('decoder self, causal', B, H, T, T, D, True, gen),
        _attention_case('cross, Tq != Tk', B, H, T, 160, D, False, gen),
        _attention_case('ragged T=200, causal', B, H, 200, 200, D, True,
                        gen),
    ]
    results = {n + sfx: [] for n in ('flash_attention_fwd',
                                     'flash_attention_bwd_dq',
                                     'flash_attention_bwd_dkv')}
    for c in cases:
        q, k, v = [c[n].to(dt) for n in ('q', 'k', 'v')]
        kb, causal, scale = c['bias'], c['causal'], c['scale']
        Bq, Hq, Tq, Tk, Dq = c['shape']
        head = dict(case=c['name'], shape=dict(zip(('B', 'H', 'Tq', 'Tk',
                                                    'D'), c['shape'])),
                    causal=causal, dtype=str(dt).replace('torch.', ''))
        mask = _sdpa_mask(c).to(dt)

        # forward: each block owns the rows it writes and sums in a fixed
        # order, so a second launch on the same inputs gives the same bits
        kw = dict(key_bias=kb, causal=causal, sm_scale=scale)

        def fwd():
            return fa._flash_lse_cuda(q, k, v, kb, causal, scale)

        def fwd_plain():
            return fa.flash_attention_lse_plain(q, k, v, **kw)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)
        o, lse = fwd()
        again = fwd()
        torch.cuda.synchronize()
        deterministic = all(torch.equal(_bits(a), _bits(b))
                            for a, b in zip((o, lse), again))
        ok, err = _parity((o, lse), fwd_plain(), KERNEL_TOL)
        bound_ms, bound_by = _attention_bound(Bq, Hq, Tq, Tk, Dq, causal,
                                              bf16)
        r = dict(head, max_abs_err=err,
                 ok=ok and deterministic and o.dtype == dt,
                 deterministic=deterministic, digest=_digest(o, lse),
                 tol=fwd_tol,
                 ms=time_graph_ms(fwd), eager_ms=time_ms(fwd),
                 plain_ms=time_graph_ms(fwd_plain),
                 library='scaled_dot_product_attention on the same %s '
                         'operands with the same additive mask (O only)'
                         % head['dtype'],
                 library_kernels=device_kernels(sdpa),
                 library_ms=time_graph_ms(sdpa),
                 bound_ms=bound_ms, bound_by=bound_by, ops_rate=ops_rate)
        log('[kernels] flash_attention_fwd%s %s' % (sfx, json.dumps(r)))
        results['flash_attention_fwd' + sfx].append(r)

        # backward: both cotangents, delta = rowsum(dO * O) - dlse as the
        # autograd Function makes it
        do = torch.randn(o.shape, generator=gen, device='cuda').to(dt)
        dlse = torch.randn(lse.shape, generator=gen, device='cuda')
        delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
        bwd = (q, k, v, kb, do, lse, delta, causal, scale)
        fa._check_bwd(q, do, lse, delta)
        dq = fa._bwd_dq_cuda(*bwd)
        dk, dv = fa._bwd_dkv_cuda(*bwd)
        # each block owns the rows it writes, in a fixed order: a second
        # launch on the same inputs must give the same bits
        again = (fa._bwd_dq_cuda(*bwd),) + fa._bwd_dkv_cuda(*bwd)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(_bits(a), _bits(b))
                            for a, b in zip((dq, dk, dv), again))
        want_dq = fa.flash_attention_bwd_dq_plain(*bwd)
        want_dkv = fa.flash_attention_bwd_dkv_plain(*bwd)
        # no library call computes dQ alone or dK/dV alone: SDPA's
        # backward (autograd through it with the same additive mask; the
        # dlse cotangent has no counterpart there) computes all three, so
        # it stands beside the pair of kernels, timed together. Its forward
        # runs on the capture stream, where its backward is then captured
        # (and once more on this stream, for the eager time).
        outs = []
        for stream in (capture_stream(), torch.cuda.current_stream()):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                qr, kr, vr = [t.detach().clone().requires_grad_()
                              for t in (q, k, v)]
                outs.append(((qr, kr, vr), F.scaled_dot_product_attention(
                    qr, kr, vr, attn_mask=mask, scale=scale)))
            torch.cuda.current_stream().wait_stream(stream)

        def sdpa_bwd(leaves, out):
            return lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True)

        def pair_fn():
            return fa._bwd_dq_cuda(*bwd), fa._bwd_dkv_cuda(*bwd)
        pair_bound, pair_by = _attention_bwd_bound(Bq, Hq, Tq, Tk, Dq,
                                                   causal, 'both', bf16)
        pair = dict(
            kernels=['flash_attention_bwd_dq' + sfx,
                     'flash_attention_bwd_dkv' + sfx],
            ms=time_graph_ms(pair_fn), eager_ms=time_ms(pair_fn),
            bound_ms=pair_bound, bound_by=pair_by, ops_rate=ops_rate,
            library='torch.autograd.grad through scaled_dot_product_'
                    'attention on the same %s operands: dQ, dK and dV in '
                    'one backward' % head['dtype'],
            library_kernels=device_kernels(sdpa_bwd(*outs[1])),
            library_ms=time_graph_ms(sdpa_bwd(*outs[0])),
            library_eager_ms=time_ms(sdpa_bwd(*outs[1])))
        for name, which, got, want, kern, plain in (
                ('flash_attention_bwd_dq', 'dq', (dq,), (want_dq,),
                 fa._bwd_dq_cuda, fa.flash_attention_bwd_dq_plain),
                ('flash_attention_bwd_dkv', 'dkv', (dk, dv), want_dkv,
                 fa._bwd_dkv_cuda, fa.flash_attention_bwd_dkv_plain)):
            bound_ms, bound_by = _attention_bwd_bound(Bq, Hq, Tq, Tk, Dq,
                                                      causal, which, bf16)
            ok, err = _parity(got, want, KERNEL_BWD_TOL)
            r = dict(head, max_abs_err=err,
                     ok=ok and deterministic
                     and all(g.dtype == dt for g in got),
                     deterministic=deterministic, digest=_digest(*got),
                     tol=bwd_tol,
                     ms=time_graph_ms(lambda: kern(*bwd)),
                     eager_ms=time_ms(lambda: kern(*bwd)),
                     plain_ms=time_graph_ms(lambda: plain(*bwd)),
                     library_ms=None, bound_ms=bound_ms,
                     bound_by=bound_by, ops_rate=ops_rate,
                     backward_pair=pair)
            log('[kernels] %s%s %s' % (name, sfx, json.dumps(r)))
            results[name + sfx].append(r)
    return results


def phase_kernels():
    """Every kernel against its plain version in its cases; returns
    {kernel name: [case result, ...]}."""
    results = _attention_cases()
    results.update(_attention_cases(bf16=True))
    results.update(_sparse_optim_cases())
    for name, rs in _sparse_rows_cases().items():
        results[name].extend(rs)
    results['paged_attention'] = _paged_attention_cases()
    for name, rs in results.items():
        bad = [r['case'] for r in rs if not r['ok']]
        if bad:
            raise AssertionError('%s disagrees with its plain version '
                                 'beyond %s%s in: %s' % (
                                     name, rs[0]['tol'],
                                     ', or with its own second launch,'
                                     if any('deterministic' in r
                                            for r in rs) else '',
                                     bad))
    return results


def _sparse_merges(gen):
    """The four merges the sparse optimizer kernels are held on, as
    _merge_sparse makes them on the card: (name, D, uids, gm, valid)."""
    import torch
    from paddle_tpu_torch.fluid.lowering import SparseRows
    from paddle_tpu_torch.fluid.ops_impl.optim_ops import _merge_sparse
    from paddle_tpu_torch.models import deepfm
    ids = torch.from_numpy(ctr_feed(first_ctr_batch())['feat_ids']
                           .reshape(-1)).cuda()
    n = ids.shape[0]
    dups = torch.randint(0, 64, (n,), generator=gen, device='cuda')
    dups[:2] = 0
    out = []
    for name, D, case_ids in (
            ('main-path merge, D=10 (fm_embed)', CTR_EMBED_DIM, ids),
            ('main-path merge, D=1 (fm_first_w)', 1, ids),
            ('duplicate-heavy, ids 0..63, D=10', CTR_EMBED_DIM, dups),
            ('all invalid, D=10', CTR_EMBED_DIM, ids)):
        rows = torch.randn((n, D), generator=gen, device='cuda') * 1e-2
        uids, gm, valid = _merge_sparse(
            SparseRows(case_ids, rows, (deepfm.VOCAB, D)))
        if name.startswith('all invalid'):
            uids, gm = torch.zeros_like(uids), torch.zeros_like(gm)
            valid = torch.zeros_like(valid)
        out.append((name, D, uids, gm, valid))
    return out


def _sparse_bound(n, d, n_valid, n_tables, flops_per_element):
    """Least time for one merged update, ms, from the bytes this data needs:
    the bool valid mask of all n slots and lr read once; for the valid
    slots only, the int64 uid and the gm row read once and each table row
    read once and written once (an invalid slot reads nothing more)."""
    nbytes = (1.0 * n + 4 + n_valid * (8.0 + 4.0 * d)
              + 2 * 4.0 * n_valid * d * n_tables)
    return _bound(float(flops_per_element) * n_valid * d, nbytes)


def _sparse_optim_cases():
    """sparse_adam and sparse_adagrad against their plain versions on
    DeepFM's tables (100,000 rows) in four merges each; returns
    {kernel name: [case result, ...]}."""
    import torch
    from paddle_tpu_torch.models import deepfm
    so = importlib.import_module(
        'paddle_tpu_torch.ops.kernels.sparse_optim')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED + 3)
    lr = torch.tensor(1e-3, device='cuda')
    b1, b2, eps = 0.9, 0.999, 1e-8
    kinds = {
        # name: (kernel, plain, tables, extra args, flops per element)
        'sparse_adagrad': (so.fused_sparse_adagrad,
                           so.fused_sparse_adagrad_plain, 2, (1e-6,), 9),
        'sparse_adam': (so.fused_sparse_adam, so.fused_sparse_adam_plain,
                        3, (b1, b2, eps), 16),
    }
    results = {k: [] for k in kinds}
    for case, D, uids, gm, valid in _sparse_merges(gen):
        tables = [torch.randn((deepfm.VOCAB, D), generator=gen,
                              device='cuda') * 0.1,
                  torch.rand((deepfm.VOCAB, D), generator=gen,
                             device='cuda') * 1e-3,
                  torch.rand((deepfm.VOCAB, D), generator=gen,
                             device='cuda') * 1e-5]
        n_valid = int(valid.sum())
        for name, (kern, plain, nt, extra, fpe) in kinds.items():
            args = (uids, gm, valid, lr) + extra
            given = [t.clone() for t in tables[:nt]]
            got = kern(*given, *args)
            torch.cuda.synchronize()
            want = plain(*[t.clone() for t in tables[:nt]], *args)
            err = _max_err(got, want)
            ok = err <= SPARSE_TOL and all(
                g is t for g, t in zip(got, given))
            if not valid.any():     # no slot valid: bitwise the input
                ok = ok and all(torch.equal(g.view(torch.int32),
                                            t.view(torch.int32))
                                for g, t in zip(got, tables))
            # timing updates scratch copies in place, call after call.
            # ms and plain_ms are device times (graph replays); the
            # eager_ ones are per call through the wrapper, as the step
            # calls it, where the host's Python is the longer part
            scratch = [t.clone() for t in tables[:nt]]
            bound_ms, bound_by = _sparse_bound(gm.shape[0], D, n_valid, nt,
                                               fpe)
            r = dict(case=case, shape=dict(V=deepfm.VOCAB,
                                           N=int(gm.shape[0]), D=D,
                                           valid=n_valid),
                     max_abs_err=err, ok=ok, tol=SPARSE_TOL,
                     ms=time_graph_ms(lambda: kern(*scratch, *args)),
                     plain_ms=time_graph_ms(lambda: plain(*scratch, *args)),
                     eager_ms=time_ms(lambda: kern(*scratch, *args)),
                     plain_eager_ms=time_ms(lambda: plain(*scratch, *args)),
                     library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            log('[kernels] %s %s' % (name, json.dumps(r)))
            results[name].append(r)
    return results


def _sparse_rows_ids(gen):
    """The id vectors the rows-form route is held on, C = 6,656 each:
    (name, D, ids int64 on the card)."""
    import torch
    from paddle_tpu_torch.models import deepfm
    ids = torch.from_numpy(ctr_feed(first_ctr_batch())['feat_ids']
                           .reshape(-1)).cuda()
    n = ids.shape[0]
    dups = torch.randint(0, 64, (n,), generator=gen, device='cuda')
    # a field with one value in every example of the batch (Criteo's
    # low-cardinality fields): one id 256 times, four ids 64 times each,
    # the rest uniform over the vocabulary, in shuffled order
    hot = torch.randperm(deepfm.VOCAB, generator=gen, device='cuda')[:5]
    skewed = torch.randint(0, deepfm.VOCAB, (n,), generator=gen,
                           device='cuda')
    skewed[:CTR_BATCH] = hot[0]
    for k in range(4):
        skewed[CTR_BATCH + 64 * k:CTR_BATCH + 64 * (k + 1)] = hot[k + 1]
    skewed = skewed[torch.randperm(n, generator=gen, device='cuda')]
    return [('rows: main-path ids, D=10 (fm_embed)', CTR_EMBED_DIM, ids),
            ('rows: main-path ids, D=1 (fm_first_w)', 1, ids),
            ('rows: duplicate-heavy, ids 0..63, D=10', CTR_EMBED_DIM, dups),
            ('rows: skewed, one id x256, four x64, D=10', CTR_EMBED_DIM,
             skewed),
            ('rows: a single id, D=10', CTR_EMBED_DIM,
             torch.full_like(ids, int(hot[0])))]


def _sparse_rows_bound(n, d, n_unique, n_tables, id_bytes,
                       flops_per_element):
    """Least time for one fused rows-form update, ms (the sort not
    included): the sorted ids (id_bytes each) and the int64 order read
    once, the [n, d] rows read once, each touched table row read once and
    written once in every table, lr; the segment sums' n * d adds and
    the update's operations on each touched element."""
    nbytes = (n * (id_bytes + 8.0) + 4.0 * n * d
              + 2 * 4.0 * n_unique * d * n_tables + 4)
    return _bound(n * d + float(flops_per_element) * n_unique * d, nbytes)


def _sparse_rows_cases():
    """The rows-form route (the ids' sort, then one launch that sums each
    id's rows and updates the tables) of sparse_adam and sparse_adagrad
    against its plain version on the card, two launches bitwise equal, in
    five id vectors on DeepFM's tables; beside it the parent's route
    (_merge_sparse, then the merged-form kernel) and the sorts alone,
    with the device kernels each route launches. Returns {kernel name:
    [case result, ...]}. A checkout without the rows form (an older one,
    timed by tools/torch_attention_bench.py) gets the parent's route and
    the sorts only."""
    import torch
    from paddle_tpu_torch.fluid.lowering import SparseRows
    from paddle_tpu_torch.fluid.ops_impl.optim_ops import _merge_sparse
    from paddle_tpu_torch.models import deepfm
    so = importlib.import_module(
        'paddle_tpu_torch.ops.kernels.sparse_optim')
    rows_form = hasattr(so, 'fused_sparse_adam_rows')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED + 5)
    lr = torch.tensor(1e-3, device='cuda')
    b1, b2, eps = 0.9, 0.999, 1e-8
    kinds = {
        # name: (merged form, rows form, tables, extra args, flops per
        # element); the plain versions are named with _plain after them
        'sparse_adagrad': ('fused_sparse_adagrad', 'fused_sparse_adagrad_rows',
                           2, (1e-6,), 9),
        'sparse_adam': ('fused_sparse_adam', 'fused_sparse_adam_rows', 3,
                        (b1, b2, eps), 16),
    }
    results = {k: [] for k in kinds}
    for case, D, ids in _sparse_rows_ids(gen):
        n = ids.shape[0]
        shape = (deepfm.VOCAB, D)
        rows = torch.randn((n, D), generator=gen, device='cuda') * 1e-2
        tables = [torch.randn(shape, generator=gen, device='cuda') * 0.1,
                  torch.rand(shape, generator=gen, device='cuda') * 1e-3,
                  torch.rand(shape, generator=gen, device='cuda') * 1e-5]
        n_unique = int(torch.unique(ids).numel())
        ids32 = ids.to(torch.int32)

        def merge():
            return _merge_sparse(SparseRows(ids, rows, shape))
        sorts = dict(
            sort_int64_ms=time_graph_ms(lambda: torch.sort(ids, stable=True)),
            sort_int32_ms=time_graph_ms(
                lambda: torch.sort(ids32, stable=True)),
            cast_sort_int32_ms=time_graph_ms(
                lambda: torch.sort(ids.to(torch.int32), stable=True)),
            merge_ms=time_graph_ms(merge),
            merge_kernels=device_kernel_counts(merge))
        for name, (merged_name, rows_name, nt, extra, fpe) in kinds.items():
            merged_fn = getattr(so, merged_name)
            scratch = [t.clone() for t in tables[:nt]]

            def fresh():
                return [t.clone() for t in tables[:nt]]

            def parent_route():
                return merged_fn(*scratch, *merge(), lr, *extra)
            r = dict(case=case, shape=dict(V=deepfm.VOCAB, C=n, D=D,
                                           unique=n_unique),
                     tol=SPARSE_TOL, library_ms=None,
                     parent_route_ms=time_graph_ms(parent_route),
                     parent_route_kernels=device_kernel_counts(parent_route),
                     **sorts)
            if rows_form:
                fused = getattr(so, rows_name)
                plain = getattr(so, rows_name + '_plain')
                args = (ids, rows, lr) + extra
                given = fresh()
                got = fused(*given, *args)
                again = fused(*fresh(), *args)
                torch.cuda.synchronize()
                # the plain version with its merge on the CPU, where
                # index_add_ adds each id's rows in ascending sorted
                # position, the kernel's order; on the card its atomics
                # add them in run-to-run order, which moves a sum of
                # thousands of rows by more than SPARSE_TOL
                # (card_plain_max_abs_err)
                want = getattr(so, merged_name + '_plain')(
                    *fresh(), *[t.cuda() for t in so.merge_rows(
                        ids.cpu(), rows.cpu())], lr, *extra)
                err = _max_err(got, want)
                deterministic = all(
                    torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got, again))
                sids, order = so.sort_ids(ids, deepfm.VOCAB)

                def route():
                    return fused(*scratch, *args)
                bound_ms, bound_by = _sparse_rows_bound(
                    n, D, n_unique, nt, sids.element_size(), fpe)
                r.update(
                    max_abs_err=err, deterministic=deterministic,
                    bitwise_cpu_order=all(
                        torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, want)),
                    card_plain_max_abs_err=_max_err(got, plain(*fresh(),
                                                               *args)),
                    ok=err <= SPARSE_TOL and deterministic and all(
                        g is t for g, t in zip(got, given)),
                    ms=time_graph_ms(route),
                    kernel_ms=time_graph_ms(lambda: so.launch_sorted(
                        scratch, sids, order, rows, lr, *extra)),
                    sort_ms=time_graph_ms(
                        lambda: so.sort_ids(ids, deepfm.VOCAB)),
                    eager_ms=time_ms(route),
                    plain_ms=time_graph_ms(lambda: plain(*scratch, *args)),
                    route_kernels=device_kernel_counts(route),
                    id_dtype=str(sids.dtype), bound_ms=bound_ms,
                    bound_by=bound_by)
            log('[kernels] %s %s' % (name, json.dumps(r)))
            results[name].append(r)
    return results


def paged_case(rng, C, beam, ps, npe, src_cap, D, lo, masked_slot=None,
               hi=29):
    """Paged encoder pools as the decode engine lays them out, numpy:
    page 0 the zero page, each slot's pages drawn from a permutation of
    the rest, a length in [lo, min(hi, src_cap)] setting the mask (29: the
    decode path's longest source), the tail entries on page 0;
    `masked_slot` owns no page (an inactive slot). Returns (q [C*beam,
    D], enc_pages, mask_pages, pt_enc)."""
    n_pages = 1 + C * npe
    enc = (rng.randn(n_pages, ps, D) * 0.5).astype(np.float32)
    enc[0] = 0.0
    mask = np.zeros((n_pages, ps), np.float32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    pt = np.zeros((C, npe), np.int32)
    for c in range(C):
        ln = 0 if c == masked_slot else \
            int(rng.randint(lo, min(hi, src_cap) + 1))
        for j in range(-(-ln // ps)):
            pt[c, j] = free.pop()
            mask[pt[c, j], :min(ps, ln - j * ps)] = 1.0
    # the scale of the decode path's queries (h @ w_q, |h| < 1)
    q = (rng.randn(C * beam, D) * 0.3).astype(np.float32)
    return q, enc, mask, pt


def _paged_bound(C, beam, ps, npe, src_cap, D, pt):
    """Least time for one call, ms: q read and the context written once,
    each distinct page below src_cap read once (rows and mask), the
    tables read once; 4 FLOPs per (query row, position, element)."""
    used = -(-src_cap // ps)
    pages = len(set(pt[:, :used].reshape(-1).tolist()))
    nbytes = 4.0 * (2 * C * beam * D + pages * (ps * D + ps) + C * npe)
    return _bound(4.0 * C * beam * min(src_cap, npe * ps) * D, nbytes)


def _paged_attention_cases():
    """paged_attention against its plain version on the card in seven
    cases, two launches bitwise equal; returns [case result, ...]."""
    import torch
    import torch.nn.functional as F
    pa = importlib.import_module(
        'paddle_tpu_torch.ops.kernels.paged_attention')
    rng = np.random.RandomState(SEED + 4)
    cases = [
        # name, C, beam, ps, NPE, src_cap, D, shortest and longest
        # source, masked slot
        ('decode path: 16 slots, beam 3, ps 16, NPE 2, src_cap 32, D 1024',
         16, 3, 16, 2, 32, 1024, 4, 29, None),
        ('src_cap 29, not a multiple of ps', 16, 3, 16, 2, 29, 1024, 4, 29,
         None),
        ('one fully masked slot', 16, 3, 16, 2, 32, 1024, 4, 29, 5),
        ('beam 1 over 64 slots', 64, 1, 16, 2, 32, 1024, 4, 29, None),
        ('D 6, the test decoder (ps 3, src_cap 5)', 4, 3, 3, 2, 5, 6, 1, 29,
         1),
        ('long sources: NPE 16, src_cap 250 (4 chunks)', 16, 3, 16, 16, 250,
         1024, 100, 250, None),
        ('beam 1 over 16 slots, D 1024 (the speculative step)', 16, 1, 16,
         2, 32, 1024, 4, 29, None),
    ]
    out = []
    for name, C, beam, ps, npe, src_cap, D, lo, hi, masked in cases:
        arrays = paged_case(rng, C, beam, ps, npe, src_cap, D, lo, masked,
                            hi)
        args = [torch.from_numpy(a).cuda() for a in arrays]
        got = pa.paged_attention(*args, src_cap)
        again = pa.paged_attention(*args, src_cap)
        torch.cuda.synchronize()
        deterministic = torch.equal(got.view(torch.int32),
                                    again.view(torch.int32))
        want = pa.paged_attention_plain(*args, src_cap)
        err = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (err <= PAGED_TOL + PAGED_TOL * want.abs()).all()) \
            and deterministic
        # SDPA over the same rows gathered beforehand: [C, 1, beam, D]
        # queries, [C, 1, S, D] keys = values, an additive finfo.min mask
        q, enc_pages, mask_pages, pt = args
        rows = enc_pages[pt.long()].reshape(C, 1, npe * ps, D)[:, :, :src_cap]
        live = mask_pages[pt.long()].reshape(C, 1, 1, npe * ps)[
            ..., :src_cap] > 0
        add = torch.where(live, 0.0, pa.NEG_MASKED).to(torch.float32)
        qg = q.reshape(C, 1, beam, D)
        lib = F.scaled_dot_product_attention(qg, rows, rows, attn_mask=add,
                                             scale=1.0)
        bound_ms, bound_by = _paged_bound(C, beam, ps, npe, src_cap, D,
                                          arrays[3])
        r = dict(case=name, shape=dict(C=C, beam=beam, ps=ps, NPE=npe,
                                       src_cap=src_cap, D=D),
                 # the launch (older checkouts, timed by
                 # tools/torch_attention_bench.py, have no plan)
                 plan=pa.launch_plan(C, D, beam, src_cap)._asdict()
                 if hasattr(pa, 'launch_plan') else None,
                 max_abs_err=float(err.max()), ok=ok, tol=PAGED_TOL,
                 deterministic=deterministic,
                 library_max_abs_err=float(
                     (lib.reshape(C * beam, D) - want).abs().max()),
                 ms=time_graph_ms(lambda: pa.paged_attention(*args,
                                                             src_cap)),
                 plain_ms=time_graph_ms(
                     lambda: pa.paged_attention_plain(*args, src_cap)),
                 eager_ms=time_ms(lambda: pa.paged_attention(*args,
                                                             src_cap)),
                 plain_eager_ms=time_ms(
                     lambda: pa.paged_attention_plain(*args, src_cap)),
                 library='scaled_dot_product_attention over the gathered '
                         'rows (the page gather excluded)',
                 library_ms=time_graph_ms(
                     lambda: F.scaled_dot_product_attention(
                         qg, rows, rows, attn_mask=add, scale=1.0)),
                 bound_ms=bound_ms, bound_by=bound_by)
        log('[kernels] paged_attention %s' % json.dumps(r))
        out.append(r)
    return out


# -- phase 3 ----------------------------------------------------------------

def logits_var(program):
    """The decoder logits [B, T, V]: the X input of the reshape whose
    output is the Logits input of softmax_with_cross_entropy."""
    blk = program.global_block()
    lg = [op.input('Logits')[0] for op in blk.ops
          if op.type == 'softmax_with_cross_entropy'][0]
    return blk.var([op.input('X')[0] for op in blk.ops
                    if op.type == 'reshape' and op.output('Out')[0] == lg][0])


def build_artifact(dirname, config, place):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer as T
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    scope = fluid.Scope()
    with unique_name.guard(), framework.program_guard(main, startup):
        T.transformer(**config)
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ['src_word', 'trg_word'],
                                  [logits_var(main)], exe,
                                  main_program=main, scope=scope)


def make_requests(n_requests, max_rows, max_length, vocab, rng):
    reqs = []
    for _ in range(n_requests):
        rows = int(rng.randint(1, max_rows + 1))
        feed = {}
        for name in ('src_word', 'trg_word'):
            ids = np.zeros((rows, max_length), dtype='int64')
            for r in range(rows):
                n = int(rng.randint(8, max_length + 1))
                ids[r, :n] = rng.randint(1, vocab, n)
            feed[name] = ids
        reqs.append(feed)
    return reqs


def phase_serving():
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        return _serve(tmp)


def _serve(tmp):
    import torch
    from paddle_tpu_torch import fluid, inference, obs, ops, serving
    cfg = TRANSFORMER_BASE
    t0 = time.perf_counter()
    build_artifact(tmp, cfg, fluid.CUDAPlace(0))
    log('[serving] built, initialized on the card and saved Transformer-'
        'base in %.3f s' % (time.perf_counter() - t0))
    pred = inference.Predictor(tmp)
    engine = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=16, max_queue_delay_ms=20.0))
    reqs = make_requests(8, 4, cfg['max_length'], cfg['trg_vocab_size'],
                         np.random.RandomState(SEED))
    batch_hist = obs.histogram('serving.batch.seconds')
    n_before = batch_hist.count
    try:
        # the main path: warmup over every bucket, then concurrent traffic
        for k in ops.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        buckets = engine.warmup()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(engine.submit, reqs))
        answers = [f.result(timeout=600)[0] for f in futs]
        serve_s = time.perf_counter() - t0
        launches = {n: k.launches for n, k in ops.KERNELS.items()}
        stats = engine.stats
    finally:
        engine.shutdown()
    batches = stats['batches']
    # warmup runs each bucket twice: its warm-up and its capture
    warm = serving.engine.WARMUP_RUNS * len(buckets)
    runs = warm + batches
    want = ATTENTION_OPS_PER_FORWARD * runs
    if launches['flash_attention_fwd'] != want:
        raise AssertionError(
            'flash_attention_fwd launched %d times for %d forward(s) '
            '(%d warmup + %d batches); the path must launch it %d times '
            'per forward' % (launches['flash_attention_fwd'], runs,
                             warm, batches,
                             ATTENTION_OPS_PER_FORWARD))
    rows = sum(r['src_word'].shape[0] for r in reqs)
    real_tokens = sum(int((r['trg_word'] != 0).sum()) for r in reqs)
    n_b = batch_hist.count - n_before
    log('[serving] warmup over buckets %s: %.3f s' % (buckets, warm_s))
    log('[serving] %d requests, %d rows in %d batch(es) in %.4f s; '
        'per-batch latency mean %.4f s min %.4f s max %.4f s; '
        '%.1f target positions/s (%d real target tokens: %.1f tokens/s)'
        % (len(reqs), rows, batches, serve_s,
           (batch_hist.sum / batch_hist.count) if n_b else float('nan'),
           batch_hist.min, batch_hist.max,
           rows * cfg['max_length'] / serve_s, real_tokens,
           real_tokens / serve_s))
    log('[serving] flash_attention_fwd launches: %d = %d x %d forwards'
        % (launches['flash_attention_fwd'], ATTENTION_OPS_PER_FORWARD, runs))

    # correctness: every answer against Predictor.run on the same rows
    worst = 0.0
    for req, ans in zip(reqs, answers):
        n = req['src_word'].shape[0]
        if ans.shape != (n, cfg['max_length'], cfg['trg_vocab_size']):
            raise AssertionError('answer shape %r' % (ans.shape,))
        if not np.isfinite(ans).all():
            raise AssertionError('non-finite logits in an answer')
        direct = pred.run(req)[0]
        worst = max(worst, float(np.abs(ans - direct).max()))
        np.testing.assert_allclose(ans, direct, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL)
    log('[serving] engine answers vs Predictor.run: max abs diff %.3g '
        '(tol %g)' % (worst, KERNEL_TOL))
    # the whole card path (kernel included) against the plain CPU path
    cpu = inference.Predictor(tmp, place=fluid.CPUPlace())
    small = {k: v[:1] for k, v in reqs[0].items()}
    ref = cpu.run(small)[0]
    diff = float(np.abs(answers[0][:1] - ref).max())
    np.testing.assert_allclose(answers[0][:1], ref, atol=CROSS_DEVICE_TOL,
                               rtol=CROSS_DEVICE_TOL)
    log('[serving] card vs CPU on one request row: max abs diff %.3g '
        '(tol %g, |logits| max %.3g)' % (diff, CROSS_DEVICE_TOL,
                                         float(np.abs(ref).max())))
    torch.cuda.synchronize()
    return launches


# -- phase 4 ----------------------------------------------------------------

def build_trainer(dropout=True):
    """get_model at full width in fresh programs; with dropout=False its
    training program without the dropout ops (the same parameter and
    accumulator names), for comparing two devices step for step. Returns
    (main, startup, avg_cost, feed names, train_reader or None)."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer as T
    cfg = TRANSFORMER_BASE
    width = dict(max_length=cfg['max_length'], n_layer=cfg['n_layer'],
                 d_model=cfg['d_model'], n_head=cfg['n_head'],
                 d_inner=cfg['d_inner'], warmup_steps=TRAIN_WARMUP)
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    reader = None
    with unique_name.guard(), framework.program_guard(main, startup):
        if dropout:
            avg_cost, _, reader, _, feeds = T.get_model(
                batch_size=TRAIN_BATCH, dict_size=cfg['src_vocab_size'],
                **width)
        else:
            avg_cost, _, feeds = T.training_program(
                cfg['src_vocab_size'], dropout_rate=0.0, **width)
    return main, startup, avg_cost, feeds, reader


def as_feed(batch, names):
    """A padded get_model batch -> {name: [B, T] int64}."""
    return {n: np.stack([row[i] for row in batch])
            for i, n in enumerate(names)}


def grad_names(program):
    ad = [op for op in program.global_block().ops if op.type == 'autodiff']
    return list(ad[0].attrs['grad_names'])


def phase_training():
    import torch
    from paddle_tpu_torch import fluid, ops
    cfg = TRANSFORMER_BASE
    t0 = time.perf_counter()
    main, startup, avg_cost, names, reader = build_trainer()
    scope = fluid.Scope()
    exe = fluid.Executor()                      # the default place: the card
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    it = reader()
    feeds = [as_feed(next(it), names) for _ in range(TRAIN_STEPS)]
    log('[training] built get_model (batch %d, max_length %d, warmup_steps '
        '%d), initialized on the card and read %d wmt16 batches in %.3f s'
        % (TRAIN_BATCH, cfg['max_length'], TRAIN_WARMUP, TRAIN_STEPS,
           time.perf_counter() - t0))

    # the main path: TRAIN_STEPS steps, each ending in its loss fetch
    for k in ops.KERNELS.values():
        k.launches = 0
    losses, step_s = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(loss).reshape(())))
    launches = {n: k.launches for n, k in ops.KERNELS.items()}

    want = ATTENTION_OPS_PER_FORWARD * TRAIN_STEPS
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        if launches[name] != want:
            raise AssertionError(
                '%s launched %d times in %d training steps; the path must '
                'launch it %d times per step' % (
                    name, launches[name], TRAIN_STEPS,
                    ATTENTION_OPS_PER_FORWARD))
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite training loss: %r' % (losses,))
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError('the loss did not fall: %r' % (losses,))
    med = float(np.median(step_s[1:]))
    positions = TRAIN_BATCH * cfg['max_length'] * 2     # source + target
    log('[training] losses %s' % ', '.join('%.4f' % x for x in losses))
    log('[training] step seconds %s' % ', '.join('%.4f' % x
                                                 for x in step_s))
    log('[training] median step (steps 2-%d) %.4f s: %.1f source+target '
        'positions/s; launches per step: %s'
        % (TRAIN_STEPS, med, positions / med,
           {n: v // TRAIN_STEPS for n, v in sorted(launches.items())}))

    _check_grads_against_cpu(initial)
    _serve_trained(main, scope, exe)
    torch.cuda.synchronize()
    return launches


def _grad_check_feed(names):
    """A 2-row wmt16 batch for the step-1 checks. The corpus starts each
    target with id 0, also the pad id, which leaves the decoder's first
    query row no live key (ill-conditioned everywhere, and the forward
    kernel only sums that row over its diagonal tile): that position gets
    a live id here."""
    from paddle_tpu_torch.dataset import wmt16
    from paddle_tpu_torch.models.transformer import pad_batch
    cfg = TRANSFORMER_BASE
    rows = itertools.islice(wmt16.train(cfg['src_vocab_size'],
                                        cfg['trg_vocab_size'])(), 2)
    feed = as_feed(pad_batch(list(rows), cfg['max_length']), names)
    feed['trg_word'][:, 0] = 2
    return feed


def _check_grads_against_cpu(state):
    """Step 1 of the dropout-free twin program from the startup weights
    `state`, on the card and on the CPU, for a 2-row batch
    (_grad_check_feed): the loss and every @GRAD."""
    from paddle_tpu_torch import fluid
    main, _, avg_cost, names, _ = build_trainer(dropout=False)
    feed = _grad_check_feed(names)
    fetch = [avg_cost] + grad_names(main)
    outs = {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        s = fluid.Scope()
        s.load_numpy(state, place)
        outs[where] = fluid.Executor(place).run(main, feed=feed,
                                                fetch_list=fetch, scope=s)
    loss, loss_cpu = float(outs['card'][0]), float(outs['cpu'][0])
    if not abs(loss - loss_cpu) <= CROSS_DEVICE_TOL * abs(loss_cpu):
        raise AssertionError('step-1 loss %r on the card, %r on the CPU'
                             % (loss, loss_cpu))
    errs = []
    for name, g, w in zip(fetch[1:], outs['card'][1:], outs['cpu'][1:]):
        norm = float(np.linalg.norm(w))
        err = float(np.linalg.norm(g - w)) / norm if norm else \
            float(np.abs(g).max())
        errs.append((err, name))
        if not np.isfinite(g).all() or err > GRAD_TOL:
            raise AssertionError('%s on the card differs from the CPU by '
                                 '%.3g of its L2 norm (tol %g)'
                                 % (name, err, GRAD_TOL))
    errs.sort(reverse=True)
    log('[training] step 1 from the startup weights, card vs CPU (2 rows, '
        'dropout off): loss %.6f vs %.6f; %d gradients, |diff| / |grad| '
        '(L2) median %.3g, worst %s (tol %g)'
        % (loss, loss_cpu, len(errs), errs[len(errs) // 2][0],
           ', '.join('%s %.3g' % (n, e) for e, n in errs[:3]), GRAD_TOL))


def _as_list(vals):
    return list(vals) if isinstance(vals, (list, tuple)) else [vals]


def _held_to_cpu(got, want, rounded=False):
    """(share of elements that differ (bf16 values; 0 for fp32 ones),
    |got - want| max, tolerance, passed) of a card tensor against the
    CPU's: a bf16 tensor (or, `rounded`, an
    fp32 one of bf16 values) within two bf16 ulps of max |want| with at
    most AMP_SITE_SHARE of its elements differing, an fp32 one within
    AMP_SITE_F32_TOL of max |want|, any other equal."""
    import torch
    got = got.detach().cpu()
    if not want.is_floating_point():
        same = torch.equal(got, want)
        return 0.0 if same else 1.0, 0.0, 0.0, same
    g, w = got.to(torch.float32), want.to(torch.float32)
    share = float((g != w).float().mean()) if w.numel() else 0.0
    err = float((g - w).abs().max()) if w.numel() else 0.0
    peak = float(w.abs().max()) if w.numel() else 0.0
    if want.dtype == torch.bfloat16 or rounded:
        tol = bf16_tol(w)
        return share, err, tol, err <= tol and share <= AMP_SITE_SHARE
    tol = AMP_SITE_F32_TOL * peak
    return 0.0, err, tol, err <= tol


def _attention_backward(ins, attrs, ctx, device, rng):
    """The backward kernels at one flash_attention op: q, k, v and the key
    bias as the rule hands them on (amp_cast under AMP), O and lse from
    the plain forward, dO drawn from `rng`, delta = rowsum(dO * O) as the
    wrapper takes it; the CUDA route on `device` and the plain version on
    the CPU from those same inputs (the gradient through the wrapper would
    hold the backward to each side's own O, which differs from the other
    by O's bf16 roundings). Returns [(slot, card gradient, CPU
    gradient)]."""
    import torch
    from paddle_tpu_torch.fluid import lowering
    fa = importlib.import_module('paddle_tpu_torch.ops.flash_attention')
    q, k, v = lowering.amp_cast(ctx, *[ins[n][0].contiguous()
                                       for n in ('Q', 'K', 'V')])
    B, Tk = q.shape[0], k.shape[2]
    kb = ins.get('KeyBias')
    kb = fa._key_bias(kb[0].reshape(B, Tk) if kb else None, B, Tk,
                      q.device).contiguous()
    scale = attrs.get('scale', -1.0)
    scale = fa._scale_of(q.shape[-1], None if scale is None or scale < 0
                         else float(scale))
    causal = bool(attrs.get('causal', False))
    o, lse = fa.flash_attention_lse_plain(q, k, v, kb, causal, scale)
    do = torch.from_numpy(rng.randn(*o.shape).astype('float32')).to(o.dtype)
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)
    args = (q, k, v, kb, do, lse, delta)
    want = fa.flash_attention_bwd_plain(*args, causal, scale)
    got = fa._flash_bwd_cuda(*[t.to(device) for t in args], causal, scale)
    return list(zip('QKV', got, want))


def _ops_against_cpu(what, prog, state, feed, fetch, control=False):
    """Op by op, the card's step against the CPU's rules: the card's eager
    walk (debug_step) of `prog` from `state` on `feed`, and each forward
    op's inputs, as the card made them, through the same rule on the CPU
    (the step's AMP flag): every output held by _held_to_cpu. At the AMP
    sites (AMP_SITES) of a training step the vector-Jacobian product too,
    for a cotangent drawn from SEED: the gradients of the floating inputs
    from the card's rule and the CPU's, by _held_to_cpu (at
    flash_attention, the backward kernels on the plain forward's O and
    lse: _attention_backward). Each op sees the card's own inputs, so the
    comparison does not compound from op to op, as the step-1 gradients
    do. With `control`, the products again on the card with AMP off (fp32
    operands) must miss the forward bound at every product site. Returns
    nothing; raises on a failed op."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import lowering
    card = fluid.CUDAPlace(0)
    exe = fluid.Executor(card)
    scope = fluid.Scope()
    _load_state(scope, state, card)
    art = exe.step_artifact(prog, feed=feed, fetch_list=fetch, scope=scope)
    persist = {n: t.clone() for n, t in art.state_dict(scope).items()}
    cpu, cuda = torch.device('cpu'), card.torch_device()
    dev = {n: t.to(cuda) for n, t in exe._feed_values(prog, feed).items()}
    rng = np.random.RandomState(SEED)
    prev = dict(persist)
    prev.update(dev)
    tally = {'ops': 0, 'sites': 0, 'vjp_share': 0.0, 'share': 0.0,
             'control_missed': 0, 'control_sites': 0, 'worst': (0.0, '')}

    def ctx_on(device, amp):
        return lowering.Ctx(device, torch.Generator(device=device), amp=amp)

    def hold(name, got, want, rounded=False):
        share, err, tol, ok = _held_to_cpu(got, want, rounded)
        if tol and err / tol > tally['worst'][0]:
            tally['worst'] = (err / tol, name)
        if not ok:
            raise AssertionError(
                '%s, op by op: %s on the card differs from the CPU\'s rule '
                'on the same inputs by %.3g (tol %.3g), %.4f of its elements '
                '(tol %g)' % (what, name, err, tol, share, AMP_SITE_SHARE))
        return share

    def hook(i, op, dt, env):
        nonlocal prev
        before, prev = prev, dict(env)
        if art.ad_idx is not None and i > art.ad_idx or \
                op.type in lowering._CONSTANT_OPS:
            return
        ins = {slot: [before[v.name] for v in vs]
               for slot, vs in op.inputs.items()}
        host = {slot: [t.detach().cpu() for t in ts]
                for slot, ts in ins.items()}
        rule = lowering.get_rule(op.type)
        with torch.no_grad():
            want = rule(host, op.attrs, ctx_on(cpu, art.amp))
        tally['ops'] += 1
        for slot, vs in op.outputs.items():
            for var, w in zip(vs, _as_list(want.get(slot))):
                if w is not None and var.name in env:
                    tally['share'] = max(tally['share'], hold(
                        '%s %s (op %d)' % (op.type, slot, i), env[var.name],
                        w))
        if op.type not in AMP_SITES:
            return
        tally['sites'] += 1
        if art.ad_idx is None:          # a step with no backward
            return
        if op.type == 'flash_attention':
            for slot, g, w in _attention_backward(
                    host, op.attrs, ctx_on(cpu, art.amp), cuda, rng):
                tally['vjp_share'] = max(tally['vjp_share'], hold(
                    '%s d%s (op %d)' % (op.type, slot, i), g, w))
            return
        out, slots = AMP_SITES[op.type]
        grads = {}
        for where, device, ts in (('card', cuda, ins), ('cpu', cpu, host)):
            leaves = {slot: [t.detach().to(device).requires_grad_(
                slot in slots) for t in vs] for slot, vs in ts.items()}
            with torch.enable_grad():
                o = rule(leaves, op.attrs, ctx_on(device, art.amp))[out]
                if where == 'card':
                    cot = torch.from_numpy(rng.randn(*o.shape).astype(
                        'float32')).to(o.dtype)
                grads[where] = torch.autograd.grad(
                    o, [t for slot in slots for t in leaves[slot]],
                    cot.to(device))
        for slot, g, w in zip(slots, grads['card'], grads['cpu']):
            # under AMP the gradient of a cast operand is rounded to bf16
            # (the cast's own gradient), whatever its dtype
            tally['vjp_share'] = max(tally['vjp_share'], hold(
                '%s d%s (op %d)' % (op.type, slot, i), g, w, art.amp))
        if control and op.type in ('mul', 'matmul'):
            with torch.no_grad():
                o32 = rule(ins, op.attrs, ctx_on(cuda, False))[out]
            tally['control_sites'] += 1
            tally['control_missed'] += not _held_to_cpu(o32, want[out])[3]

    art.debug_step(persist, dev, 0, on_op=hook)
    log('[amp] %s, op by op on the card against the CPU\'s rules on the '
        'same inputs: %d forward ops held (fp32 within %g of max |.|, bf16 '
        'within two bf16 ulps of it and at most %g of the elements on '
        'another bf16 neighbour: largest share %.4f); %d AMP sites%s; '
        'nearest the tolerance: %.3g of it at %s%s' % (
            what, tally['ops'], AMP_SITE_F32_TOL, AMP_SITE_SHARE,
            tally['share'], tally['sites'],
            ', their VJPs likewise (largest share %.4f)' % tally['vjp_share']
            if art.ad_idx is not None else ' (no backward)',
            tally['worst'][0], tally['worst'][1],
            '; the control (the products with AMP off) misses the bound at '
            '%d of %d product sites' % (tally['control_missed'],
                                        tally['control_sites'])
            if control else ''))
    if not tally['sites']:
        raise AssertionError('%s: no AMP site in the step' % what)
    if control and tally['control_missed'] != tally['control_sites']:
        raise AssertionError(
            '%s: the control (products with AMP off) passes the bound at %d '
            'of %d product sites' % (
                what, tally['control_sites'] - tally['control_missed'],
                tally['control_sites']))


def _median_rel(outs, gnames, a, b):
    """The median over the gradients of |a - b| / |b| (L2)."""
    return float(np.median([_rel_l2(outs[a][1 + i], outs[b][1 + i])
                            for i in range(len(gnames))]))


def _nudged(state, rng):
    """The fp32 arrays of `state` scaled by 1 + AMP_STATE_NOISE * noise."""
    return {n: (v * (1 + AMP_STATE_NOISE * rng.randn(*v.shape))).astype(
        v.dtype) if v.dtype == np.float32 else v for n, v in state.items()}


def _check_amp_grads_against_cpu(state):
    """Step 1 of the dropout-free twin program under decorate_program from
    the startup weights `state`, on the card and on the CPU (AMP on both):
    the loss within AMP_LOSS_TOL, the gradients' median relative L2
    difference within AMP_GRAD_SPREAD times the CPU's own spread (its step
    again from the weights nudged by AMP_STATE_NOISE). Logged beside it:
    AMP's own difference (the CPU's bf16 gradients against its fp32 ones)
    and the control (the card's fp32 step against the CPU's AMP one). Then
    the same step op by op (_ops_against_cpu), where the control must
    fail."""
    from paddle_tpu_torch import fluid
    main, _, avg_cost, names, _ = build_trainer(dropout=False)
    main32 = build_trainer(dropout=False)[0]
    fluid.amp.decorate_program(main)
    feed = _grad_check_feed(names)
    gnames = grad_names(main)
    nudged = _nudged(state, np.random.RandomState(SEED))
    outs = {}
    for where, place, prog, st in (
            ('card', fluid.CUDAPlace(0), main, state),
            ('cpu', fluid.CPUPlace(), main, state),
            ('nudged', fluid.CPUPlace(), main, nudged),
            ('cpu fp32', fluid.CPUPlace(), main32, state),
            ('card fp32', fluid.CUDAPlace(0), main32, state)):
        s = fluid.Scope()
        s.load_numpy(st, place)
        outs[where] = fluid.Executor(place).run(
            prog, feed=feed, fetch_list=[avg_cost] + gnames, scope=s)
    bad = [n for i, n in enumerate(gnames, 1)
           if not np.isfinite(outs['card'][i]).all()]
    loss, loss_cpu = float(outs['card'][0]), float(outs['cpu'][0])
    med = _median_rel(outs, gnames, 'card', 'cpu')
    spread = _median_rel(outs, gnames, 'nudged', 'cpu')
    log('[amp] step 1 from the startup weights under AMP (2 rows, dropout '
        'off): loss card %.6f, CPU %.6f (tol %g relative), CPU fp32 %.6f; '
        '%d gradients, |diff| / |grad| (L2) median: card vs CPU %.3g, the '
        'CPU\'s own spread (weights scaled by 1 + %g * noise) %.3g (tol %g '
        'x), AMP\'s own (the CPU\'s bf16 against its fp32) %.3g, the '
        'control (the card\'s fp32 step against the CPU\'s AMP one) %.3g'
        % (loss, loss_cpu, AMP_LOSS_TOL, float(outs['cpu fp32'][0]),
           len(gnames), med, AMP_STATE_NOISE, spread, AMP_GRAD_SPREAD,
           _median_rel(outs, gnames, 'cpu', 'cpu fp32'),
           _median_rel(outs, gnames, 'card fp32', 'cpu')))
    if bad or not abs(loss - loss_cpu) <= AMP_LOSS_TOL * abs(loss_cpu):
        raise AssertionError('AMP step-1 loss %r on the card, %r on the '
                             'CPU; non-finite %r' % (loss, loss_cpu, bad))
    if not med <= AMP_GRAD_SPREAD * spread:
        raise AssertionError('AMP gradients, card vs CPU: median %.3g, over '
                             '%g x the CPU\'s own %.3g'
                             % (med, AMP_GRAD_SPREAD, spread))
    _ops_against_cpu('Transformer-base step 1 (2 rows)', main, state, feed,
                     [avg_cost], control=True)


def _serve_trained(main, scope, exe):
    """The trained program's for_test clone, saved and answered through
    Predictor on the card; one row against the same artifact on the
    CPU."""
    from paddle_tpu_torch import fluid, inference
    cfg = TRANSFORMER_BASE
    test_prog = main.clone(for_test=True)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_train_') as tmp:
        fluid.io.save_inference_model(
            tmp, ['src_word', 'trg_word'], [logits_var(test_prog)], exe,
            main_program=test_prog, scope=scope)
        req = make_requests(1, 2, cfg['max_length'], cfg['trg_vocab_size'],
                            np.random.RandomState(SEED + 1))[0]
        got = inference.Predictor(tmp).run(req)[0]
        rows = req['src_word'].shape[0]
        if got.shape != (rows, cfg['max_length'], cfg['trg_vocab_size']) \
                or not np.isfinite(got).all():
            raise AssertionError('trained model answered %r' % (got.shape,))
        ref = inference.Predictor(tmp, place=fluid.CPUPlace()).run(
            {k: v[:1] for k, v in req.items()})[0]
    np.testing.assert_allclose(got[:1], ref, atol=CROSS_DEVICE_TOL,
                               rtol=CROSS_DEVICE_TOL)
    log('[training] the trained model served %d row(s) through Predictor on '
        'the card; card vs CPU on one row: max abs diff %.3g (tol %g)'
        % (rows, float(np.abs(got[:1] - ref).max()), CROSS_DEVICE_TOL))


# -- phase 5 ----------------------------------------------------------------

def first_ctr_batch():
    """The first batch of 256 rows of DeepFM's synthetic_ctr_reader."""
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.models import deepfm
    return next(batch(deepfm.synthetic_ctr_reader(tag='train'),
                      CTR_BATCH)())


def ctr_feed(rows):
    """A batch of (ids, label) rows -> {'feat_ids': [B, 26], 'label':
    [B, 1]} int64."""
    return {'feat_ids': np.stack([r[0] for r in rows]),
            'label': np.array([[r[1]] for r in rows], dtype='int64')}


def build_ctr(opt='adam', is_sparse=True):
    """deepfm.training_program: deepfm(is_sparse=...) at the model's widths
    with get_model's other settings (auc over [1 - prob, prob], batch 256),
    as the JAX package's bench.py:701-706 builds the sparse program; the
    optimizer Adam(1e-3) or Adagrad(0.01). Returns (main, startup,
    avg_cost, auc, prob)."""
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import deepfm
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        avg_cost, auc, prob, _ = deepfm.training_program(
            is_sparse=is_sparse, optimizer=opt,
            learning_rate=CTR_LR if opt == 'adam' else CTR_ADAGRAD_LR,
            embed_dim=CTR_EMBED_DIM)
    return main, startup, avg_cost, auc, prob


def _launch_counts():
    from paddle_tpu_torch import ops
    return {n: k.launches for n, k in ops.KERNELS.items()}


def _reset_launch_counts():
    from paddle_tpu_torch import ops
    for k in ops.KERNELS.values():
        k.launches = 0


def _train_ctr(exe, main, scope, fetch, feeds):
    """One exe.run per feed; returns ([fetched values per step],
    [host seconds per step])."""
    outs, secs = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
        secs.append(time.perf_counter() - t0)
    return outs, secs


def phase_ctr_training():
    """Full-width DeepFM with both FM tables is_sparse through
    Executor() on the card; returns the launch counts of its two main
    paths (sparse_adam from the Adam run, sparse_adagrad from the sparse
    Adagrad run)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.models import deepfm
    t0 = time.perf_counter()
    main, startup, avg_cost, auc, prob = build_ctr('adam')
    scope = fluid.Scope()
    exe = fluid.Executor()                      # the default place: the card
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    epoch = [ctr_feed(b) for b in batch(
        deepfm.synthetic_ctr_reader(tag='train'), CTR_BATCH)()]
    feeds = [epoch[i % len(epoch)] for i in range(CTR_STEPS)]
    log('[ctr_training] built deepfm(is_sparse=True) (26 fields, vocab %d, '
        'embed_dim %d, hidden [400, 400, 400]) + auc + Adam(%g), '
        'initialized on the card and read %d batches of %d in %.3f s'
        % (deepfm.VOCAB, CTR_EMBED_DIM, CTR_LR, len(epoch), CTR_BATCH,
           time.perf_counter() - t0))

    # 1. the main path: CTR_STEPS steps over the reader, restarted at the
    #    end of its 16-batch epoch
    _reset_launch_counts()
    outs, step_s = _train_ctr(exe, main, scope, [avg_cost, auc], feeds)
    launches = _launch_counts()
    losses = [float(o[0][0]) for o in outs]
    aucs = [float(o[1]) for o in outs]
    want = dict.fromkeys(launches, 0)
    want['sparse_adam'] = 2 * CTR_STEPS         # one per FM table and step
    if launches != want:
        raise AssertionError('DeepFM training launched %r in %d steps; the '
                             'path must launch %r'
                             % (launches, CTR_STEPS, want))
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite DeepFM loss: %r' % (losses,))
    if not all(0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError('AUC outside [0, 1]: %r' % (aucs,))
    med = float(np.median(step_s[1:]))
    log('[ctr_training] losses %s' % ', '.join('%.4f' % x for x in losses))
    log('[ctr_training] auc %s' % ', '.join('%.4f' % x for x in aucs))
    log('[ctr_training] step seconds %s'
        % ', '.join('%.4f' % x for x in step_s))
    log('[ctr_training] median step (steps 2-%d) %.4f s: %.1f examples/s; '
        'sparse_adam launches %d = 2 x %d steps'
        % (CTR_STEPS, med, CTR_BATCH / med, launches['sparse_adam'],
           CTR_STEPS))

    # 2. learning: fresh weights, one batch repeated (over the reader the
    #    loss does not fall in 20 steps: each of the 100,000 ids is seen
    #    about once)
    s2 = fluid.Scope()
    exe2 = fluid.Executor()
    exe2.run(startup, scope=s2)
    outs2, _ = _train_ctr(exe2, main, s2, [avg_cost, auc],
                          [feeds[0]] * CTR_STEPS)
    learn = [float(o[0][0]) for o in outs2]
    log('[ctr_training] one batch repeated: loss %s; auc %.4f'
        % (', '.join('%.3g' % x for x in learn), float(outs2[-1][1])))
    if not learn[-1] < CTR_LEARN_LOSS:
        raise AssertionError('the single-batch loss reached %r, not below '
                             '%g, by step %d' % (learn[-1], CTR_LEARN_LOSS,
                                                 CTR_STEPS))

    _ctr_card_against_cpu(main, avg_cost, initial, feeds)
    adagrad_launches = _ctr_adagrad_sparse_against_dense(feeds)
    launches['sparse_adagrad'] = adagrad_launches
    _serve_ctr(main, prob, scope, exe, feeds[0])
    torch.cuda.synchronize()
    return launches


def _ctr_card_against_cpu(main, avg_cost, initial, feeds):
    """CTR_COMPARE_STEPS Adam steps from the startup weights on the card
    and on the CPU (where the plain versions run): losses, both FM tables
    and their moments."""
    from paddle_tpu_torch import fluid
    runs = {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        s = fluid.Scope()
        s.load_numpy(initial, place)
        outs, _ = _train_ctr(fluid.Executor(place), main, s, [avg_cost],
                             feeds[:CTR_COMPARE_STEPS])
        runs[where] = ([float(o[0][0]) for o in outs], s.to_numpy(
            [n for n in initial if 'fm_' in n]))
    (gl, gs), (wl, ws) = runs['card'], runs['cpu']
    np.testing.assert_allclose(gl, wl, rtol=CTR_CROSS_DEVICE_TOL,
                               atol=CTR_CROSS_DEVICE_TOL)
    worst = []
    for n in sorted(ws):
        np.testing.assert_allclose(gs[n], ws[n], rtol=CTR_CROSS_DEVICE_TOL,
                                   atol=CTR_CROSS_DEVICE_TOL, err_msg=n)
        worst.append('%s %.3g' % (n, float(np.abs(gs[n] - ws[n]).max())))
    log('[ctr_training] %d Adam steps, card vs CPU from the same weights: '
        'losses %s vs %s; max abs diff %s (tol %g)'
        % (CTR_COMPARE_STEPS, ', '.join('%.6f' % x for x in gl),
           ', '.join('%.6f' % x for x in wl), ', '.join(worst),
           CTR_CROSS_DEVICE_TOL))


def _ctr_adagrad_sparse_against_dense(feeds):
    """Adagrad(0.01) with is_sparse=True against the same program with
    is_sparse=False, on the card, from the same weights and feeds; returns
    the sparse run's sparse_adagrad launches."""
    from paddle_tpu_torch import fluid
    progs = {s: build_ctr('adagrad', is_sparse=s) for s in (True, False)}
    init = fluid.Scope()
    fluid.Executor().run(progs[True][1], scope=init)
    state = init.to_numpy()
    tables, launched = {}, {}
    for sparse, (main, _, avg_cost, _, _) in progs.items():
        s = fluid.Scope()
        s.load_numpy(state, fluid.CUDAPlace(0))
        _reset_launch_counts()
        _train_ctr(fluid.Executor(), main, s, [avg_cost],
                   feeds[:CTR_COMPARE_STEPS])
        launched[sparse] = _launch_counts()
        tables[sparse] = s.to_numpy(['fm_first_w', 'fm_embed'])
    want = 2 * CTR_COMPARE_STEPS
    if launched[True]['sparse_adagrad'] != want \
            or any(launched[False].values()):
        raise AssertionError('sparse Adagrad launched %r, dense %r; the '
                             'sparse path must launch sparse_adagrad %d '
                             'times, the dense path no kernel'
                             % (launched[True], launched[False], want))
    diffs = []
    for n in ('fm_first_w', 'fm_embed'):
        np.testing.assert_allclose(tables[True][n], tables[False][n],
                                   rtol=ADAGRAD_RTOL, atol=ADAGRAD_ATOL,
                                   err_msg=n)
        diffs.append('%s %.3g' % (n, float(np.abs(
            tables[True][n] - tables[False][n]).max())))
    log('[ctr_training] Adagrad(%g), %d steps on the card, sparse vs dense: '
        'max abs diff %s (rtol %g, atol %g); sparse_adagrad launches %d = '
        '2 x %d steps, dense run: none'
        % (CTR_ADAGRAD_LR, CTR_COMPARE_STEPS, ', '.join(diffs), ADAGRAD_RTOL,
           ADAGRAD_ATOL, launched[True]['sparse_adagrad'],
           CTR_COMPARE_STEPS))
    return launched[True]['sparse_adagrad']


def _serve_ctr(main, prob, scope, exe, feed):
    """The trained program's prob, saved with save_inference_model, answers
    a request through Predictor on the card; one row against the CPU."""
    from paddle_tpu_torch import fluid, inference
    test_prog = main.clone(for_test=True)
    request = {'feat_ids': feed['feat_ids'][:8]}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ctr_') as tmp:
        fluid.io.save_inference_model(
            tmp, ['feat_ids'], [test_prog.global_block().var(prob.name)],
            exe, main_program=test_prog, scope=scope)
        got = inference.Predictor(tmp).run(request)[0]
        ref = inference.Predictor(tmp, place=fluid.CPUPlace()).run(
            {'feat_ids': request['feat_ids'][:1]})[0]
    if got.shape != (8, 1) or not np.isfinite(got).all() \
            or not ((got >= 0) & (got <= 1)).all():
        raise AssertionError('the trained DeepFM answered %r' % (got,))
    np.testing.assert_allclose(got[:1], ref, atol=CROSS_DEVICE_TOL,
                               rtol=CROSS_DEVICE_TOL)
    log('[ctr_training] the trained DeepFM served 8 rows through Predictor '
        'on the card (prob %s); card vs CPU on one row: %.7f vs %.7f'
        % (', '.join('%.4f' % x for x in got[:, 0]), float(got[0, 0]),
           float(ref[0, 0])))


# -- phase 6 ----------------------------------------------------------------

def mt_decoder_weights(seed=SEED):
    """Random weights of the machine_translation decoder at MT_DECODER's
    widths, the numpy dict DecodeEngine takes: each matrix and its bias
    N(0, 1/fan_in), so the gates do not saturate; the target embedding
    N(0, 1/E)."""
    r = np.random.RandomState(seed)
    E, D, H, V = (MT_DECODER[k] for k in ('E', 'D', 'H', 'V'))

    def normal(shape, fan_in):
        return (r.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return {'w_dec': normal((E + D, 4 * H), E + D),
            'u_dec': normal((H, 4 * H), H),
            'b_dec': normal((1, 4 * H), E + D),
            'w_q': normal((H, D), H),
            'w_emb': normal((V, E), E),
            'w_out': normal((H, V), H),
            'b_out': normal((1, V), H)}


def decode_requests(seed=SEED):
    """DECODE_REQUESTS (encoder rows [S, D], limit) pairs: S uniform in
    4-29 (the wmt14 sources, paddle_tpu/dataset/wmt14.py:14), rows
    N(0, 0.5^2), every third request one of DECODE_CANONICAL canonical
    sources (the prefix-cache mix of tools/serve_bench.py:454-464),
    limits uniform in 8-50."""
    r = np.random.RandomState(seed + 5)

    def source():
        return (r.randn(r.randint(4, 30), MT_DECODER['D']) * 0.5).astype(
            np.float32)

    canon = [source() for _ in range(DECODE_CANONICAL)]
    return [(canon[r.randint(DECODE_CANONICAL)] if i % 3 == 2 else source(),
             int(r.randint(8, DECODE_CONFIG['max_len'] + 1)))
            for i in range(DECODE_REQUESTS)]


def decode_engine_run(weights, reqs, paged=True, place=None, config=None,
                      draft=None):
    """A DecodeEngine of `config` (default DECODE_CONFIG; dense without its
    page settings), warmed up, then `reqs` burst-submitted and drained.
    Returns dict(results, seconds, stats, steps: the handle's step
    dispatches with warmup's, state_bytes, hist_free: (free, usable)
    history pages)."""
    from paddle_tpu_torch import serving
    cfg = dict(config or DECODE_CONFIG)
    if not paged:
        del cfg['page_size'], cfg['pages']
    eng = serving.DecodeEngine(weights, serving.DecodeConfig(**cfg),
                               place=place, draft=draft)
    try:
        eng.warmup()
        t0 = time.perf_counter()
        futs = [eng.submit({'enc': e}, max_new_tokens=n) for e, n in reqs]
        results = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
    finally:
        eng.shutdown()
    return dict(results=results, seconds=secs, stats=eng.stats,
                steps=eng._handle.steps, state_bytes=eng.state_bytes(),
                hist_free=(eng._hist_pool.free_count, eng._hist_pool.usable)
                if paged else None)


def _divergence(weights, enc, toks_a, toks_b, K):
    """The first step at which two token matrices [beam, L] of one request
    differ, and the gaps between the beam + 1 best candidate scores there,
    from a replay of the request alone through the dense beam step on the
    card at beam K (diagnostics for a failed comparison)."""
    import torch
    from paddle_tpu_torch.fluid.ops_impl import lod_beam
    from paddle_tpu_torch.serving.decode import WEIGHT_KEYS
    S = DECODE_CONFIG['src_cap']
    step = int(np.argmax((toks_a != toks_b).any(axis=0)))
    params = tuple(torch.from_numpy(weights[k]).cuda() for k in WEIGHT_KEYS)
    rows = np.zeros((S, enc.shape[1]), np.float32)
    rows[:enc.shape[0]] = enc
    enc_t = torch.from_numpy(rows).cuda()[None].repeat(K, 1, 1)
    mask_t = (torch.arange(S, device='cuda') < enc.shape[0]).float()[
        None].repeat(K, 1)
    carry = lod_beam.beam_init_carry(1, K, MT_DECODER['H'],
                                     DECODE_CONFIG['start_id'],
                                     device='cuda')
    seen = []
    top_k = lod_beam.top_k_lower_index
    lod_beam.top_k_lower_index = lambda x, k: (seen.append(x), top_k(x, k))[1]
    try:
        with torch.no_grad():
            for _ in range(step + 1):
                carry, _ = lod_beam.attention_beam_step(
                    params, enc_t, mask_t, carry, K,
                    DECODE_CONFIG['end_id'])
    finally:
        lod_beam.top_k_lower_index = top_k
    best = torch.sort(seen[-1][0], descending=True).values[:K + 1]
    return step, (best[:-1] - best[1:]).tolist()


def _compare_decodes(what, want, got, reqs, weights,
                     K=DECODE_CONFIG['beam_size']):
    """`got` against the paged engine on the card (`want`): equal tokens,
    scores within DECODE_SCORE_TOL * (1 + |s|). reqs[i][0] is request i's
    encoder rows. Returns the largest score difference."""
    worst = 0.0
    for i, ((tw, sw), (tg, sg)) in enumerate(zip(want, got)):
        if not np.array_equal(tw, tg):
            step, gaps = _divergence(weights, reqs[i][0], tw, tg, K)
            log('[decode] %s: request %d first differs at step %d; the '
                'gaps between its %d best candidate scores there: %s'
                % (what, i, step, len(gaps) + 1,
                   ', '.join('%.3g' % g for g in gaps)))
            raise AssertionError('%s: request %d gave other tokens than '
                                 'its reference' % (what, i))
        diff = np.abs(sg - sw)
        if not (diff <= DECODE_SCORE_TOL * (1 + np.abs(sw))).all():
            raise AssertionError('%s: request %d scores %r, its reference '
                                 '%r' % (what, i, sg, sw))
        worst = max(worst, float(diff.max()))
    return worst


def _decode_rows():
    """The paged DecodeEngine at the machine_translation decoder's full
    width on the card, fed encoder rows; returns the path's launch
    counts."""
    import torch
    from paddle_tpu_torch import fluid, obs
    weights = mt_decoder_weights()
    reqs = decode_requests()
    K = DECODE_CONFIG['beam_size']
    hists = [obs.histogram('decode.step.seconds'),
             obs.histogram('decode.ttft.seconds')]
    before = [h.snapshot() for h in hists]

    # the main path: warmup, then the burst, drained
    _reset_launch_counts()
    paged = decode_engine_run(weights, reqs)
    launches = _launch_counts()
    after = [h.snapshot() for h in hists]

    for i, ((enc, n), (toks, sc)) in enumerate(zip(reqs, paged['results'])):
        if toks.shape != (K, n) or sc.shape != (K,) \
                or not np.isfinite(sc).all():
            raise AssertionError('request %d (limit %d) resolved to %r %r'
                                 % (i, n, toks.shape, sc))
    want = dict.fromkeys(launches, 0)
    want['paged_attention'] = paged['steps']
    if launches != want:
        raise AssertionError('the paged decode launched %r over %d step '
                             'dispatches; it must launch %r'
                             % (launches, paged['steps'], want))
    free, usable = paged['hist_free']
    st = paged['stats']
    if free != usable or not st['prefix_hits'] > 0:
        raise AssertionError('after the drain %d of %d history pages are '
                             'free and %d prefix hits were counted'
                             % (free, usable, st['prefix_hits']))
    step_p = [hists[0].percentile_window(before[0], after[0], p)
              for p in (50, 99)]
    ttft_p50 = hists[1].percentile_window(before[1], after[1], 50)
    log('[decode] machine_translation decoder %s, DecodeConfig %s, '
        'state_bytes %d' % (MT_DECODER, DECODE_CONFIG, paged['state_bytes']))
    log('[decode] %d requests in %.4f s: %d tokens, %.1f tokens/s; %d step '
        'dispatches (warmup included); prefix hits %d, misses %d'
        % (len(reqs), paged['seconds'], st['tokens'],
           st['tokens'] / paged['seconds'], paged['steps'],
           st['prefix_hits'], st['prefix_misses']))
    n_steps = after[0]['count'] - before[0]['count']
    log('[decode] decode.step.seconds over %d dispatches: mean %.6f, p50 '
        '%.6f, p99 %.6f (bucket estimates); decode.ttft.seconds p50 %.6f'
        % (n_steps, (after[0]['sum'] - before[0]['sum']) / n_steps,
           step_p[0], step_p[1], ttft_p50))
    log('[decode] paged_attention launches %d = the %d step dispatches; %d '
        'of %d history pages free after the drain'
        % (launches['paged_attention'], paged['steps'], free, usable))

    # the same stream through the dense engine on the card: no kernel
    _reset_launch_counts()
    dense = decode_engine_run(weights, reqs, paged=False)
    if any(_launch_counts().values()):
        raise AssertionError('the dense decode launched %r'
                             % (_launch_counts(),))
    worst = _compare_decodes('dense engine on the card', paged['results'],
                             dense['results'], reqs, weights)
    log('[decode] dense engine on the card (no kernel, state_bytes %d): '
        'equal tokens for all %d requests, scores max abs diff %.3g (tol %g '
        'x (1 + |s|)); %.4f s, %d step dispatches'
        % (dense['state_bytes'], len(reqs), worst, DECODE_SCORE_TOL,
           dense['seconds'], dense['steps']))

    # a few requests through the paged engine on the CPU: the plain version
    sub = reqs[:DECODE_CPU_REQUESTS]
    cpu = decode_engine_run(weights, sub, place=fluid.CPUPlace())
    worst = _compare_decodes('paged engine on the CPU',
                             paged['results'][:len(sub)], cpu['results'],
                             sub, weights)
    log('[decode] paged engine on the CPU: equal tokens for %d requests, '
        'scores max abs diff %.3g (tol %g x (1 + |s|))'
        % (len(sub), worst, DECODE_SCORE_TOL))
    log('[decode] card: %s' % nvidia_smi_line())
    torch.cuda.synchronize()
    return launches


def build_generation():
    """machine_translation's generating program at get_model's widths
    (seq_to_seq_net(is_generating=True): emb, encoder and decoder 512,
    dict 30000, beam 3, max_length 50) with its startup program, seeded.
    Returns (program, startup, sentence ids, scores, the encoder output
    the beam decode attends over)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import machine_translation
    E, H, V = MT_DECODER['E'], MT_DECODER['H'], MT_DECODER['V']
    gen, startup = _program_pair()
    with fluid.unique_name.guard(), fluid.program_guard(gen, startup):
        ids, scores = machine_translation.seq_to_seq_net(
            E, H, H, V, V, is_generating=True,
            beam_size=DECODE_CONFIG['beam_size'],
            max_length=DECODE_CONFIG['max_len'])
    return gen, startup, ids, scores, _input_of(
        gen, 'attention_lstm_beam_decode', 'EncOut')


def token_sources():
    """GEN_SOURCES + 32 sources (int64 ids) of the synthetic wmt14 train
    reader at dict 30000: 4-29 ids each."""
    from paddle_tpu_torch.dataset import wmt14
    return [np.asarray(s, np.int64) for s, _, _ in itertools.islice(
        wmt14.train(MT_DECODER['V'])(), GEN_SOURCES + 32)]


def token_requests(seed=SEED):
    """DECODE_REQUESTS (index into token_sources(), limit) pairs: every
    third request one of the first DECODE_CANONICAL sources, drawn at
    random (prefix hits), the others fresh sources in order; the requests
    whose source is among the generation batch's GEN_SOURCES take the
    default limit (max_len), the rest 8-50."""
    r = np.random.RandomState(seed + 6)
    out, fresh = [], DECODE_CANONICAL
    for i in range(DECODE_REQUESTS):
        if i % 3 == 2:
            out.append((int(r.randint(DECODE_CANONICAL)), None))
        else:
            out.append((fresh, None if fresh < GEN_SOURCES else int(
                r.randint(8, DECODE_CONFIG['max_len'] + 1))))
            fresh += 1
    return out


def _generation():
    """(a) The generating program on the card: 16 sources, warm-up,
    capture, replays timed beside the eager walk; held against the same
    program on the CPU (4 sources) and against LockstepDecoder on the card
    fed the encoder's output (program_prefill over the program pruned at
    that output). Returns what (b) reuses, with the path's launch
    counts."""
    import torch
    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.fluid.lowering import map_value
    K, T = DECODE_CONFIG['beam_size'], DECODE_CONFIG['max_len']
    t0 = time.perf_counter()
    gen, startup, ids, scores, enc = build_generation()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    srcs = token_sources()
    batch = [(s.tolist(),) for s in srcs[:GEN_SOURCES]]
    feed = fluid.DataFeeder(['source_sequence'], fluid.CUDAPlace(0),
                            program=gen).feed(batch)
    if _bucket(feed) != (TOKEN_CAP,):
        raise AssertionError('the generation batch fell in bucket %r, not '
                             '%d' % (_bucket(feed), TOKEN_CAP))
    log('[decode] (a) generating program built and initialized on the card '
        'in %.3f s: %d ops, %d sources of %s ids'
        % (time.perf_counter() - t0, len(gen.global_block().ops),
           GEN_SOURCES, sorted(len(s) for s in srcs[:GEN_SOURCES])))

    _reset_launch_counts()
    base = exe.cache_stats
    outs, pool = [], 0
    for i in range(3):              # warm-up, capture, replay
        r0 = _reserved() if i == 1 else None
        outs.append(exe.run(gen, feed=feed, fetch_list=[ids, scores],
                            scope=scope))
        if i == 1:
            pool = _reserved() - r0
    launches = _launch_counts()
    stats = {k: exe.cache_stats[k] - base[k] for k in ('captures',
                                                       'replays')}
    if stats != {'captures': 1, 'replays': 2} or any(launches.values()):
        raise AssertionError('generation: %r, launches %r' % (stats,
                                                              launches))
    tok, sc = outs[-1]
    if tok.shape != (GEN_SOURCES, K, T) or tok.dtype != np.int64 \
            or sc.shape != (GEN_SOURCES, K) or not np.isfinite(sc).all() \
            or not ((tok >= 0) & (tok < MT_DECODER['V'])).all():
        raise AssertionError('generation gave %r %r %r' % (
            tok.shape, tok.dtype, sc.shape))
    if not (np.array_equal(outs[1][0], tok) and np.array_equal(
            outs[1][1], sc)):
        raise AssertionError('generation: two replays differ')
    eager_ids = [(outs[0][0][i], outs[0][1][i]) for i in range(GEN_SOURCES)]

    # the encoder's output, through the prefill (b) uses, and the lockstep
    # decode of it on the card
    weights = serving.mt_weights(scope)
    pre = serving.program_prefill(exe, gen.prune([enc]), scope,
                                  'source_sequence', enc,
                                  token_cap=TOKEN_CAP)
    rows, lens = pre([{'source_sequence': s} for s in srcs[:GEN_SOURCES]])
    reqs = [(rows[i, :lens[i]], None) for i in range(GEN_SOURCES)]
    results = [(tok[i], sc[i]) for i in range(GEN_SOURCES)]
    worst_eager = _compare_decodes('generation: the replay against its '
                                   'eager warm-up', eager_ids, results,
                                   reqs, weights)
    ls = serving.LockstepDecoder(
        weights, K, T, DECODE_CONFIG['src_cap'],
        start_id=DECODE_CONFIG['start_id'], end_id=DECODE_CONFIG['end_id'])
    ls_tok, ls_sc = ls.run(rows, lens)
    worst_ls = _compare_decodes(
        'generation: LockstepDecoder on the encoder output', results,
        [(ls_tok[i], ls_sc[i]) for i in range(GEN_SOURCES)], reqs, weights)

    art = exe.step_artifact(gen, feed=feed, fetch_list=[ids, scores],
                            scope=scope)
    state = {n: t.clone() for n, t in art.state_dict(scope).items()}
    dev = {n: map_value(lambda t: torch.as_tensor(t).cuda(), v)
           for n, v in feed.items()}
    g = torch.Generator(device='cuda')
    m = _measure('generation, %d sources' % GEN_SOURCES,
                 lambda: exe.run(gen, feed=feed, fetch_list=[ids, scores],
                                 scope=scope),
                 lambda: _to_host(art.debug_step(state, dev, 0,
                                                 generator=g)[0]),
                 pool, steps=GEN_STEPS)
    del state, dev

    # the same program on the CPU for the first sources
    t0 = time.perf_counter()
    cpu_scope = fluid.Scope()
    cpu_scope.load_numpy(scope.to_numpy(), fluid.CPUPlace())
    cpu_feed = fluid.DataFeeder(['source_sequence'], fluid.CPUPlace(),
                                program=gen).feed(batch[:GEN_CPU_SOURCES])
    c_tok, c_sc = fluid.Executor(fluid.CPUPlace()).run(
        gen, feed=cpu_feed, fetch_list=[ids, scores], scope=cpu_scope)
    del cpu_scope
    worst_cpu = _compare_decodes(
        'generation on the CPU', results[:GEN_CPU_SOURCES],
        [(c_tok[i], c_sc[i]) for i in range(GEN_CPU_SOURCES)], reqs,
        weights)
    c = m['captured']
    log('[decode] (a) generation, %d sources at beam %d, max_len %d: '
        'replayed %.4f ms a batch (median of %d), %.1f sentences/s; device '
        'busy %.4f ms, idle %.3f of the median replay; %.0f device kernels '
        'a replay; graph pool %.3f GB; eager walk %.4f ms. Replay against '
        'its eager warm-up: equal tokens, scores max abs diff %.3g; '
        'LockstepDecoder on the card fed the encoder output: equal tokens, '
        'max diff %.3g; the CPU on %d sources (%.2f s): equal tokens, max '
        'diff %.3g (tol %g x (1 + |s|)); card: %s'
        % (GEN_SOURCES, K, T, c['median_step_ms'], GEN_STEPS,
           GEN_SOURCES / c['median_step_ms'] * 1e3, c['device_busy_ms'],
           c['idle_share_of_median_step'], c['device_records_per_step'],
           c['graph_pool_gb'], m['eager']['median_step_ms'], worst_eager,
           worst_ls, GEN_CPU_SOURCES, time.perf_counter() - t0, worst_cpu,
           DECODE_SCORE_TOL, nvidia_smi_line()))
    return dict(launches=launches, results=results, weights=weights,
                srcs=srcs, pre=pre, rows=rows, lens=lens, measured=m)


def _token_decode(gen):
    """(b) The token-fed burst: the 48 requests of token_requests() as
    source ids through program_prefill (token_cap TOKEN_CAP) into the
    paged engine of DECODE_CONFIG. Returns the path's launch counts."""
    import torch
    from paddle_tpu_torch import obs, serving
    srcs, pre, K = gen['srcs'], gen['pre'], DECODE_CONFIG['beam_size']
    cfg = serving.DecodeConfig(**DECODE_CONFIG)
    example = {'source_sequence': srcs[0]}
    # each admission bucket's prefill signature: warm-up and capture
    pools = {}
    for b in cfg.admit_buckets:
        r0 = _reserved()
        for _ in range(2):
            pre([example] * b)
        pools[b] = (_reserved() - r0) / 1e9
    pf = {'sizes': [], 'device_ms': []}

    def prefill(feeds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = pre(feeds)
        end.record()
        end.synchronize()
        pf['sizes'].append(len(feeds))
        pf['device_ms'].append(start.elapsed_time(end))
        return out

    reqs = token_requests()
    hists = [obs.histogram('decode.step.seconds'),
             obs.histogram('decode.ttft.seconds')]
    _reset_launch_counts()
    eng = serving.DecodeEngine(gen['weights'], cfg, prefill=prefill)
    try:
        buckets = eng.warmup(example_feed=example)
        pf['sizes'].clear()
        pf['device_ms'].clear()
        before = [h.snapshot() for h in hists]
        t0 = time.perf_counter()
        futs = [eng.submit({'source_sequence': srcs[j]}, max_new_tokens=n)
                for j, n in reqs]
        results = [f.result(timeout=600) for f in futs]
        secs = time.perf_counter() - t0
        after = [h.snapshot() for h in hists]
    finally:
        eng.shutdown()
    launches = _launch_counts()
    steps, st = eng._handle.steps, eng.stats
    want = dict.fromkeys(launches, 0)
    want['paged_attention'] = steps
    if launches != want:
        raise AssertionError('the token-fed decode launched %r over %d step '
                             'dispatches; it must launch %r'
                             % (launches, steps, want))
    for i, ((j, n), (toks, sc)) in enumerate(zip(reqs, results)):
        if toks.shape != (K, n or DECODE_CONFIG['max_len']) \
                or not np.isfinite(sc).all():
            raise AssertionError('token request %d resolved to %r %r'
                                 % (i, toks.shape, sc))
    if eng._hist_pool.free_count != eng._hist_pool.usable \
            or not st['prefix_hits'] > 0:
        raise AssertionError('after the drain %d of %d history pages are '
                             'free and %d prefix hits were counted'
                             % (eng._hist_pool.free_count,
                                eng._hist_pool.usable, st['prefix_hits']))
    # the requests with the default limit against (a)'s sentences
    same = [i for i, (j, n) in enumerate(reqs) if n is None]
    rows, lens = gen['rows'], gen['lens']
    worst = _compare_decodes(
        'the token-fed engine against the generating program',
        [gen['results'][reqs[i][0]] for i in same],
        [results[i] for i in same],
        [(rows[reqs[i][0], :lens[reqs[i][0]]], None) for i in same],
        gen['weights'])
    ttft = hists[1].percentile_window(before[1], after[1], 50)
    n_steps = after[0]['count'] - before[0]['count']
    log('[decode] (b) token-fed burst: %d requests of source ids, prefill '
        'token_cap %d, buckets %s: %d tokens in %.4f s, %.1f tokens/s; %d '
        'step dispatches (warmup included), decode.step.seconds mean %.6f; '
        'TTFT p50 %.6f s with the prefill; %d prefill batches of %s, device '
        'ms %s (sum %.4f); prefix hits %d, misses %d; paged_attention '
        'launches %d = the step dispatches; the encoder graph pool of each '
        'prefill bucket (GB) %s; equal tokens to (a) for the %d requests of '
        'its sources at the default limit, scores max abs diff %.3g; card: '
        '%s' % (len(reqs), TOKEN_CAP, buckets, st['tokens'], secs,
                st['tokens'] / secs, steps,
                (after[0]['sum'] - before[0]['sum']) / n_steps, ttft,
                len(pf['sizes']), pf['sizes'],
                ', '.join('%.4f' % x for x in pf['device_ms']),
                sum(pf['device_ms']), st['prefix_hits'], st['prefix_misses'],
                launches['paged_attention'],
                {b: round(p, 4) for b, p in pools.items()}, len(same),
                worst, nvidia_smi_line()))
    return launches


def spec_draft_weights(seed=SEED):
    """A small weights draft for the speculative engine: target embedding
    and LSTM SPEC_DRAFT_WIDTH wide, the target's encoder rows D and vocab
    V; each matrix and bias N(0, 1/fan_in)."""
    r = np.random.RandomState(seed + 8)
    W, D, V = SPEC_DRAFT_WIDTH, MT_DECODER['D'], MT_DECODER['V']

    def normal(shape, fan_in):
        return (r.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return {'w_dec': normal((W + D, 4 * W), W + D),
            'u_dec': normal((W, 4 * W), W), 'b_dec': normal((1, 4 * W), W),
            'w_q': normal((W, D), W), 'w_emb': normal((V, W), W),
            'w_out': normal((W, V), W), 'b_out': normal((1, V), W)}


def _spec_decode():
    """(c) Speculative decoding: DecodeConfig(beam_size=1, spec_k=SPEC_K),
    paged, over the encoder-row burst with three drafts (the target
    itself, a small weights draft, a random next-token table), each held
    token for token to the beam-1 paged engine on the card. Returns the
    speculative runs' launch counts."""
    weights = mt_decoder_weights()
    reqs = decode_requests()
    cfg = dict(DECODE_CONFIG, beam_size=1)
    greedy = decode_engine_run(weights, reqs, config=cfg)
    g_st = greedy['stats']
    log('[decode] (c) beam-1 paged engine (the greedy reference): %d '
        'tokens in %.4f s, %.1f tokens/s, %d step dispatches'
        % (g_st['tokens'], greedy['seconds'],
           g_st['tokens'] / greedy['seconds'], greedy['steps']))
    table = np.random.RandomState(SEED + 9).randint(
        0, MT_DECODER['V'], MT_DECODER['V']).astype(np.int32)
    total = None
    for name, draft in (('the target itself', weights),
                        ('weights E = H = %d' % SPEC_DRAFT_WIDTH,
                         spec_draft_weights()),
                        ('a random next-token table', table)):
        _reset_launch_counts()
        run = decode_engine_run(weights, reqs, config=dict(cfg,
                                                           spec_k=SPEC_K),
                                draft=draft)
        counts = _launch_counts()
        per = (2 if isinstance(draft, dict) else 1) * (SPEC_K + 1)
        want = dict.fromkeys(counts, 0)
        want['paged_attention'] = per * run['steps']
        if counts != want:
            raise AssertionError('speculative decode (%s) launched %r over %d '
                                 'dispatches; it must launch %r'
                                 % (name, counts, run['steps'], want))
        worst = _compare_decodes('speculative decode, draft %s' % name,
                                 greedy['results'], run['results'], reqs,
                                 weights, K=1)
        st = run['stats']
        rate = st['spec_accept_rate']
        # the target as its own draft proposes what it verifies
        if not (0 < rate <= 1 if draft is weights else 0 <= rate <= 1):
            raise AssertionError('speculative decode (%s): accept rate %r'
                                 % (name, rate))
        live = run['steps'] - 2          # warmup's two no-op dispatches
        slot_steps = st['spec_proposed'] // SPEC_K
        log('[decode] (c) spec_k %d, draft %s: equal tokens to the beam-1 '
            'engine for all %d requests, scores max abs diff %.3g; accept '
            'rate %.4f (%d of %d proposals); %.3f tokens a slot a dispatch '
            '(%d tokens over %d slot-dispatches), %d dispatches against the '
            'beam-1 engine\'s %d; %.1f tokens/s against its %.1f; '
            'paged_attention %d launches = %d a dispatch x %d dispatches '
            '(warmup included)'
            % (SPEC_K, name, len(reqs), worst, rate, st['spec_accepted'],
               st['spec_proposed'], st['tokens'] / slot_steps, st['tokens'],
               slot_steps, live, greedy['steps'] - 2,
               st['tokens'] / run['seconds'],
               g_st['tokens'] / greedy['seconds'],
               counts['paged_attention'], per, run['steps']))
        total = counts if total is None else {
            k: total[k] + counts[k] for k in counts}
    log('[decode] (c) card: %s' % nvidia_smi_line())
    return total


def phase_decode():
    """Phase 6: the encoder-row burst, (a) the generating program, (b) the
    token-fed burst and (c) speculative decoding, each path's launch
    counts read just after it; returns {path: counts}."""
    import torch
    out = {'decode': _decode_rows()}
    _reset_launch_counts()
    gen = _generation()
    out['generation'] = gen['launches']
    out['token_decode'] = _token_decode(gen)
    del gen
    _reset_launch_counts()
    out['spec_decode'] = _spec_decode()
    torch.cuda.synchronize()
    return out


# -- phase 7 ----------------------------------------------------------------

def _program_pair():
    from paddle_tpu_torch.fluid import framework
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    return main, startup


def _input_of(program, op_type, slot):
    """The variable in `slot` of the program's first `op_type` op."""
    blk = program.global_block()
    return blk.var([op.input(slot)[0] for op in blk.ops
                    if op.type == op_type][0])


def _fit_a_line():
    """fit_a_line's get_model on the uci_housing reader through DataFeeder
    for FIT_EPOCHS epochs on the card; its for_test clone saved and
    answered by Predictor on the card and on the CPU."""
    import random
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import fit_a_line
    random.seed(SEED)                   # the shuffle's buffer order
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, test_prog, train_reader, test_reader, names = \
            fit_a_line.get_model()
    scope = fluid.Scope()
    exe = fluid.Executor()                      # the default place: the card
    exe.run(startup, scope=scope)
    feeder = fluid.DataFeeder([main.global_block().var(n) for n in names],
                              fluid.CUDAPlace(0), program=main)
    epochs = []
    t0 = time.perf_counter()
    for _ in range(FIT_EPOCHS):
        losses = [float(exe.run(main, feed=feeder.feed(b),
                                fetch_list=[avg_cost], scope=scope)[0][0])
                  for b in train_reader()]
        if not np.isfinite(losses).all():
            raise AssertionError('non-finite fit_a_line loss: %r'
                                 % (losses,))
        epochs.append(float(np.mean(losses)))
    train_s = time.perf_counter() - t0
    if not epochs[-1] < epochs[0] / 10:
        raise AssertionError('fit_a_line: the last epoch\'s mean loss %r is '
                             'not below a tenth of the first\'s %r'
                             % (epochs[-1], epochs[0]))
    rows = np.concatenate([feeder.feed(b)['x'] for b in test_reader()])
    with tempfile.TemporaryDirectory(prefix='chip_smoke_fit_') as tmp:
        fluid.io.save_inference_model(
            tmp, ['x'], [_input_of(test_prog, 'elementwise_sub', 'X')], exe,
            main_program=test_prog, scope=scope)
        got = inference.Predictor(tmp).run({'x': rows})[0]
        ref = inference.Predictor(tmp, place=fluid.CPUPlace()).run(
            {'x': rows})[0]
    if got.shape != (len(rows), 1):
        raise AssertionError('fit_a_line answered %r' % (got.shape,))
    np.testing.assert_allclose(got, ref, rtol=FIT_SERVE_TOL,
                               atol=FIT_SERVE_TOL)
    log('[image_training] fit_a_line: %d epochs of batch 20 (SGD 0.01) in '
        '%.3f s, mean loss by epoch %s; the for_test clone through '
        'Predictor, card vs CPU on the %d test rows: max abs diff %.3g '
        '(tol %g)' % (FIT_EPOCHS, train_s,
                      ', '.join('%.4f' % x for x in epochs), len(rows),
                      float(np.abs(got - ref).max()), FIT_SERVE_TOL))


def _mnist():
    """MNIST LeNet's get_model (batch 128, Adam 1e-3) for one epoch of the
    synthetic reader on the card; accuracy of the for_test clone on the
    test reader."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import mnist
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, test_prog, train_reader, test_reader, acc = \
            mnist.get_model()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('pixel'), blk.var('label')],
                              fluid.CUDAPlace(0), program=main)
    feeds = [feeder.feed(b) for b in train_reader()]
    losses, step_s = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[avg_cost],
                                    scope=scope)[0][0]))
        step_s.append(time.perf_counter() - t0)
    if len(losses) != MNIST_STEPS or not np.isfinite(losses).all():
        raise AssertionError('MNIST: %d steps, losses %r'
                             % (len(losses), losses))
    right = seen = 0
    for b in test_reader():
        a, = exe.run(test_prog, feed=feeder.feed(b), fetch_list=[acc.name],
                     scope=scope)
        right += float(a[0]) * len(b)
        seen += len(b)
    accuracy = right / seen
    if not accuracy >= MNIST_MIN_ACC:
        raise AssertionError('MNIST: test accuracy %.4f after one epoch, '
                             'below %g' % (accuracy, MNIST_MIN_ACC))
    log('[image_training] MNIST LeNet: %d steps of batch 128 (Adam 1e-3), '
        'loss %.4f -> %.4f, median step %.4f s; for_test accuracy on the '
        '%d test samples %.4f (min %g)'
        % (len(losses), losses[0], losses[-1], float(np.median(step_s[1:])),
           seen, accuracy, MNIST_MIN_ACC))


def build_resnet(data_format='NCHW'):
    """ResNet-50 at its full width: get_model(data_set='imagenet',
    depth=50, batch_size=32) for NCHW; for NHWC the same layer calls with
    resnet_imagenet(data_format='NHWC') and a [224, 224, 3] input (the
    same parameter names). Returns (main, startup, avg_cost, prob,
    train_reader or None)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import resnet
    main, startup = _program_pair()
    reader = None
    with unique_name.guard(), fluid.program_guard(main, startup):
        if data_format == 'NCHW':
            avg_cost, _, reader, _ = resnet.get_model(
                data_set='imagenet', depth=50, batch_size=RESNET_BATCH)
        else:
            image = fluid.layers.data(name='data', shape=[224, 224, 3])
            label = fluid.layers.data(name='label', shape=[1],
                                      dtype='int64')
            predict = resnet.resnet_imagenet(image, 1000, depth=50,
                                             data_format='NHWC')
            avg_cost = fluid.layers.mean(
                fluid.layers.cross_entropy(input=predict, label=label))
            fluid.layers.accuracy(input=predict, label=label)
            fluid.optimizer.Momentum(learning_rate=0.01,
                                     momentum=0.9).minimize(avg_cost)
    return main, startup, avg_cost, _input_of(main, 'cross_entropy', 'X'), \
        reader


def _bn_stats(program):
    """The names of every batch norm's running mean and variance."""
    out = []
    for op in program.global_block().ops:
        if op.type == 'batch_norm':
            out += [op.input('Mean')[0], op.input('Variance')[0]]
    return out


def _rel_l2(got, want):
    norm = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / norm if norm \
        else float(np.abs(got).max())


def _resnet50():
    """ResNet-50 training on the card; returns nothing, raises on a failed
    check."""
    import torch
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    main, startup, avg_cost, prob, reader = build_resnet()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('data'), blk.var('label')],
                              fluid.CUDAPlace(0), program=main)
    # the flowers reader (512 samples: 16 batches) read before the timed
    # steps, restarted at its end; images/s leaves the host reader out
    feeds = []
    while len(feeds) < RESNET_STEPS:
        feeds += [feeder.feed(b) for b in reader()
                  if len(b) == RESNET_BATCH][:RESNET_STEPS - len(feeds)]
    stats = _bn_stats(main)
    log('[image_training] ResNet-50 (get_model imagenet, depth 50, 1000 '
        'classes, Momentum(0.01, 0.9), %d batch norms): built, initialized '
        'on the card and read %d flowers batches of %d in %.3f s'
        % (len(stats) // 2, len(feeds), RESNET_BATCH,
           time.perf_counter() - t0))

    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss[0]))
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite ResNet-50 loss: %r' % (losses,))
    moved = scope.to_numpy(stats)
    still = [n for n in stats if np.array_equal(moved[n], initial[n])]
    if still:
        raise AssertionError('running stats still at their initial values '
                             'after %d steps: %r' % (RESNET_STEPS, still))
    med = float(np.median(step_s[1:]))
    log('[image_training] ResNet-50 losses %s'
        % ', '.join('%.4f' % x for x in losses))
    log('[image_training] ResNet-50 step seconds %s'
        % ', '.join('%.4f' % x for x in step_s))
    log('[image_training] ResNet-50 median step (steps 2-%d) %.4f s: %.1f '
        'images/s at batch %d (the flowers reader read beforehand, not '
        'timed); peak memory %.3f GB (torch.cuda.max_memory_allocated); '
        'card: %s' % (RESNET_STEPS, med, RESNET_BATCH / med, RESNET_BATCH,
                      peak / 1e9, nvidia_smi_line()))

    # learning: fresh weights, one batch repeated
    s2 = fluid.Scope()
    s2.load_numpy(initial, fluid.CUDAPlace(0))
    learn = [float(exe.run(main, feed=feeds[0], fetch_list=[avg_cost],
                           scope=s2)[0][0])
             for _ in range(RESNET_LEARN_STEPS)]
    log('[image_training] ResNet-50, one batch repeated %d steps from the '
        'startup weights: loss %s'
        % (RESNET_LEARN_STEPS, ', '.join('%.4f' % x for x in learn)))
    if not learn[-1] < learn[0] / 2:
        raise AssertionError('ResNet-50 on one batch: loss %r at step %d, '
                             'not below half of the first %r'
                             % (learn[-1], RESNET_LEARN_STEPS, learn[0]))
    del s2

    _card_against_cpu('ResNet-50', 'image_training', main, avg_cost,
                      initial, feeds[0], stats)
    _resnet_nhwc(initial, feeds[0], losses[0])
    _serve_resnet(main, prob, scope, exe, stats)


def _autodiff_grads(program):
    """The gradient names of `program`'s autodiff op."""
    ad = [op for op in program.global_block().ops
          if op.type == 'autodiff'][0]
    return list(ad.attrs['grad_names'])


def _load_state(scope, state, place):
    """Put {name: ndarray or tensor} into `scope` on `place`'s device; a
    tensor keeps its dtype (bf16 included)."""
    import torch
    arrays = {n: v for n, v in state.items()
              if not isinstance(v, torch.Tensor)}
    scope.load_numpy(arrays, place)
    scope.vars.update({n: v.to(place.torch_device())
                       for n, v in state.items() if n not in arrays})


def _first_steps(stats, gnames, runs, tag):
    """Step 1 of each (where, on the card?, program, loss, feed, startup
    weights) of runs(RESNET_CPU_BATCH), again at batch 1 when the CPU's
    step took over RESNET_CPU_STEP_S seconds. Returns
    (rows, {where: [loss] + gradients}, {where: running stats after the
    step}, {where: seconds})."""
    from paddle_tpu_torch import fluid
    rows = RESNET_CPU_BATCH
    while True:
        outs, after, secs = {}, {}, {}
        for where, on_card, prog, loss, feed, state in runs(rows):
            place = fluid.CUDAPlace(0) if on_card else fluid.CPUPlace()
            s = fluid.Scope()
            _load_state(s, state, place)
            t0 = time.perf_counter()
            outs[where] = fluid.Executor(place).run(
                prog, feed=feed, fetch_list=[loss] + gnames, scope=s)
            secs[where] = time.perf_counter() - t0
            after[where] = s.to_numpy(stats)
        if secs['cpu'] <= RESNET_CPU_STEP_S or rows == 1:
            return rows, outs, after, secs
        log('[%s] the CPU step at batch %d took %.1f s (over %g s): '
            'comparing at batch 1' % (tag, rows, secs['cpu'],
                                      RESNET_CPU_STEP_S))
        rows = 1


def _grad_spread(outs, gnames, a, b):
    """The median over the gradients of |a - b| / |b| (L2), and the
    largest with its name."""
    errs = sorted((_rel_l2(outs[a][1 + i], outs[b][1 + i]), n)
                  for i, n in enumerate(gnames))
    return errs[len(errs) // 2][0], errs[-1]


def _card_against_cpu(what, tag, main, avg_cost, initial, feed, stats):
    """Step 1 of image network `what` (phase `tag`) from the startup
    weights on the card and on the CPU at RESNET_CPU_BATCH rows of the
    same full-width network: the loss, every
    gradient and every running stat after the step, by relative L2; and
    the CPU's step again on the input scaled by 1 + RESNET_INPUT_NOISE *
    noise, the network's own spread under rounding-sized changes."""
    gnames = _autodiff_grads(main)
    noise = np.random.RandomState(SEED).randn(*feed['data'].shape)

    def runs(rows):
        small = {k: v[:rows] for k, v in feed.items()}
        nudged = dict(small, data=(small['data'] * (
            1 + RESNET_INPUT_NOISE * noise[:rows])).astype('float32'))
        return [('card', True, main, avg_cost, small, initial),
                ('cpu', False, main, avg_cost, small, initial),
                ('nudged', False, main, avg_cost, nudged, initial)]

    rows, outs, after, secs = _first_steps(stats, gnames, runs, tag)
    med_g, worst_g = _grad_spread(outs, gnames, 'card', 'cpu')
    med_n, worst_n = _grad_spread(outs, gnames, 'nudged', 'cpu')
    s_err = sorted((_rel_l2(after['card'][n], after['cpu'][n]), n)
                   for n in stats)
    med_s = s_err[len(s_err) // 2][0]
    loss, loss_cpu = float(outs['card'][0][0]), float(outs['cpu'][0][0])
    loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
    bad = [n for i, n in enumerate(gnames)
           if not np.isfinite(outs['card'][1 + i]).all()]
    log('[%s] %s step 1 from the startup weights, card '
        'vs CPU at batch %d (CPU step %.2f s, card %.2f s): loss %.6f vs '
        '%.6f (relative %.3g); %d running stats, |diff| / |cpu| (L2) median '
        '%.3g, max %.3g (%s), tol %g on both; %d gradients, median %.3g, '
        'max %.3g (%s), against the CPU with the input scaled by 1 + %g * '
        'noise: median %.3g, max %.3g (%s); tol on the gradients median '
        '%g x that spread'
        % (tag, what, rows, secs['cpu'], secs['card'], loss, loss_cpu,
           loss_rel,
           len(s_err), med_s, s_err[-1][0], s_err[-1][1], RESNET_GRAD_TOL,
           len(gnames), med_g, worst_g[0], worst_g[1], RESNET_INPUT_NOISE,
           med_n, worst_n[0], worst_n[1], RESNET_GRAD_SPREAD))
    if bad or not (loss_rel <= RESNET_GRAD_TOL and med_s <= RESNET_GRAD_TOL
                   and med_g <= RESNET_GRAD_SPREAD * med_n):
        raise AssertionError(
            '%s step 1, card vs CPU: loss %.3g, running stats %.3g (tol '
            '%g), gradients %.3g against the CPU\'s own %.3g (tol %g x), '
            'non-finite %r' % (what, loss_rel, med_s, RESNET_GRAD_TOL, med_g,
                               med_n, RESNET_GRAD_SPREAD, bad))


def _resnet_nhwc(initial, feed, nchw_loss):
    """One step of resnet_imagenet(data_format='NHWC') on the startup
    weights and the first batch, transposed: its loss against the NCHW
    main path's first."""
    from paddle_tpu_torch import fluid
    main, _, avg_cost, _, _ = build_resnet('NHWC')
    params = sorted(p.name for p in main.all_parameters())
    if not set(params) <= set(initial):
        raise AssertionError('the NHWC program names other parameters')
    s = fluid.Scope()
    s.load_numpy(initial, fluid.CUDAPlace(0))
    nhwc = {'data': np.ascontiguousarray(feed['data'].transpose(0, 2, 3, 1)),
            'label': feed['label']}
    loss = float(fluid.Executor().run(main, feed=nhwc, fetch_list=[avg_cost],
                                      scope=s)[0][0])
    rel = abs(loss - nchw_loss) / abs(nchw_loss)
    log('[image_training] ResNet-50 NHWC, one step from the same weights: '
        'loss %.6f vs NCHW %.6f (relative diff %.3g, tol %g)'
        % (loss, nchw_loss, rel, RESNET_NHWC_TOL))
    if not rel <= RESNET_NHWC_TOL:
        raise AssertionError('NHWC loss %r, NCHW %r' % (loss, nchw_loss))


def _serve_resnet(main, prob, scope, exe, stats):
    """The trained network's for_test clone (batch norm in test mode),
    saved and served through Predictor and ServingEngine on the card;
    answers against the same artifact on the CPU; the running stats
    bitwise unchanged by serving."""
    import torch
    from paddle_tpu_torch import fluid, inference, serving
    from paddle_tpu_torch.dataset import flowers
    test_prog = main.clone(for_test=True)
    if not all(op.attrs['is_test'] for op in test_prog.global_block().ops
               if op.type == 'batch_norm'):
        raise AssertionError('the for_test clone trains its batch norms')
    samples = list(itertools.islice(flowers.test(use_xmap=False)(), 10))
    images = np.stack([s[0] for s in samples]).reshape(-1, 3, 224, 224)
    reqs = [{'data': images[a:b]} for a, b in ((0, 1), (1, 3), (3, 6),
                                               (6, 10))]
    with tempfile.TemporaryDirectory(prefix='chip_smoke_resnet_') as tmp:
        fluid.io.save_inference_model(tmp, ['data'], [prob], exe,
                                      main_program=test_prog, scope=scope)
        pred = inference.Predictor(tmp)
        cpu = inference.Predictor(tmp, place=fluid.CPUPlace())
    before = pred._scope.to_numpy(stats)
    engine = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=8, max_queue_delay_ms=20.0))
    try:
        engine.warmup()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(engine.submit, reqs))
        answers = [f.result(timeout=600)[0] for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        engine.shutdown()
    direct = pred.run({'data': images})[0]
    after = pred._scope.to_numpy(stats)
    changed = [n for n in stats if not np.array_equal(after[n], before[n])]
    if changed:
        raise AssertionError('serving changed the running stats %r'
                             % changed)
    ref = cpu.run({'data': images})[0]
    got = np.concatenate(answers)
    if got.shape != (10, 1000) or not np.isfinite(got).all():
        raise AssertionError('ResNet-50 answered %r' % (got.shape,))
    np.testing.assert_allclose(got, direct, rtol=RESNET_SERVE_TOL,
                               atol=RESNET_SERVE_TOL)
    np.testing.assert_allclose(got, ref, rtol=RESNET_SERVE_TOL,
                               atol=RESNET_SERVE_TOL)
    torch.cuda.synchronize()
    log('[image_training] the trained ResNet-50 served %d requests (10 '
        'rows) through ServingEngine on the card in %.4f s; vs '
        'Predictor.run on the card: max abs diff %.3g; vs the CPU: %.3g '
        '(tol %g); the %d running stats bitwise unchanged after serving'
        % (len(reqs), serve_s, float(np.abs(got - direct).max()),
           float(np.abs(got - ref).max()), RESNET_SERVE_TOL, len(stats)))


def phase_image_training():
    """fit_a_line, MNIST LeNet and ResNet-50 trained through Executor() on
    the card; returns the launch counts of the kernels over the phase (its
    main path launches none of them)."""
    import torch
    _reset_launch_counts()
    _fit_a_line()
    _mnist()
    _resnet50()
    torch.cuda.synchronize()
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError('the image path launched %r' % (launches,))
    return launches


# -- phase 7b: amp -----------------------------------------------------------

_AMP_RESNETS = {}


def build_resnet_amp(data_format):
    """ResNet-50 at its full width as the JAX bench.py:215-253 builds it for
    AMP: a bfloat16 data var (NCHW [3, 224, 224] or NHWC [224, 224, 3]),
    resnet_imagenet(depth=50, class_dim=1000), the mean cross entropy (and
    accuracy, which reads the bf16 softmax through top_k),
    Momentum(0.01, 0.9), decorate_program. Returns (main, startup,
    avg_cost), built once per layout for phases 7b and 8."""
    if data_format in _AMP_RESNETS:
        return _AMP_RESNETS[data_format]
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import resnet
    main, startup = _program_pair()
    shape = [3, 224, 224] if data_format == 'NCHW' else [224, 224, 3]
    with unique_name.guard(), fluid.program_guard(main, startup):
        image = fluid.layers.data(name='data', shape=shape, dtype='bfloat16')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        predict = resnet.resnet_imagenet(image, 1000, depth=50,
                                         data_format=data_format)
        avg_cost = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        fluid.layers.accuracy(input=predict, label=label)
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(avg_cost)
        fluid.amp.decorate_program(main)
    _AMP_RESNETS[data_format] = main, startup, avg_cost
    return _AMP_RESNETS[data_format]


def amp_resnet_feeds(n):
    """n flowers batches of RESNET_BATCH through a DataFeeder of the AMP
    tower's bf16 `data` and int64 `label` (bf16 tensors, made through
    torch), read before any timed step; the NHWC twins transposed on the
    host; 'raw': the first batch as the reader gives it (fp32 NCHW images,
    labels)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.dataset import flowers
    from paddle_tpu_torch.fluid import unique_name
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        feeder = fluid.DataFeeder(
            [fluid.layers.data(name='data', shape=[3, 224, 224],
                               dtype='bfloat16'),
             fluid.layers.data(name='label', shape=[1], dtype='int64')],
            fluid.CUDAPlace(0), program=main)
    reader = batch(flowers.train(), batch_size=RESNET_BATCH)
    nchw, raw = [], None
    while len(nchw) < n:
        for b in reader():
            if len(b) != RESNET_BATCH or len(nchw) == n:
                continue
            if raw is None:
                raw = (np.stack([x for x, _ in b]).astype('float32').reshape(
                    -1, 3, 224, 224),
                       np.array([y for _, y in b], 'int64').reshape(-1, 1))
            nchw.append(feeder.feed(b))
    nhwc = [dict(f, data=f['data'].permute(0, 2, 3, 1).contiguous())
            for f in nchw]
    return {'NCHW': nchw, 'NHWC': nhwc, 'raw': raw}


def _amp_transformer():
    """Transformer-base get_model (batch 16, dropout 0.1) under
    decorate_program, TRAIN_STEPS steps on its wmt16 reader; returns the
    launch counts of that run."""
    import torch
    from paddle_tpu_torch import fluid
    cfg = TRANSFORMER_BASE
    t0 = time.perf_counter()
    main, startup, avg_cost, names, reader = build_trainer()
    fluid.amp.decorate_program(main)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    it = reader()
    feeds = [as_feed(next(it), names) for _ in range(TRAIN_STEPS)]
    log('[amp] Transformer-base get_model under decorate_program: built, '
        'initialized on the card and read %d wmt16 batches in %.3f s'
        % (TRAIN_STEPS, time.perf_counter() - t0))

    # the main path
    _reset_launch_counts()
    losses, step_s = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(loss).reshape(())))
    launches = _launch_counts()

    want = ATTENTION_OPS_PER_FORWARD * TRAIN_STEPS
    for name in ('flash_attention_fwd_bf16', 'flash_attention_bwd_dq_bf16',
                 'flash_attention_bwd_dkv_bf16'):
        if launches[name] != want:
            raise AssertionError(
                '%s launched %d times in %d AMP training steps; the path '
                'must launch it %d times per step' % (
                    name, launches[name], TRAIN_STEPS,
                    ATTENTION_OPS_PER_FORWARD))
    fp32 = {n: v for n, v in launches.items() if v and not
            n.endswith('_bf16')}
    if fp32:
        raise AssertionError('the AMP step launched fp32 kernels: %r'
                             % fp32)
    if not np.isfinite(losses).all():
        raise AssertionError('non-finite AMP training loss: %r' % (losses,))
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError('the AMP loss did not fall: %r' % (losses,))
    med = float(np.median(step_s[1:]))
    positions = TRAIN_BATCH * cfg['max_length'] * 2
    log('[amp] Transformer losses %s' % ', '.join('%.4f' % x
                                                  for x in losses))
    log('[amp] Transformer step seconds %s'
        % ', '.join('%.4f' % x for x in step_s))
    log('[amp] Transformer median step (steps 2-%d) %.4f s: %.1f source+'
        'target positions/s; launches per step: %s; card: %s'
        % (TRAIN_STEPS, med, positions / med,
           {n: v // TRAIN_STEPS for n, v in sorted(launches.items()) if v},
           nvidia_smi_line()))

    # AMP against fp32 on the card: the same program undecorated, from the
    # same weights on the same batches (the JAX tests/test_amp.py bound)
    main32, startup32, cost32, _, _ = build_trainer()
    s32 = fluid.Scope()
    exe32 = fluid.Executor()
    # the startup run keeps the run counter, which seeds dropout, in step
    # with the AMP run's
    exe32.run(startup32, scope=s32)
    s32.load_numpy(initial, fluid.CUDAPlace(0))
    fp32_losses = [float(np.asarray(exe32.run(
        main32, feed=f, fetch_list=[cost32], scope=s32)[0]).reshape(()))
        for f in feeds]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, fp32_losses))
    log('[amp] Transformer AMP against fp32 losses on the card: %s vs %s; '
        'worst relative diff %.3g (tol rtol %g, atol %g)'
        % (', '.join('%.4f' % x for x in losses),
           ', '.join('%.4f' % x for x in fp32_losses), worst,
           AMP_FP32_RTOL, AMP_FP32_ATOL))
    np.testing.assert_allclose(losses, fp32_losses, rtol=AMP_FP32_RTOL,
                               atol=AMP_FP32_ATOL)
    del s32, exe32
    _check_amp_grads_against_cpu(initial)
    torch.cuda.synchronize()
    return launches


def _amp_resnet():
    """ResNet-50 with a bf16 feed under AMP at batch 32, NHWC (bench.py's
    default) and NCHW, RESNET_STEPS steps each; returns the launch counts
    of those runs (none of the port's kernels)."""
    import torch
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    feeds = amp_resnet_feeds(RESNET_STEPS)
    log('[amp] read %d flowers batches of %d as bf16 (DataFeeder) in '
        '%.3f s' % (RESNET_STEPS, RESNET_BATCH, time.perf_counter() - t0))
    total = {}
    first = {}
    for fmt in ('NHWC', 'NCHW'):
        main, startup, avg_cost = build_resnet_amp(fmt)
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        if fmt == 'NHWC':
            # the startup weights as they are (the tower's are bf16)
            initial = {n: t.detach().cpu().clone()
                       for n, t in scope.vars.items()}
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        losses, step_s = [], []
        for feed in feeds[fmt]:
            t0 = time.perf_counter()
            loss, = exe.run(main, feed=feed, fetch_list=[avg_cost],
                            scope=scope)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss[0]))
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
        if not np.isfinite(losses).all():
            raise AssertionError('non-finite AMP ResNet-50 loss (%s): %r'
                                 % (fmt, losses))
        dtypes = sorted({str(t.dtype) for t in scope.vars.values()
                         if t.is_floating_point()})
        first[fmt] = losses[0]
        med = float(np.median(step_s[1:]))
        log('[amp] ResNet-50 %s, bf16 feed: losses %s' % (
            fmt, ', '.join('%.4f' % x for x in losses)))
        log('[amp] ResNet-50 %s step seconds %s' % (
            fmt, ', '.join('%.4f' % x for x in step_s)))
        log('[amp] ResNet-50 %s median step (steps 2-%d) %.4f s: %.1f '
            'images/s at batch %d; peak memory %.3f GB; captures %d, '
            'replays %d; floating persistables after the run: %s; card: %s'
            % (fmt, RESNET_STEPS, med, RESNET_BATCH / med, RESNET_BATCH,
               peak / 1e9, exe.cache_stats['captures'],
               exe.cache_stats['replays'], dtypes, nvidia_smi_line()))
        if exe.cache_stats['captures'] != 1:
            raise AssertionError('AMP ResNet-50 %s: %r'
                                 % (fmt, exe.cache_stats))
        # falling losses: over different flowers batches the loss swings
        # (fp32 as much, phase 7), so one batch repeated from the startup
        # weights, which must end below half its first loss
        s2 = fluid.Scope()
        exe.run(startup, scope=s2)
        learn = [float(exe.run(main, feed=feeds[fmt][0],
                               fetch_list=[avg_cost], scope=s2)[0][0])
                 for _ in range(RESNET_LEARN_STEPS)]
        log('[amp] ResNet-50 %s, one batch repeated %d steps from the '
            'startup weights: loss %s' % (fmt, RESNET_LEARN_STEPS, ', '.join(
                '%.4f' % x for x in learn)))
        if not (np.isfinite(learn).all() and learn[-1] < learn[0] / 2):
            raise AssertionError('AMP ResNet-50 %s on one batch: loss %r '
                                 'at step %d, not below half of the first '
                                 '%r' % (fmt, learn[-1], RESNET_LEARN_STEPS,
                                         learn[0]))
        del scope, s2, exe
    rel = abs(first['NHWC'] - first['NCHW']) / abs(first['NCHW'])
    log('[amp] ResNet-50 step 1 from the same startup weights: NHWC loss '
        '%.6f, NCHW %.6f (relative diff %.3g, tol %g)'
        % (first['NHWC'], first['NCHW'], rel, AMP_LAYOUT_TOL))
    if not rel <= AMP_LAYOUT_TOL:
        raise AssertionError('AMP NHWC loss %r, NCHW %r'
                             % (first['NHWC'], first['NCHW']))
    _amp_resnet_card_against_cpu(initial, *feeds['raw'])
    torch.cuda.synchronize()
    return total


def _amp_resnet_card_against_cpu(initial, images, labels):
    """Step 1 of the AMP NHWC tower from the startup weights `initial` (bf16
    as the tower declares them) on the card and on the CPU (AMP on both)
    at RESNET_CPU_BATCH rows of the first flowers batch (fp32 NCHW
    `images`, rounded to bf16 as the feed rounds them): the loss, the
    gradients and the running stats within RESNET_GRAD_SPREAD times the
    CPU's own spread (its step again with AMP_INPUT_FLIPS of the bf16
    input moved to the next bf16 value), by the median over the tensors of
    the relative L2 difference; the loss within RESNET_GRAD_SPREAD times
    the largest move of the CPU's loss over AMP_LOSS_NUDGES such steps,
    each with its own draw of the moved inputs (seeds SEED, SEED + 1,
    ...; the first is the gradients' nudge), and within one bf16 ulp at
    least (the tower computes the loss in bf16, so one nudge moves it by
    0 in about half the draws). Logged beside it: AMP's own
    difference (the fp32 tower on the CPU from the same values) and the
    control (the fp32 tower on the card). Then both layouts' steps op by
    op (_ops_against_cpu)."""
    import torch
    main, _, avg_cost = build_resnet_amp('NHWC')
    main32, _, cost32, _, _ = build_resnet('NHWC')
    gnames = _autodiff_grads(main)
    if _autodiff_grads(main32) != gnames:
        raise AssertionError('the fp32 NHWC tower has other gradients')
    if main.global_block().var(avg_cost.name).dtype != 'bfloat16':
        raise AssertionError('the AMP tower\'s loss is not bf16')
    stats = _bn_stats(main)
    # the fp32 tower's startup weights: the same values, widened
    initial32 = {n: t.to(torch.float32) if t.is_floating_point() else t
                 for n, t in initial.items()}
    flips = [np.random.RandomState(SEED + k).rand(*images.shape)
             < AMP_INPUT_FLIPS for k in range(AMP_LOSS_NUDGES)]
    nudges = ['nudged'] + ['nudged %d' % k
                           for k in range(1, AMP_LOSS_NUDGES)]

    def nhwc(x):
        return np.ascontiguousarray(x.transpose(0, 2, 3, 1))

    feeds = {}

    def runs(rows):
        x, y = images[:rows], labels[:rows]
        bf16 = torch.from_numpy(nhwc(x)).to(torch.bfloat16)
        feeds.update(bf16={'data': bf16, 'label': y},
                     fp32={'data': nhwc(x), 'label': y})
        for name, f in zip(nudges, flips):
            moved = (bf16.view(torch.int16) + torch.from_numpy(
                nhwc(f[:rows])).to(torch.int16)).view(torch.bfloat16)
            feeds[name] = {'data': moved, 'label': y}
        return [('card', True, main, avg_cost, feeds['bf16'], initial),
                ('cpu', False, main, avg_cost, feeds['bf16'], initial)] + [
                (name, False, main, avg_cost, feeds[name], initial)
                for name in nudges] + [
                ('cpu fp32', False, main32, cost32, feeds['fp32'],
                 initial32),
                ('card fp32', True, main32, cost32, feeds['fp32'],
                 initial32)]

    rows, outs, after, secs = _first_steps(stats, gnames, runs, 'amp')
    moved = int((feeds['nudged']['data'] != feeds['bf16']['data']).sum())
    med_g = _median_rel(outs, gnames, 'card', 'cpu')
    med_n = _median_rel(outs, gnames, 'nudged', 'cpu')

    def stat_spread(a, b):
        return float(np.median([_rel_l2(after[a][n], after[b][n])
                                for n in stats]))

    med_s, med_sn = stat_spread('card', 'cpu'), stat_spread('nudged', 'cpu')
    loss = {k: float(outs[k][0][0]) for k in outs}
    ulp = 2.0 ** (np.floor(np.log2(abs(loss['cpu']))) - 7)
    moves = [abs(loss[k] - loss['cpu']) for k in nudges]
    loss_tol = max(ulp, RESNET_GRAD_SPREAD * max(moves))
    log('[amp] ResNet-50 NHWC under AMP, step 1: the CPU\'s loss %.6f '
        'moved by %s under %d draws of moved bf16 inputs (seeds %d-%d); '
        'loss tolerance max(one bf16 ulp %g, %g x the largest move) = %g'
        % (loss['cpu'], ', '.join('%g' % m for m in moves), len(moves),
           SEED, SEED + len(moves) - 1, ulp, RESNET_GRAD_SPREAD, loss_tol))
    bad = [n for i, n in enumerate(gnames)
           if not np.isfinite(outs['card'][1 + i]).all()]
    log('[amp] ResNet-50 NHWC under AMP, step 1 from the startup weights, '
        'card vs CPU (AMP on both) at batch %d (CPU step %.2f s, card %.2f '
        's; the CPU\'s own spread: %d of %d bf16 inputs moved to the next '
        'bf16 value): loss %.6f vs %.6f, nudged %.6f (tol %g); %d running '
        'stats, |diff| / |cpu| (L2) median %.3g, spread %.3g; %d '
        'gradients, median %.3g, spread %.3g (tol %g x the spread on '
        'both); AMP\'s own (the fp32 tower on the CPU) %.3g, loss %.6f; '
        'the control (the fp32 tower on the card) %.3g'
        % (rows, secs['cpu'], secs['card'], moved, images[:rows].size,
           loss['card'], loss['cpu'], loss['nudged'], loss_tol, len(stats),
           med_s, med_sn, len(gnames), med_g, med_n, RESNET_GRAD_SPREAD,
           _median_rel(outs, gnames, 'cpu', 'cpu fp32'), loss['cpu fp32'],
           _median_rel(outs, gnames, 'card fp32', 'cpu')))
    if bad or not (abs(loss['card'] - loss['cpu']) <= loss_tol
                   and med_s <= RESNET_GRAD_SPREAD * med_sn
                   and med_g <= RESNET_GRAD_SPREAD * med_n):
        raise AssertionError(
            'AMP ResNet-50 step 1, card vs CPU: loss %r vs %r (tol %g), '
            'running stats %.3g against the CPU\'s own %.3g, gradients '
            '%.3g against %.3g (tol %g x), non-finite %r' % (
                loss['card'], loss['cpu'], loss_tol, med_s, med_sn, med_g,
                med_n, RESNET_GRAD_SPREAD, bad))
    _ops_against_cpu('ResNet-50 NHWC step 1 (%d rows)' % rows, main,
                     initial, feeds['bf16'], [avg_cost])
    main_nchw, _, cost_nchw = build_resnet_amp('NCHW')
    _ops_against_cpu('ResNet-50 NCHW step 1 (%d rows)' % rows, main_nchw,
                     initial, dict(feeds['bf16'], data=feeds['bf16'][
                         'data'].permute(0, 3, 1, 2).contiguous()),
                     [cost_nchw])


def transpiled_predictor(dirname, place=None):
    """A Predictor of the saved fp32 artifact, transpiled in its own scope
    by fluid.contrib.Float16Transpiler: bf16 weights, AMP, fp32
    fetches."""
    from paddle_tpu_torch import fluid, inference
    pred = inference.Predictor(dirname, place=place)
    converted = fluid.contrib.Float16Transpiler().transpile(
        pred._program, scope=pred._scope)
    if not converted:
        raise AssertionError('the transpiler converted nothing')
    return pred


def _amp_serving():
    """Transformer-base's inference artifact transpiled to bf16 behind a
    ServingEngine (max batch 16) on the card; returns the launch counts
    of the warmup and the traffic."""
    import torch
    from paddle_tpu_torch import fluid, inference, serving
    cfg = TRANSFORMER_BASE
    with tempfile.TemporaryDirectory(prefix='chip_smoke_amp_') as tmp:
        build_artifact(tmp, cfg, fluid.CUDAPlace(0))
        pred = transpiled_predictor(tmp)
        cpu = transpiled_predictor(tmp, place=fluid.CPUPlace())
        fp32 = inference.Predictor(tmp)
    engine = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=16, max_queue_delay_ms=20.0))
    reqs = make_requests(8, 4, cfg['max_length'], cfg['trg_vocab_size'],
                         np.random.RandomState(SEED + 2))
    try:
        _reset_launch_counts()
        t0 = time.perf_counter()
        buckets = engine.warmup()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(engine.submit, reqs))
        answers = [f.result(timeout=600)[0] for f in futs]
        serve_s = time.perf_counter() - t0
        launches = _launch_counts()
        stats = engine.stats
    finally:
        engine.shutdown()
    runs = serving.engine.WARMUP_RUNS * len(buckets) + stats['batches']
    want = ATTENTION_OPS_PER_FORWARD * runs
    if launches['flash_attention_fwd_bf16'] != want or \
            launches['flash_attention_fwd']:
        raise AssertionError('bf16 serving launched %r for %d forwards; '
                             'the path must launch the bf16 forward %d '
                             'times per forward and no fp32 one'
                             % (launches, runs, ATTENTION_OPS_PER_FORWARD))
    worst = 0.0
    for req, ans in zip(reqs, answers):
        n = req['src_word'].shape[0]
        if ans.dtype != np.float32 or ans.shape != (
                n, cfg['max_length'], cfg['trg_vocab_size']) or \
                not np.isfinite(ans).all():
            raise AssertionError('bf16 serving answered %s %r'
                                 % (ans.dtype, ans.shape))
        worst = max(worst, _rel_l2(ans, pred.run(req)[0]))
    if not worst <= AMP_CROSS_DEVICE_TOL:
        raise AssertionError('bf16 engine answers against Predictor.run: '
                             '%.3g (tol %g)' % (worst, AMP_CROSS_DEVICE_TOL))
    small = {k: v[:1] for k, v in reqs[0].items()}
    ref = cpu.run(small)[0]
    diff = _rel_l2(answers[0][:1], ref)
    control = _rel_l2(fp32.run(small)[0], ref)
    log('[amp] bf16 serving (Float16Transpiler in the Predictor\'s scope): '
        'warmup over buckets %s %.3f s; %d requests in %d batch(es) in '
        '%.4f s; fp32 answers; vs Predictor.run: |diff| / |logits| (L2) '
        '%.3g; card vs CPU on one row: %.3g, max abs diff %.3g (|logits| '
        'max %.3g; tol %g on both); the control, the fp32 artifact on the '
        'card against the CPU\'s bf16 answer: %.3g; '
        'flash_attention_fwd_bf16 launches %d = %d x %d forwards'
        % (buckets, warm_s, len(reqs), stats['batches'], serve_s, worst,
           diff, float(np.abs(answers[0][:1] - ref).max()),
           float(np.abs(ref).max()), AMP_CROSS_DEVICE_TOL, control,
           launches['flash_attention_fwd_bf16'], ATTENTION_OPS_PER_FORWARD,
           runs))
    if not diff <= AMP_CROSS_DEVICE_TOL:
        raise AssertionError('bf16 serving, card vs CPU: %.3g' % diff)
    if not control > AMP_CROSS_DEVICE_TOL:
        raise AssertionError('the control (the fp32 artifact) passes the '
                             'bf16 serving bound: %.3g' % control)
    _ops_against_cpu('bf16 serving, one row', pred._program,
                     dict(pred._scope.vars), small, pred._fetch_vars)
    torch.cuda.synchronize()
    return launches


def phase_amp():
    """AMP on the card through the entry points: Transformer-base training
    and ResNet-50 (bf16 feed, NHWC and NCHW) training under
    decorate_program, and bf16 serving through Float16Transpiler; returns
    {path: launch counts} for amp_training and amp_serving."""
    train = _amp_transformer()
    for n, v in _amp_resnet().items():
        train[n] += v
    _between_phases('amp serving')
    return {'amp_training': train, 'amp_serving': _amp_serving()}


# -- phase 7c: the dense training surface -----------------------------------

def _drop_free(program):
    """`program` with every dropout's probability set to 0 (the same
    parameters and ops): the card and the CPU draw other masks, so the
    step-1 comparison runs the network without them."""
    for op in program.global_block().ops:
        if op.type == 'dropout':
            op.attrs['dropout_prob'] = 0.0
    return program


def build_vgg(dropout=True):
    """VGG-16 as benchmark/fluid_benchmark.py builds it: vgg.get_model()
    (cifar10, 3x32x32, batch 32, Adam(1e-3), vgg16_bn_drop's dropouts).
    Returns (main, startup, avg_cost, train_reader)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import vgg
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, reader, _, _ = vgg.get_model(batch_size=VGG_BATCH)
    return (main if dropout else _drop_free(main)), startup, avg_cost, reader


def build_se_resnext(dropout=True):
    """SE-ResNeXt-50 at se_resnext.get_model()'s defaults (3x224x224,
    batch 16, 102 classes, cardinality 32, reduction 16, Momentum(0.01,
    0.9)); returns as build_vgg."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import se_resnext
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, reader, _, _ = se_resnext.get_model(batch_size=SE_BATCH)
    return (main if dropout else _drop_free(main)), startup, avg_cost, reader


def _image_feeds(main, reader, batch, n):
    """n full batches of a batched image reader through the DataFeeder on
    the card, read whole passes at a time (restarted at its end), before
    any step is timed."""
    from paddle_tpu_torch import fluid
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('data'), blk.var('label')],
                              fluid.CUDAPlace(0), program=main)
    feeds = []
    while len(feeds) < n:
        feeds += [feeder.feed(b) for b in reader()
                  if len(b) == batch][:n - len(feeds)]
    return feeds


def _top_kernels(step, n):
    """torch.profiler over n calls of step(): the device's busy ms per
    step (tools/torch_train_profile.py's busy_us), the traced wall ms per
    step, and the DENSE_TOP_KERNELS kernels that take the most device
    time, [(name, ms per step)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # by its path: tools/ is no package, and another `tools` may be
    # installed
    spec = importlib.util.spec_from_file_location(
        'torch_train_profile', os.path.join(os.path.dirname(
            os.path.abspath(__file__)), 'tools', 'torch_train_profile.py'))
    profile_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_tool)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / n
    by_name, spans = {}, []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not evt.is_user_annotation:
            by_name[evt.name] = by_name.get(evt.name, 0.0) \
                + evt.time_range.elapsed_us()
            spans.append((evt.time_range.start, evt.time_range.end))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:DENSE_TOP_KERNELS]
    return profile_tool.busy_us(spans) / 1e3 / n, traced, \
        [(k[:80], v / 1e3 / n) for k, v in top]


def _dense_model(what, build, batch, learn_steps, one_batch):
    """`what` trained DENSE_STEPS captured steps through Executor() on its
    reader's batches, read beforehand: finite losses, one capture and the
    rest replays, the median step, images/s, peak memory and the top
    device kernels. The loss falling (the mean of the last DENSE_WINDOW
    below the mean of the first DENSE_WINDOW) over `learn_steps` steps:
    the reader's batches, training on from step DENSE_STEPS; or with
    `one_batch` the first batch repeated from the startup weights
    (flowers' synthetic labels are independent of its images). Step 1
    against the CPU on the dropout-free program. Returns a record of the
    numbers."""
    import torch
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    main, startup, avg_cost, reader = build()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    feeds = _image_feeds(main, reader, batch, PROFILED_STEPS + max(
        DENSE_STEPS, 1 if one_batch else learn_steps))
    log('[dense_training] %s: built, initialized on the card and read %d '
        'batches of %d in %.3f s' % (what, len(feeds), batch,
                                     time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for feed in feeds[:DENSE_STEPS]:
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss[0]))
    peak = torch.cuda.max_memory_allocated()
    stats = exe.cache_stats
    if not np.isfinite(losses).all():
        raise AssertionError('%s: non-finite loss %r' % (what, losses))
    # the first step warms up, the second captures and replays
    if stats['captures'] != 1 or stats['replays'] != DENSE_STEPS - 1:
        raise AssertionError('%s: %r over %d steps, not one capture and '
                             'replays after it' % (what, stats, DENSE_STEPS))
    it = iter(feeds[-PROFILED_STEPS:])
    busy, traced, top = _top_kernels(lambda: exe.run(
        main, feed=next(it), fetch_list=[avg_cost], scope=scope),
        PROFILED_STEPS)
    med = float(np.median(step_s[2:]))
    mean = float(np.mean(step_s[2:]))
    rec = dict(model=what, batch=batch, losses=losses, step_s=step_s,
               median_captured_step_s=med, mean_captured_step_s=mean,
               images_per_s=batch / med,
               peak_memory_gb=peak / 1e9, device_busy_ms_per_step=busy,
               traced_wall_ms_per_step=traced,
               device_idle_share_of_traced_wall=1.0 - busy / traced,
               top_device_kernels_ms_per_step=top, card=nvidia_smi_line())
    log('[dense_training] %s losses %s' % (what, ', '.join(
        '%.4f' % x for x in losses)))
    log('[dense_training] %s step seconds %s' % (what, ', '.join(
        '%.4f' % x for x in step_s)))
    log('[dense_training] %s median captured step (steps 3-%d, replays) '
        '%.4f s: %.1f images/s at batch %d (mean %.4f s: %.1f images/s); '
        'peak memory %.3f GB; device '
        'busy %.3f ms a step over %d traced replays of %.3f ms (idle %.3f '
        'of the traced wall); top device kernels (ms a step) %s; card: %s'
        % (what, DENSE_STEPS, med, batch / med, batch, mean, batch / mean,
           peak / 1e9, busy,
           PROFILED_STEPS, traced, rec['device_idle_share_of_traced_wall'],
           '; '.join('%s %.3f' % kv for kv in top), rec['card']))
    if one_batch:
        s2 = fluid.Scope()
        s2.load_numpy(initial, fluid.CUDAPlace(0))
        learn = [float(exe.run(main, feed=feeds[0], fetch_list=[avg_cost],
                               scope=s2)[0][0]) for _ in range(learn_steps)]
        how = 'the first batch repeated %d steps from the startup weights' \
            % learn_steps
        del s2
    else:
        # the profiled steps trained on too: the reader's batches from
        # DENSE_STEPS + PROFILED_STEPS on
        learn = losses + [float(exe.run(
            main, feed=f, fetch_list=[avg_cost], scope=scope)[0][0])
            for f in feeds[DENSE_STEPS + PROFILED_STEPS:learn_steps
                           + PROFILED_STEPS]]
        how = '%d steps of the reader (the %d profiled steps not counted)' \
            % (len(learn), PROFILED_STEPS)
    log('[dense_training] %s, %s: loss %s' % (what, how, ', '.join(
        '%.4f' % x for x in learn)))
    rec['falling_losses'] = learn
    if not np.mean(learn[-DENSE_WINDOW:]) < np.mean(learn[:DENSE_WINDOW]):
        raise AssertionError('%s: the loss did not fall: %r' % (what, learn))
    del exe, scope
    main0, _, cost0, _ = build(dropout=False)
    _card_against_cpu(what, 'dense_training', main0, cost0, initial,
                      feeds[0], _bn_stats(main0))
    return rec


def surface_program(opt, kw, schedule):
    """MNIST LeNet (mnist.cnn_model, batch SURFACE_BATCH) under optimizer
    `opt`, its learning rate from `schedule` (decay_steps 2),
    GradientClipByNorm(SURFACE_CLIP_NORM) on every parameter and, for
    Momentum, LARS_weight_decay with append_LARS's rates fetched. Returns
    (main, startup, fetch list)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import mnist
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        images = fluid.layers.data(name='pixel', shape=[1, 28, 28])
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        predict = mnist.cnn_model(images)
        avg_cost = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByNorm(SURFACE_CLIP_NORM))
        lr = kw['learning_rate']
        layers = fluid.layers
        if schedule == 'piecewise_decay':
            sched = layers.piecewise_decay([2, 4], [lr, lr / 2, lr / 4])
        elif schedule == 'polynomial_decay':
            sched = layers.polynomial_decay(lr, 2, end_learning_rate=lr / 10,
                                            cycle=True)
        else:
            sched = getattr(layers, schedule)(lr, 2, 0.5, staircase=True)
        _, pg = getattr(fluid.optimizer, opt)(
            **dict(kw, learning_rate=sched)).minimize(avg_cost)
        fetch = [avg_cost]
        if kw.get('LARS_weight_decay'):
            fetch += layers.append_LARS(pg, lr, kw['LARS_weight_decay'])
    return main, startup, fetch


def _surface_feeds():
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.dataset import mnist
    rows = list(itertools.islice(batch(mnist.train(), SURFACE_BATCH)(),
                                 SURFACE_STEPS + 1))
    return [{'pixel': np.stack([r[0] for r in b]).reshape(
        -1, 1, 28, 28).astype('float32'),
             'label': np.array([[r[1]] for r in b], dtype='int64')}
            for b in rows]


def _surface_run(opt, kw, schedule, feeds):
    """SURFACE_STEPS steps of the surface program on the card (a warm-up,
    the capture, replays) and eagerly on the CPU from the same startup
    state; the fetches (loss, LARS rates) and every persistable held to
    SURFACE_TOL by relative L2. Returns the record."""
    from paddle_tpu_torch import fluid
    main, startup, fetch = surface_program(opt, kw, schedule)
    init_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init_scope)
    initial = init_scope.to_numpy()
    outs, state = {}, {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        scope = fluid.Scope()
        scope.load_numpy(initial, place)
        exe = fluid.Executor(place)
        outs[where] = [[np.asarray(a) for a in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)]
            for f in feeds[:SURFACE_STEPS]]
        state[where] = scope.to_numpy(sorted(initial))
        if where == 'card':
            stats = exe.cache_stats
    if stats['captures'] != 1 or stats['replays'] != SURFACE_STEPS - 1:
        raise AssertionError('%s: %r' % (opt, stats))
    fetch_err = max(_rel_l2(c, p) for sc, sp in zip(outs['card'],
                                                     outs['cpu'])
                    for c, p in zip(sc, sp))
    state_err = sorted((_rel_l2(state['card'][n], state['cpu'][n]), n)
                       for n in initial)
    moved = sum(not np.array_equal(state['cpu'][n], initial[n])
                for n in initial)
    losses = [float(o[0][0]) for o in outs['card']]
    log('[dense_training] LeNet, %s(%s) with %s and GradientClipByNorm(%g)'
        ', %d steps (warm-up, capture, replays) on the card against the '
        'CPU from one state: losses %s; fetches (loss%s) relative L2 max '
        '%.3g; %d persistables (%d moved), relative L2 max %.3g (%s); tol '
        '%g' % (opt, ', '.join('%s=%g' % kv for kv in sorted(kw.items())),
                schedule, SURFACE_CLIP_NORM, SURFACE_STEPS,
                ', '.join('%.5f' % x for x in losses),
                ', %d LARS rates' % (len(fetch) - 1) if len(fetch) > 1
                else '', fetch_err, len(initial), moved, state_err[-1][0],
                state_err[-1][1], SURFACE_TOL))
    if not (np.isfinite(losses).all() and fetch_err <= SURFACE_TOL
            and state_err[-1][0] <= SURFACE_TOL):
        raise AssertionError('%s on the card against the CPU: fetches '
                             '%.3g, persistables %.3g (%s), tol %g'
                             % (opt, fetch_err, state_err[-1][0],
                                state_err[-1][1], SURFACE_TOL))
    return dict(optimizer=opt, schedule=schedule, losses=losses,
                fetch_rel_l2=fetch_err, state_rel_l2=state_err[-1][0])


def _model_average(feeds):
    """ModelAverage on the LeNet surface path (Momentum with an
    exponential decay), captured, under cudnn.deterministic: SURFACE_STEPS
    steps with accumulate() after each, beside a twin scope that does not
    average; apply() puts the mean of the steps' weights in the scope's
    own tensors (against the host's mean of copies taken after each step,
    1e-6), restore() puts the trained ones back bitwise, and the next
    replay is bitwise the twin's: loss and every persistable."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    main, startup, fetch = surface_program(
        'Momentum', dict(learning_rate=0.01, momentum=0.9),
        'exponential_decay')
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg = fluid.optimizer.ModelAverage(0.15)
    names = sorted(p.name for p, _ in avg.params_grads)
    torch.backends.cudnn.deterministic = True
    try:
        exe = fluid.Executor()
        scope, twin = fluid.Scope(), fluid.Scope()
        exe.run(startup, scope=scope)
        twin.load_numpy(scope.to_numpy(), fluid.CUDAPlace(0))
        taken = []
        with fluid.scope_guard(scope):
            for f in feeds[:SURFACE_STEPS]:
                exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                avg.accumulate(exe)
                exe.run(main, feed=f, fetch_list=fetch, scope=twin)
                taken.append(scope.to_numpy(names))
            held = {n: scope.vars[n] for n in names}
            trained = scope.to_numpy(names)
            with avg.apply(exe):
                applied = scope.to_numpy(names)
                in_place = all(scope.vars[n] is held[n] for n in names)
        restored = scope.to_numpy(names)
        loss, = exe.run(main, feed=feeds[SURFACE_STEPS], fetch_list=fetch,
                        scope=scope)
        want, = exe.run(main, feed=feeds[SURFACE_STEPS], fetch_list=fetch,
                        scope=twin)
        stats = exe.cache_stats
        after, twin_after = scope.to_numpy(), twin.to_numpy()
    finally:
        torch.backends.cudnn.deterministic = False
    mean_err = max(_rel_l2(applied[n], np.mean([t[n] for t in taken], 0))
                   for n in names)
    same = all(np.array_equal(restored[n], trained[n]) for n in names)
    replay_same = np.array_equal(loss, want) and all(
        np.array_equal(after[n], twin_after[n]) for n in after)
    log('[dense_training] ModelAverage on LeNet (Momentum, captured, '
        'cudnn.deterministic), %d parameters over %d steps: apply() %s the '
        'mean of the steps\' weights in the scope\'s own tensors '
        '(relative L2 %.3g, tol 1e-6); restore() %s the trained weights '
        'bitwise; the replay after restore() %s the twin\'s without the '
        'averaging, loss and %d persistables bitwise; %r'
        % (len(names), SURFACE_STEPS, 'put' if in_place else 'did NOT put',
           mean_err, 'gave back' if same else 'did NOT give back',
           'equals' if replay_same else 'DIFFERS from', len(after), stats))
    if not (in_place and mean_err <= 1e-6 and same and replay_same
            and stats['replays'] > 0):
        raise AssertionError('ModelAverage on the card failed its checks')


def _nets_attention():
    """nets.scaled_dot_product_attention at NETS_ATTENTION (B 16, T 256,
    8 heads, D 64: hidden 512): one flash_attention op. Its for_test
    clone's forward once, then NETS_ATTENTION_STEPS training steps (SGD),
    through Executor() on the card: the attention kernels' launches (one
    forward per forward, one of each backward per step), the forward's
    output and the losses against the CPU, and the q, k and v projections'
    updates (the weights dQ, dK and dV reach) against the CPU's by
    relative L2. Returns the launch counts."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    c = NETS_ATTENTION
    hidden = c['H'] * c['D']
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        q, k, v = (fluid.layers.data(name=n, shape=[c['T'], hidden])
                   for n in ('q', 'k', 'v'))
        ctx = fluid.nets.scaled_dot_product_attention(q, k, v,
                                                      num_heads=c['H'])
        loss = fluid.layers.mean(fluid.layers.square(ctx))
        test = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=NETS_ATTENTION_LR).minimize(loss)
    if [op.type for op in main.global_block().ops].count(
            'flash_attention') != 1:
        raise AssertionError('nets attention: not one flash_attention op')
    rng = np.random.RandomState(SEED)
    feeds = [{n: rng.randn(c['B'], c['T'], hidden).astype('float32')
              for n in ('q', 'k', 'v')} for _ in range(NETS_ATTENTION_STEPS)]
    init_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init_scope)
    initial = init_scope.to_numpy()
    outs = {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        scope = fluid.Scope()
        scope.load_numpy(initial, place)
        exe = fluid.Executor(place)
        if where == 'card':
            torch.cuda.synchronize()
            _reset_launch_counts()
        fwd, = exe.run(test, feed=feeds[0], fetch_list=[ctx], scope=scope)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0][0]) for f in feeds]
        if where == 'card':
            torch.cuda.synchronize()
            launches = _launch_counts()
        after = scope.to_numpy()
        outs[where] = (np.asarray(fwd), losses, {
            n: after[n].astype('float64') - initial[n]
            for n in initial if n.endswith('.w_0')})
    err = float(np.abs(outs['card'][0] - outs['cpu'][0]).max())
    scale = float(np.abs(outs['cpu'][0]).max())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(outs['card'][1],
                                                      outs['cpu'][1]))
    upd_err = {w: _rel_l2(outs['card'][2][w], outs['cpu'][2][w])
               for w in outs['cpu'][2]}
    n = NETS_ATTENTION_STEPS
    want = {'flash_attention_fwd': n + 1, 'flash_attention_bwd_dq': n,
            'flash_attention_bwd_dkv': n}
    log('[dense_training] nets.scaled_dot_product_attention (B %d, T %d, '
        '%d heads, D %d): for_test forward card vs CPU max abs err %.3g '
        '(max |out| %.3g, tol %g x max(1, max |out|)); %d SGD steps, losses '
        '%s, card vs CPU relative %.3g (tol %g); q, k, v projections\' '
        'updates card vs CPU relative L2 %s (tol %g); launches %r'
        % (c['B'], c['T'], c['H'], c['D'], err, scale, KERNEL_TOL, n,
           ', '.join('%.6f' % x for x in outs['card'][1]), loss_rel,
           CROSS_DEVICE_TOL, ', '.join('%s %.3g' % kv for kv in sorted(
               upd_err.items())), NETS_UPDATE_TOL,
           {k: v for k, v in launches.items() if v}))
    if not (err <= KERNEL_TOL * max(1.0, scale)
            and loss_rel <= CROSS_DEVICE_TOL
            and len(upd_err) == 3
            and max(upd_err.values()) <= NETS_UPDATE_TOL
            and {k: v for k, v in launches.items() if v} == want):
        raise AssertionError('nets attention: err %.3g, losses %.3g, '
                             'updates %r, launches %r (want %r)'
                             % (err, loss_rel, upd_err, launches, want))
    return launches


def phase_dense_training():
    """VGG-16 and SE-ResNeXt-50 training, the optimizer surface on LeNet
    (five optimizers and Momentum with LARS, each with a scheduler and
    GradientClipByNorm), ModelAverage, and nets.scaled_dot_product_
    attention; returns {path: launch counts}: dense_training (VGG,
    SE-ResNeXt and the optimizer surface, which launch none of the port's
    kernels) and nets_attention."""
    import torch
    _reset_launch_counts()
    records = [_dense_model('VGG-16', build_vgg, VGG_BATCH,
                            VGG_LEARN_STEPS, False),
               _dense_model('SE-ResNeXt-50', build_se_resnext, SE_BATCH,
                            SE_LEARN_STEPS, True)]
    feeds = _surface_feeds()
    for i, (opt, kw) in enumerate(SURFACE_OPTIMIZERS):
        records.append(_surface_run(opt, kw, SURFACE_SCHEDULES[i % len(
            SURFACE_SCHEDULES)], feeds))
    _model_average(feeds)
    torch.cuda.synchronize()
    dense = _launch_counts()
    if any(dense.values()):
        raise AssertionError('the dense training path launched %r' % dense)
    log(json.dumps({'dense_training': records}))
    return {'dense_training': dense, 'nets_attention': _nets_attention()}


# -- phase 7d -----------------------------------------------------------------

def build_stacked_lstm():
    """stacked_dynamic_lstm.get_model(): batch 32, emb 512, lstm 512,
    vocab 5147, Adam. Returns (main, startup, avg_cost, train_reader,
    feed names, the for_test program and its class probabilities)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import stacked_dynamic_lstm
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, test, reader, _, _ = stacked_dynamic_lstm.get_model()
    return main, startup, loss, reader, ['words', 'label'], test, \
        _last_softmax(test)


def build_sentiment():
    """understand_sentiment.get_model(): batch 32, emb 32, hid 32,
    Adagrad(0.002); its for_test program a clone of the main program (the
    builder returns none)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import understand_sentiment
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, _, reader, _, names = understand_sentiment.get_model()
    test = main.clone(for_test=True)
    return main, startup, loss, reader, names, test, _last_softmax(test)


def build_mt():
    """machine_translation.get_model(): batch 16, emb, encoder and decoder
    512, dict 30000, Adam(2e-4); the training program only."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import machine_translation
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, _, reader, _, names = machine_translation.get_model()
    return main, startup, loss, reader, names, None, None


def _last_softmax(program):
    return [op for op in program.global_block().ops
            if op.type == 'softmax'][-1].outputs['Out'][0].name


def _seq_feeds(feed):
    """The sequence (SeqValue) entries of a feed, by name."""
    from paddle_tpu_torch.fluid.lowering import SeqValue
    return {n: v for n, v in feed.items() if isinstance(v, SeqValue)}


def _bucket(feed):
    """The padded time axis of each sequence feed: the step signature a
    batch selects."""
    return tuple(int(v.data.shape[1]) for _, v in sorted(
        _seq_feeds(feed).items()))


def _valid_tokens(feed, names):
    """The valid ids of a batch's input sequences (the label sequence of
    machine_translation not counted)."""
    return sum(int(v.lengths.sum()) for n, v in _seq_feeds(feed).items()
               if n in names and n != 'label_sequence')


def _sequence_card_against_cpu(what, main, avg_cost, initial, feed,
                                tag='sequences'):
    """Step 1 from the startup weights on the card and on the CPU at
    SEQ_CPU_BATCH sequences, and on the CPU again from the weights nudged
    by AMP_STATE_NOISE: the loss within SEQ_LOSS_TOL, the gradients'
    median relative L2 within SEQ_GRAD_SPREAD x the nudged spread."""
    from paddle_tpu_torch import fluid
    gnames = _autodiff_grads(main)
    nudged = _nudged(initial, np.random.RandomState(SEED))
    outs, secs = {}, {}
    for where, place, state in (('card', fluid.CUDAPlace(0), initial),
                                ('cpu', fluid.CPUPlace(), initial),
                                ('nudged', fluid.CPUPlace(), nudged)):
        s = fluid.Scope()
        s.load_numpy(state, place)
        t0 = time.perf_counter()
        outs[where] = fluid.Executor(place).run(
            main, feed=feed, fetch_list=[avg_cost] + gnames, scope=s)
        secs[where] = time.perf_counter() - t0
    med_g, worst_g = _grad_spread(outs, gnames, 'card', 'cpu')
    med_n, worst_n = _grad_spread(outs, gnames, 'nudged', 'cpu')
    loss = {k: float(np.asarray(v[0]).reshape(-1)[0])
            for k, v in outs.items()}
    loss_rel = abs(loss['card'] - loss['cpu']) / abs(loss['cpu'])
    bad = [n for i, n in enumerate(gnames)
           if not np.isfinite(outs['card'][1 + i]).all()]
    log('[%s] %s step 1 from the startup weights, card vs CPU at %d '
        'rows (CPU step %.2f s, card %.2f s): loss %.6f vs %.6f '
        '(relative %.3g, tol %g), nudged %.6f; %d gradients, |diff| / '
        '|cpu| (L2) median %.3g, max %.3g (%s); the CPU\'s own with the '
        'startup weights scaled by 1 + %g * noise: median %.3g, max %.3g '
        '(%s); tol %g x that spread'
        % (tag, what, SEQ_CPU_BATCH, secs['cpu'], secs['card'], loss['card'],
           loss['cpu'], loss_rel, SEQ_LOSS_TOL, loss['nudged'], len(gnames),
           med_g, worst_g[0], worst_g[1], AMP_STATE_NOISE, med_n,
           worst_n[0], worst_n[1], SEQ_GRAD_SPREAD))
    if bad or not (loss_rel <= SEQ_LOSS_TOL
                   and med_g <= SEQ_GRAD_SPREAD * med_n):
        raise AssertionError(
            '%s step 1, card vs CPU: loss %.3g (tol %g), gradients %.3g '
            'against the CPU\'s own %.3g (tol %g x), non-finite %r'
            % (what, loss_rel, SEQ_LOSS_TOL, med_g, med_n, SEQ_GRAD_SPREAD,
               bad))
    return dict(loss_rel=loss_rel, grad_median_rel_l2=med_g,
                cpu_spread_median_rel_l2=med_n)


def _serve_sequences(what, test, prob, scope, exe, samples):
    """The trained for_test clone saved with save_inference_model and
    served through Predictor on the card (three calls of one LoDTensor
    request: warm-up, capture, replay) and on the CPU: the class
    probabilities within SEQ_SERVE_TOL of max(1, |p|)."""
    from paddle_tpu_torch import fluid, inference
    words = [s[0] for s in samples[:SEQ_SERVE_ROWS]]
    req = {'words': fluid.LoDTensor(
        np.concatenate(words).reshape(-1, 1).astype('int64'),
        [[len(w) for w in words]])}
    with tempfile.TemporaryDirectory() as d:
        fluid.io.save_inference_model(
            d, ['words'], [test.global_block().var(prob)], exe,
            main_program=test, scope=scope)
        card = inference.Predictor(d)
        got = [card.run(req)[0] for _ in range(3)]
        want = inference.Predictor(d, place=fluid.CPUPlace()).run(req)[0]
        stats = card._exe.cache_stats
    err = float(np.abs(got[-1] - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    same = all(np.array_equal(g, got[0]) for g in got)
    log('[sequences] %s for_test clone through Predictor with a LoDTensor '
        'of %d sequences (lengths %s): card vs CPU max abs err %.3g (tol %g '
        'x %g); three card calls %s; %r'
        % (what, len(words), [len(w) for w in words], err, SEQ_SERVE_TOL,
           scale, 'bitwise equal' if same else 'DIFFER', stats))
    if not (got[-1].shape == (len(words), 2) and err <= SEQ_SERVE_TOL * scale
            and same and stats['captures'] == 1):
        raise AssertionError('%s served through Predictor: err %.3g, shape '
                             '%r, calls equal %s, %r'
                             % (what, err, got[-1].shape, same, stats))
    return err


def _sequence_model(what, build, tag='sequences', prepare=None, serve=None,
                    token_feeds=None):
    """`what` trained SEQ_STEPS captured steps through Executor() on its
    reader's batches (read beforehand through DataFeeder): finite losses;
    one capture per time bucket seen twice or more, every other step of a
    bucket a replay; the median replayed step, sequences/s and valid
    tokens/s, peak memory and the graph pool each capture reserved; the
    replay against the eager walk (_measure: device busy, idle share,
    kernel records per step) and the top device kernels over
    PROFILED_STEPS replays; a replay on another batch of the common bucket
    against the eager walk (_replay_against_eager); the loss falling on
    the first batch repeated;
    step 1 against the CPU; the classifiers' serving. Returns a record.

    For another phase (`tag`): prepare(scope) runs after the startup
    program (a pretrained table loaded); serve(test, target, scope, exe,
    samples) serves the for_test program instead of _serve_sequences;
    token_feeds names the feeds whose ids count as valid tokens (default:
    every input sequence). A model with no sequence feed has one
    signature: its replay is held on another batch."""
    import random
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lowering import leaves_of, map_value
    random.seed(SEED)
    t0 = time.perf_counter()
    main, startup, avg_cost, reader, names, test, prob = build()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    if prepare is not None:
        prepare(scope)
    initial = scope.to_numpy()
    feeder = fluid.DataFeeder(names, fluid.CUDAPlace(0), program=main)
    batches = list(itertools.islice(reader(), SEQ_STEPS))
    feeds = [feeder.feed(b) for b in batches]
    batch = len(batches[0])
    log('[%s] %s: built, initialized on the card and read %d '
        'batches of %d in %.3f s' % (tag, what, len(feeds), batch,
                                     time.perf_counter() - t0))
    base = exe.cache_stats
    torch.cuda.reset_peak_memory_stats()
    seen, pools, losses, step_s, replayed = {}, {}, [], [], []
    for feed in feeds:
        bucket = _bucket(feed)
        seen[bucket] = seen.get(bucket, 0) + 1
        capture = seen[bucket] == 2
        r0 = _reserved() if capture else None
        before = exe.cache_stats['replays']
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        step_s.append(time.perf_counter() - t0)
        if capture:
            pools[bucket] = _reserved() - r0
        replayed.append(exe.cache_stats['replays'] > before
                        and not capture)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    peak = torch.cuda.max_memory_allocated()
    stats = {k: exe.cache_stats[k] - base[k] for k in ('captures',
                                                       'replays')}
    if not np.isfinite(losses).all():
        raise AssertionError('%s: non-finite loss %r' % (what, losses))
    twice = sum(n >= 2 for n in seen.values())
    want_replays = sum(n - 1 for n in seen.values() if n >= 2)
    if stats != {'captures': twice, 'replays': want_replays}:
        raise AssertionError('%s: %r over buckets %r: not one capture per '
                             'bucket seen twice' % (what, stats, seen))
    times = [t for t, r in zip(step_s, replayed) if r]
    tokens = [_valid_tokens(f, token_feeds or names)
              for f, r in zip(feeds, replayed) if r]
    med = float(np.median(times))
    rec = dict(model=what, batch=batch, losses=losses, step_s=step_s,
               buckets={'x'.join(map(str, b)): n for b, n in seen.items()},
               graph_pool_gb={'x'.join(map(str, b)): p / 1e9
                              for b, p in pools.items()},
               captures=stats['captures'], replays=stats['replays'],
               median_replayed_step_s=med, sequences_per_s=batch / med,
               valid_tokens_per_s=float(np.median(tokens)) / med,
               peak_memory_gb=peak / 1e9)
    # the most frequent bucket's first batch: a captured signature
    common = max(seen, key=seen.get)
    feed = [f for f in feeds if _bucket(f) == common][0]
    art = exe.step_artifact(main, feed=feed, fetch_list=[avg_cost],
                            scope=scope)
    state = {n: t.clone() for n, t in art.state_dict(scope).items()}
    dev = {n: map_value(lambda t: torch.as_tensor(t).cuda(), v)
           for n, v in feed.items()}
    g = torch.Generator(device='cuda')
    # timed before the top kernels are traced
    m = _measure(what, lambda: exe.run(main, feed=feed,
                                       fetch_list=[avg_cost], scope=scope),
                 lambda: _to_host(art.debug_step(state, dev, 0,
                                                 generator=g)[0]),
                 pools.get(common, 0))
    del state, dev
    busy, traced, top = _top_kernels(lambda: exe.run(
        main, feed=feed, fetch_list=[avg_cost], scope=scope), PROFILED_STEPS)
    rec.update(top_device_kernels_ms_per_step=top,
               device_busy_ms_per_step=busy, traced_wall_ms_per_step=traced,
               measured=m, card=nvidia_smi_line())
    # one replay of the captured graph on another batch of its bucket,
    # whose lengths and ids differ from those the replays above copied
    # into the graph's static buffers, against the eager walk
    same = [f for f in feeds if _bucket(f) == common]
    fresh = same[-1]
    seqs = _seq_feeds(feed)
    # other lengths where the reader's lengths vary, else other ids
    varies = any(not torch.equal(f[n].lengths, feed[n].lengths)
                 for f in same for n in seqs)
    if varies and all(torch.equal(fresh[n].lengths, feed[n].lengths)
                      for n in seqs):
        raise AssertionError('%s: no second batch of bucket %r with other '
                             'lengths' % (what, common))
    if all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
           for n in feed for a, b in zip(leaves_of(fresh[n]),
                                         leaves_of(feed[n]))):
        raise AssertionError('%s: no second batch of bucket %r' % (what,
                                                                  common))
    h = exe.acquire_step(main, feed=fresh, fetch_list=[avg_cost],
                         scope=scope)
    exact, spread = _replay_against_eager(what, h, art, scope, fresh, 0)
    rec['replay_vs_eager'] = dict(bitwise=exact, within_spread=spread)
    log('[%s] %s losses %s' % (tag, what, ', '.join(
        '%.4f' % x for x in losses)))
    log('[%s] %s buckets (padded time axes of the sequence feeds: '
        'batches) %s; captures %d, replays %d; graph pool reserved by each '
        'capture (GB) %s' % (tag, what, rec['buckets'], stats['captures'],
                             stats['replays'], rec['graph_pool_gb']))
    log('[%s] %s median replayed step over %d reader batches %.4f s: '
        '%.1f %s/s and %.0f valid tokens/s at batch %d; peak memory '
        '%.3f GB; replay of one batch %.4f ms against the eager walk\'s '
        '%.4f ms; device busy %.3f ms a step (idle %.3f of the median '
        'replay), %.0f device kernels a step; top device kernels (ms a '
        'step) %s; card: %s'
        % (tag, what, len(times), med, batch / med,
           'sequences' if seqs else 'examples', rec['valid_tokens_per_s'],
           batch, peak / 1e9, m['captured']['median_step_ms'],
           m['eager']['median_step_ms'], m['captured']['device_busy_ms'],
           m['captured']['idle_share_of_median_step'],
           m['captured']['device_records_per_step'],
           '; '.join('%s %.3f' % kv for kv in top), rec['card']))
    s2 = fluid.Scope()
    s2.load_numpy(initial, fluid.CUDAPlace(0))
    learn = [float(np.asarray(exe.run(main, feed=feeds[0],
                                      fetch_list=[avg_cost],
                                      scope=s2)[0]).reshape(-1)[0])
             for _ in range(SEQ_LEARN_STEPS)]
    del s2
    log('[%s] %s, the first batch repeated %d steps from the '
        'startup weights: loss %s' % (tag, what, SEQ_LEARN_STEPS, ', '.join(
            '%.4f' % x for x in learn)))
    rec['falling_losses'] = learn
    if not np.mean(learn[-DENSE_WINDOW:]) < np.mean(learn[:DENSE_WINDOW]):
        raise AssertionError('%s: the loss did not fall: %r' % (what, learn))
    small = fluid.DataFeeder(names, fluid.CPUPlace(), program=main).feed(
        batches[0][:SEQ_CPU_BATCH])
    rec['card_vs_cpu'] = _sequence_card_against_cpu(what, main, avg_cost,
                                                    initial, small, tag)
    if serve is not None:
        rec['serve'] = serve(test, prob, scope, exe, batches[-1])
    elif test is not None:
        rec['serve_max_abs_err'] = _serve_sequences(
            what, test, prob, scope, exe, batches[-1])
    del exe, scope
    return rec


def phase_sequences():
    """stacked_dynamic_lstm, understand_sentiment and machine_translation
    training at full width through the entry points on the card (no
    kernel of the port on their paths); returns {'sequences': launch
    counts}."""
    import torch
    _reset_launch_counts()
    records = [_sequence_model('stacked_dynamic_lstm', build_stacked_lstm),
               _sequence_model('understand_sentiment', build_sentiment),
               _sequence_model('machine_translation', build_mt)]
    torch.cuda.synchronize()
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError('the sequence paths launched %r' % counts)
    log(json.dumps({'sequences': records}))
    return {'sequences': counts}


# -- phase 7e ---------------------------------------------------------------

def build_word2vec():
    """word2vec.get_model(): dict 2073, embed 32, hidden 256, N 5, batch
    64, SGD 1e-3; serves the for_test program's softmax."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import word2vec
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, test, reader, _, names = word2vec.get_model()
    return main, startup, loss, reader, names, test, _last_softmax(test)


def build_recommender():
    """recommender_system.get_model(): emb 32, towers 200, batch 256, SGD
    0.2; serves the scaled cosine."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import recommender_system
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, infer, test, reader, _, names = \
            recommender_system.get_model()
    return main, startup, loss, reader, names, test, infer.name


def build_srl():
    """label_semantic_roles at BOOK_SRL, SGD under the book's staircase
    exponential decay; serves crf_decoding's path from the for_test
    clone."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import label_semantic_roles
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss, decode, reader, names = label_semantic_roles.get_model(
            **BOOK_SRL)
        lr = fluid.layers.exponential_decay(*BOOK_SRL_LR, staircase=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, startup, loss, reader, names, main.clone(for_test=True), \
        decode.name


def _load_srl_embedding(scope):
    from paddle_tpu_torch.models import label_semantic_roles
    shape = label_semantic_roles.load_pretrained_embedding(scope=scope)
    if scope.vars['emb'].device.type != 'cuda':
        raise AssertionError('the pretrained emb left the card')
    log('[book] label_semantic_roles: pretrained emb %r loaded on the card '
        'through scope.find_var(...).get_tensor().set()' % (shape,))


def _book_request(samples, names):
    """{name: rows} of samples for `names`, the first len(names) slots of
    each sample: a list slot as a LoDTensor, a number as an int64 [N, 1]
    array."""
    from paddle_tpu_torch import fluid
    req = {}
    for i, n in enumerate(names):
        col = [s[i] for s in samples]
        if isinstance(col[0], (list, tuple)):
            req[n] = fluid.LoDTensor(
                np.concatenate(col).reshape(-1, 1).astype('int64'),
                [[len(c) for c in col]])
        else:
            req[n] = np.array(col, 'int64').reshape(-1, 1)
    return req


def _predict(test, target, scope, exe, names, req):
    """The for_test program saved with save_inference_model and served by
    Predictor on the card (three calls: warm-up, capture, replay) and on
    the CPU: (the card's outputs, the CPU's, the card's cache stats)."""
    from paddle_tpu_torch import fluid, inference
    with tempfile.TemporaryDirectory() as d:
        fluid.io.save_inference_model(
            d, names, [test.global_block().var(target)], exe,
            main_program=test, scope=scope)
        card = inference.Predictor(d)
        got = [card.run(req)[0] for _ in range(3)]
        want = inference.Predictor(d, place=fluid.CPUPlace()).run(req)[0]
        stats = card._exe.cache_stats
    if not (all(np.array_equal(g, got[0]) for g in got)
            and stats['captures'] == 1):
        raise AssertionError('Predictor on the card: three calls differ or '
                             'no capture: %r' % (stats,))
    return got[-1], want, stats


def _serve_book(what, feeds):
    """serve() of a dense-output book model: its input `feeds` (the first
    slots of each sample) of SEQ_SERVE_ROWS samples, card against CPU
    within SEQ_SERVE_TOL of max(1, |y|)."""
    def serve(test, target, scope, exe, samples):
        rows = samples[:SEQ_SERVE_ROWS]
        got, want, stats = _predict(test, target, scope, exe, feeds,
                                    _book_request(rows, feeds))
        err = float(np.abs(got - want).max())
        scale = max(1.0, float(np.abs(want).max()))
        log('[book] %s for_test program through Predictor, %d rows (feeds '
            '%s): card vs CPU max abs err %.3g (tol %g x %g); %r'
            % (what, len(rows), feeds, err, SEQ_SERVE_TOL, scale, stats))
        if not (got.shape == want.shape and got.shape[0] == len(rows)
                and np.isfinite(got).all() and err <= SEQ_SERVE_TOL * scale):
            raise AssertionError('%s served through Predictor: err %.3g, '
                                 'shape %r' % (what, err, got.shape))
        return dict(max_abs_err=err, rows=len(rows))
    return serve


def _viterbi_margin(em, trans):
    """The Viterbi path of one sequence's emissions em [L, C] under
    trans [C + 2, C], in float64, and its smallest margin: best minus
    second-best score at the last step and at each back-pointer the path
    takes."""
    a, b, w = trans[0], trans[1], trans[2:]
    delta = a + em[0]
    ptrs = []
    for t in range(1, len(em)):
        scores = delta[:, None] + w
        top2 = np.partition(scores, -2, axis=0)[-2:]
        ptrs.append((scores.argmax(0), top2[1] - top2[0]))
        delta = scores.max(0) + em[t]
    final = delta + b
    top2 = np.partition(final, -2)[-2:]
    state = int(final.argmax())
    path, margins = [state], [top2[1] - top2[0]]
    for arg, gap in reversed(ptrs):
        margins.append(gap[state])
        state = int(arg[state])
        path.append(state)
    return path[::-1], float(min(margins))


def _serve_srl(test, decode, scope, exe, samples):
    """SRL's decode on the card: crf_decoding of the for_test clone run on
    the card against the CPU rule on the card's own emissions (equal);
    the card's and the CPU's Predictor token for token on the sequences
    without near-ties (_viterbi_margin against BOOK_TIE_FACTOR x the
    card-CPU emission difference summed over the sequence)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.models import label_semantic_roles
    names = label_semantic_roles.FEED_ORDER[:-1]
    rows = samples
    while len(rows) < BOOK_SRL_SERVE_ROWS:
        rows = rows + samples
    rows = rows[:BOOK_SRL_SERVE_ROWS]
    req = _book_request(rows, names)
    lens = [len(s[0]) for s in rows]
    op = [o for o in test.global_block().ops if o.type == 'crf_decoding'][0]
    em_name = op.inputs['Emission'][0].name
    pruned = test.prune([test.global_block().var(em_name),
                         test.global_block().var(decode)])
    cpu_scope = fluid.Scope()
    cpu_scope.load_numpy(scope.to_numpy(), fluid.CPUPlace())
    em_card, dec_card = exe.run(pruned, feed=req, fetch_list=[em_name,
                                                               decode],
                                scope=scope)
    em_cpu, = fluid.Executor(fluid.CPUPlace()).run(
        pruned, feed=req, fetch_list=[em_name], scope=cpu_scope)
    trans = scope.to_numpy(['crfw'])['crfw']
    # the CPU rule on the card's emissions, padded to the longest
    B, T, C = len(lens), max(lens), em_card.shape[1]
    pad = np.zeros((B, T, C), 'float32')
    starts = np.cumsum([0] + lens)
    for i, n in enumerate(lens):
        pad[i, :n] = em_card[starts[i]:starts[i + 1]]
    rule = lowering.get_rule('crf_decoding')(
        {'Emission': [lowering.SeqValue(torch.from_numpy(pad),
                                        torch.tensor(lens))],
         'Transition': [torch.from_numpy(trans)]}, {},
        lowering.Ctx(torch.device('cpu'), torch.Generator()))
    want = np.concatenate([rule['ViterbiPath'].data[i, :n, 0].numpy()
                           for i, n in enumerate(lens)])
    rule_same = np.array_equal(dec_card.reshape(-1), want)
    got, cpu, stats = _predict(test, decode, scope, exe, names, req)
    got, cpu = got.reshape(-1), cpu.reshape(-1)
    clear, same, emb_err = 0, 0, 0.0
    for i, n in enumerate(lens):
        sl = slice(starts[i], starts[i + 1])
        diff = np.abs(em_card[sl].astype('float64') - em_cpu[sl]).max(1)
        emb_err = max(emb_err, float(diff.max()))
        path, margin = _viterbi_margin(em_cpu[sl].astype('float64'),
                                       trans.astype('float64'))
        if margin > BOOK_TIE_FACTOR * float(diff.sum()):
            clear += 1
            same += bool(np.array_equal(got[sl], cpu[sl]))
    log('[book] label_semantic_roles decode of %d sequences (lengths %s): '
        'the card\'s crf_decoding against the CPU rule on its emissions %s; '
        'emissions card vs CPU max abs diff %.3g; %d sequences without a '
        'near-tie, %d of them token for token equal through Predictor '
        '(card vs CPU); all: %d of %d tokens equal; %r'
        % (len(lens), lens, 'equal' if rule_same else 'DIFFER', emb_err,
           clear, same, int((got == cpu).sum()), got.size, stats))
    if not (rule_same and clear * 2 >= len(lens) and same == clear
            and ((got >= 0) & (got < C)).all()):
        raise AssertionError(
            'label_semantic_roles decode: rule equal %s, %d of %d sequences '
            'clear of near-ties, %d of those equal' % (rule_same, clear,
                                                       len(lens), same))
    return dict(rule_equal=rule_same, sequences=len(lens),
                clear_of_ties=clear, equal=same, emission_max_abs_diff=emb_err)


def phase_book_models():
    """word2vec, recommender_system and label_semantic_roles (hidden 512,
    depth 8) training at full width through the entry points on the card,
    and served through Predictor (no kernel of the port on their paths);
    returns {'book_models': launch counts}."""
    import torch
    _reset_launch_counts()
    t0 = time.perf_counter()
    records = [
        _sequence_model('word2vec', build_word2vec, tag='book',
                        serve=_serve_book('word2vec', [
                            'word_%d' % i for i in range(4)])),
        _sequence_model('recommender_system', build_recommender, tag='book',
                        serve=_serve_book('recommender_system', [
                            'user_id', 'gender_id', 'age_id', 'job_id',
                            'movie_id', 'category_id', 'movie_title'])),
        _sequence_model('label_semantic_roles', build_srl, tag='book',
                        prepare=_load_srl_embedding, serve=_serve_srl,
                        token_feeds=['word_data'])]
    torch.cuda.synchronize()
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError('the book model paths launched %r' % counts)
    secs = time.perf_counter() - t0
    log('[book] phase 7e took %.1f s' % secs)
    log(json.dumps({'book_models': records, 'seconds': secs}))
    return {'book_models': counts}


# -- phase 7f ---------------------------------------------------------------

def _cf_encoder(layers, name='src_word', emb_name=None):
    """The encoder of tests/test_contrib.py and the book's decoder at
    CONTROL_FLOW's widths: embedding, fc 4 x hidden tanh, dynamic_lstm,
    sequence_last_step."""
    from paddle_tpu_torch import fluid
    V, E, H = (CONTROL_FLOW[k] for k in ('dict_size', 'word_dim',
                                          'hidden'))
    src = layers.data(name=name, shape=[1], dtype='int64', lod_level=1)
    emb = layers.embedding(
        input=src, size=[V, E], dtype='float32',
        param_attr=fluid.ParamAttr(name=emb_name) if emb_name else None)
    fc1 = layers.fc(input=emb, size=H * 4, act='tanh')
    h, _ = layers.dynamic_lstm(input=fc1, size=H * 4)
    return layers.sequence_last_step(input=h)


def _cf_state_cell(layers, decoder, context):
    """A StateCell of one state h: fc([h, word], hidden, tanh)."""
    h = decoder.InitState(init=context, need_reorder=True)
    cell = decoder.StateCell(inputs={'x': None}, states={'h': h},
                             out_state='h')

    @cell.state_updater
    def updater(cell):
        word = cell.get_input('x')
        prev_h = cell.get_state('h')
        cell.set_state('h', layers.fc(input=[prev_h, word],
                                      size=CONTROL_FLOW['hidden'],
                                      act='tanh'))
    return cell


def build_contrib_training():
    """(a): the TrainingDecoder seq2seq (over DynamicRNN) of
    tests/test_contrib.py at CONTROL_FLOW's widths, fc dict softmax and
    cross_entropy, Adam(CONTROL_FLOW_LR), wmt14 batches of
    CONTROL_FLOW_BATCH."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.dataset import wmt14
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.fluid.contrib import decoder
    layers = fluid.layers
    V, E = CONTROL_FLOW['dict_size'], CONTROL_FLOW['word_dim']
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        cell = _cf_state_cell(layers, decoder, _cf_encoder(layers))
        trg = layers.data(name='trg_word', shape=[1], dtype='int64',
                          lod_level=1)
        trg_emb = layers.embedding(input=trg, size=[V, E], dtype='float32')
        dec = decoder.TrainingDecoder(cell)
        with dec.block():
            word = dec.step_input(trg_emb)
            dec.state_cell.compute_state(inputs={'x': word})
            score = layers.fc(input=dec.state_cell.get_state('h'), size=V,
                              act='softmax')
            dec.state_cell.update_states()
            dec.output(score)
        label = layers.data(name='next_word', shape=[1], dtype='int64',
                            lod_level=1)
        cost = layers.mean(layers.cross_entropy(input=dec(), label=label))
        fluid.optimizer.Adam(learning_rate=CONTROL_FLOW_LR).minimize(cost)
    reader = batch(wmt14.train(V), batch_size=CONTROL_FLOW_BATCH)
    return main, startup, cost, reader, ['src_word', 'trg_word',
                                         'next_word'], None, None


def build_contrib_generation():
    """(b): BeamSearchDecoder (topk CONTROL_FLOW_TOPK) over the same
    encoder and cell; its parameters are the training program's, by
    name. Returns (program, startup, ids, scores, the loop counter, the
    stacked per-step ids and scores)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.fluid.contrib import decoder
    layers = fluid.layers
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        cell = _cf_state_cell(layers, decoder, _cf_encoder(layers))
        init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                               lod_level=2)
        init_scores = layers.data(name='init_scores', shape=[1],
                                  dtype='float32', lod_level=2)
        dec = decoder.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=CONTROL_FLOW['dict_size'],
            word_dim=CONTROL_FLOW['word_dim'], input_var_dict={},
            topk_size=CONTROL_FLOW_TOPK, sparse_emb=False,
            max_len=CONTROL_FLOW_MAX_LEN, beam_size=CONTROL_FLOW_BEAM,
            end_id=CONTROL_FLOW_END_ID)
        dec.decode()
        ids, scores = dec()
    blk = main.global_block()
    stacked = [op.outputs['Out'][0].name for op in blk.ops
               if op.type == 'array_stack']
    # the reshapes of the stacks: [max_len, B, beam]
    steps = [op.outputs['Out'][0].name for op in blk.ops
             if op.type == 'reshape' and op.inputs['X'][0].name in stacked]
    return main, startup, ids.name, scores.name, dec._counter.name, steps[:2]


def build_book_decoder():
    """(c): the book's decode_main (tests/book/test_machine_translation.py,
    as tests/test_control_flow.py and tests/test_torch_control_flow.py
    build it) at CONTROL_FLOW's widths: state, ids and scores arrays of
    the default capacity; sequence_expand and lod_reset on the beam form;
    fc tanh state; fc softmax; topk; log + accumulate; beam_search (level
    0); an is_empty stop; beam_search_decode over the arrays. Random
    weights from SEED. Returns (program, startup, ids, scores, the loop
    counter)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    layers = fluid.layers
    V, E, H = (CONTROL_FLOW[k] for k in ('dict_size', 'word_dim',
                                          'hidden'))
    beam, end_id = CONTROL_FLOW_BEAM, CONTROL_FLOW_END_ID
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        context = _cf_encoder(layers, 'src_word_id', 'vemb')
        array_len = layers.fill_constant(shape=[1], dtype='int64',
                                         value=CONTROL_FLOW_MAX_LEN)
        counter = layers.zeros(shape=[1], dtype='int64', force_cpu=True)
        state_array = layers.create_array('float32')
        layers.array_write(context, array=state_array, i=counter)
        ids_array = layers.create_array('int64')
        scores_array = layers.create_array('float32')
        init_ids = layers.data(name='init_ids', shape=[1], dtype='int64',
                               lod_level=2)
        init_scores = layers.data(name='init_scores', shape=[1],
                                  dtype='float32', lod_level=2)
        layers.array_write(init_ids, array=ids_array, i=counter)
        layers.array_write(init_scores, array=scores_array, i=counter)
        cond = layers.less_than(x=counter, y=array_len)
        while_op = layers.While(cond=cond)
        with while_op.block():
            pre_ids = layers.array_read(array=ids_array, i=counter)
            pre_state = layers.array_read(array=state_array, i=counter)
            pre_score = layers.array_read(array=scores_array, i=counter)
            pre_state_expanded = layers.sequence_expand(pre_state,
                                                        pre_score)
            pre_ids_emb = layers.embedding(input=pre_ids, size=[V, E],
                                           dtype='float32')
            current_state = layers.fc(
                input=[pre_state_expanded, pre_ids_emb], size=H,
                act='tanh')
            current_state_with_lod = layers.lod_reset(x=current_state,
                                                      y=pre_score)
            current_score = layers.fc(input=current_state_with_lod,
                                      size=V, act='softmax')
            topk_scores, topk_indices = layers.topk(current_score, k=beam)
            accu_scores = layers.elementwise_add(
                x=layers.log(topk_scores),
                y=layers.reshape(pre_score, shape=[-1]), axis=0)
            selected_ids, selected_scores = layers.beam_search(
                pre_ids, pre_score, topk_indices, accu_scores, beam,
                end_id=end_id, level=0)
            layers.increment(x=counter, value=1, in_place=True)
            layers.array_write(current_state, array=state_array, i=counter)
            layers.array_write(selected_ids, array=ids_array, i=counter)
            layers.array_write(selected_scores, array=scores_array,
                               i=counter)
            length_cond = layers.less_than(x=counter, y=array_len)
            finish_cond = layers.logical_not(
                layers.is_empty(x=selected_ids))
            layers.logical_and(x=length_cond, y=finish_cond, out=cond)
        ids, scores = layers.beam_search_decode(
            ids=ids_array, scores=scores_array, beam_size=beam,
            end_id=end_id)
    return main, startup, ids.name, scores.name, counter.name


def control_flow_sources():
    """The first CONTROL_FLOW_BATCH wmt14 training sources (4-29 ids each,
    the longest past 16: the 32 bucket)."""
    from paddle_tpu_torch.dataset import wmt14
    srcs = [s for s, _, _ in itertools.islice(
        wmt14.train(CONTROL_FLOW['dict_size'])(), CONTROL_FLOW_BATCH)]
    return srcs


def _cf_feed(srcs, name, dense_init):
    """The decode feed: the sources as a LoDTensor; init_ids (the start id
    0) and init_scores (1.0), one a source, as the 2-level LoDTensors of
    the book's decode_main or, dense_init, as the [B, 1] arrays of
    tests/test_contrib.py."""
    from paddle_tpu_torch import fluid
    n = len(srcs)
    feed = {name: fluid.LoDTensor(
        np.concatenate(srcs).reshape(-1, 1).astype('int64'),
        [[len(s) for s in srcs]])}
    ids = np.zeros((n, 1), 'int64')
    scores = np.ones((n, 1), 'float32')
    if dense_init:
        feed.update(init_ids=ids, init_scores=scores)
    else:
        feed.update(init_ids=fluid.LoDTensor(ids, [[1] * n, [1] * n]),
                    init_scores=fluid.LoDTensor(scores, [[1] * n, [1] * n]))
    return feed


def _leaves(vals):
    """Every tensor of a fetch list (a SeqValue's leaves in order)."""
    from paddle_tpu_torch.fluid.lowering import leaves_of
    return [t for v in vals for t in leaves_of(v)]


def _cf_loops(art):
    """[(label, bound)] of the while ops the artifact's last step ran."""
    return list(art.last_loops[0]) if art.last_loops else []


def _cf_decode(what, main, startup, scope, feed, fetch, counter, state):
    """One decode program through Executor() on the card: its warm-up,
    capture and replays (one artifact, one capture); the replay against
    two eager walks (debug_step; bitwise); _measure's medians, busy, idle,
    kernels per replay and graph pool; each while's bound against the
    iterations live at its exit (the loop counter); the same program on
    the CPU from the same weights. Returns (record, card fetches, CPU
    fetches), the fetches as numpy or LoDTensors."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.lowering import map_value
    exe = fluid.Executor()
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        state = scope.to_numpy()
    base = exe.cache_stats
    names = fetch + [counter]
    outs, secs = [], []
    for k in range(3):
        r0 = _reserved() if k == 1 else None
        t0 = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=names, scope=scope,
                            return_numpy=False))
        secs.append(time.perf_counter() - t0)
        if k == 1:
            pool = _reserved() - r0
    stats = {k: exe.cache_stats[k] - base[k] for k in ('captures',
                                                       'replays')}
    if stats != {'captures': 1, 'replays': 2}:
        raise AssertionError('%s: %r: not one capture and two replays'
                             % (what, stats))
    art = exe.step_artifact(main, feed=feed, fetch_list=names, scope=scope)
    loops = _cf_loops(art)
    got = [_host_value(v) for v in outs[-1]]
    for o in outs[:-1]:
        if not all(_same_value(_host_value(a), b) for a, b in zip(o, got)):
            raise AssertionError('%s: the three calls differ' % what)
    live = int(np.asarray(got[-1]).reshape(-1)[0])
    # the replay against two eager walks of the same step, bitwise
    dev = {n: map_value(lambda t: torch.as_tensor(t).cuda(), v)
           for n, v in exe._feed_values(main, feed).items()}
    st = art.state_dict(scope)
    g = torch.Generator(device='cuda')
    eager = [_leaves(art.debug_step(st, dev, 0, generator=g)[0])
             for _ in range(2)]
    handle = exe.acquire_step(main, feed=feed, fetch_list=names,
                              scope=scope)
    replay = _leaves(handle.step(feed, seed=0))
    eager_same = all(torch.equal(a, b) for a, b in zip(*eager))
    bitwise = all(torch.equal(a, b) for a, b in zip(replay, eager[0]))
    if not bitwise:
        raise AssertionError('%s: the replay differs from the eager walk '
                             '(eager walks equal: %s)' % (what, eager_same))
    m = _measure(what, lambda: exe.run(main, feed=feed, fetch_list=names,
                                       scope=scope),
                 lambda: _to_host(_leaves(art.debug_step(
                     st, dev, 0, generator=g)[0])), pool,
                 steps=CONTROL_FLOW_TIMED)
    # the CPU from the same weights
    cpu_scope = fluid.Scope()
    cpu_scope.load_numpy(state, fluid.CPUPlace())
    t0 = time.perf_counter()
    want = [_host_value(v) for v in fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=names, scope=cpu_scope,
        return_numpy=False)]
    cpu_s = time.perf_counter() - t0
    rec = dict(path=what, sources=CONTROL_FLOW_BATCH, beam=CONTROL_FLOW_BEAM,
               max_len=CONTROL_FLOW_MAX_LEN, call_s=secs, cpu_call_s=cpu_s,
               loops=[dict(op=label, bound=bound, live_at_exit=live,
                           dead_share=1.0 - live / bound)
                      for label, bound in loops],
               replay_vs_eager=dict(bitwise=bitwise, eager_walks_equal=
                                    eager_same),
               sentences_per_s=CONTROL_FLOW_BATCH
               / (m['captured']['median_step_ms'] / 1e3),
               measured=m, card=nvidia_smi_line())
    log('[control_flow] %s: %d sources, beam %d: replay %.4f ms (median), '
        'eager %.4f ms, device busy %.4f ms, idle %.3f of the replay, %.0f '
        'kernels a replay, graph pool %.3f GB; %.1f sentences/s; while '
        'bound against live iterations at exit: %s; the replay bitwise '
        'equal to the eager walk; card: %s'
        % (what, CONTROL_FLOW_BATCH, CONTROL_FLOW_BEAM,
           m['captured']['median_step_ms'], m['eager']['median_step_ms'],
           m['captured']['device_busy_ms'],
           m['captured']['idle_share_of_median_step'],
           m['captured']['device_records_per_step'], pool / 1e9,
           rec['sentences_per_s'],
           ', '.join('%s %d / %d' % (label, bound, live)
                     for label, bound in loops), rec['card']))
    del exe
    return rec, got, want


def _host_value(v):
    """A fetch as numpy, or a LoDTensor as (lod, numpy data)."""
    if hasattr(v, 'recursive_sequence_lengths'):
        return (v.recursive_sequence_lengths(), np.asarray(v.data))
    return np.asarray(v.detach().cpu() if hasattr(v, 'detach') else v)


def _same_value(a, b):
    if isinstance(a, tuple):
        return a[0] == b[0] and np.array_equal(a[1], b[1])
    return np.array_equal(a, b)


def _scores_close(got, want):
    """(max abs difference, the tolerance CONTROL_FLOW_SCORE_TOL x
    max(1, |want|): a score is a sum of log-probabilities over the steps,
    and fp32 resolves it to about 1e-7 of its size, whether it is -1 or
    -330)."""
    err = float(np.abs(got.astype('float64') - want).max()) \
        if want.size else 0.0
    tol = CONTROL_FLOW_SCORE_TOL * max(
        1.0, float(np.abs(want).max()) if want.size else 1.0)
    return err, tol


def _contrib_generation(scope, srcs):
    """(b) on the scope (a) trained: ids equal to the CPU's on the same
    weights and scores within CONTROL_FLOW_SCORE_TOL; where ids differ, a
    near-tie shown on the per-step stacks: the steps before equal, and at
    the first differing step the card's and the CPU's selected scores of
    that source equal within the tolerance (the swapped candidates tie)."""
    main, startup, ids, scores, counter, steps = build_contrib_generation()
    params = [v.name for v in main.list_vars() if v.persistable]
    missing = [n for n in params if n not in scope.vars]
    if missing:
        raise AssertionError('generation parameters not trained: %r'
                             % missing)
    state = scope.to_numpy(params)
    feed = _cf_feed(srcs, 'src_word', dense_init=True)
    rec, got, want = _cf_decode('contrib_generation', main, startup, scope,
                                feed, [ids, scores] + steps, counter, state)
    same_ids = np.array_equal(got[0], want[0])
    err, tol = _scores_close(got[1], want[1])
    ties = []
    if not same_ids:
        gs, ws = got[2], want[2]          # [max_len, B, beam]
        gsc, wsc = got[3], want[3]
        for s in range(gs.shape[1]):
            diff = [t for t in range(gs.shape[0])
                    if not np.array_equal(gs[t, s], ws[t, s])]
            if not diff:
                continue
            t = diff[0]
            gap = float(np.abs(np.sort(gsc[t, s]) - np.sort(wsc[t, s]))
                        .max())
            ties.append(dict(source=s, step=t, score_gap=gap))
        if not ties or any(x['score_gap'] > CONTROL_FLOW_SCORE_TOL
                           for x in ties):
            raise AssertionError('contrib generation: ids differ from the '
                                 'CPU without a near-tie: %r' % ties)
    elif err > tol:
        raise AssertionError('contrib generation: scores %.3g from the CPU'
                             % err)
    if not (got[0].shape == (CONTROL_FLOW_BATCH, CONTROL_FLOW_BEAM,
                             CONTROL_FLOW_MAX_LEN)
            and ((got[0] >= 0) & (got[0] < CONTROL_FLOW['dict_size'])).all()
            and np.isfinite(got[1]).all()):
        raise AssertionError('contrib generation: ids %r' % (got[0].shape,))
    rec.update(ids_equal_cpu=same_ids, scores_max_abs_err=err,
               scores_tol=tol, near_ties=ties)
    log('[control_flow] contrib_generation card vs CPU: ids %s, scores max '
        'abs err %.3g (tol %g x max(1, |score|) = %.3g)%s'
        % ('equal' if same_ids else 'differ', err, CONTROL_FLOW_SCORE_TOL,
           tol, '; near-ties %r' % ties if ties else ''))
    return rec


def _book_decode(srcs):
    """(c): the book decoder on random weights from SEED: the 2-level LoD
    and ids equal card against CPU, scores within CONTROL_FLOW_SCORE_TOL."""
    main, startup, ids, scores, counter = build_book_decoder()
    feed = _cf_feed(srcs, 'src_word_id', dense_init=False)
    rec, got, want = _cf_decode('book_decoder', main, startup, None, feed,
                                [ids, scores], counter, None)
    (glod, gids), (wlod, wids) = got[0], want[0]
    err, tol = _scores_close(got[1][1], want[1][1])
    ok = (glod == wlod and np.array_equal(gids, wids)
          and got[1][0] == wlod and err <= tol)
    log('[control_flow] book_decoder card vs CPU: LoD %s, ids %s, scores '
        'max abs err %.3g (tol %g x max(1, |score|) = %.3g); hypotheses a '
        'source %s, tokens %s'
        % ('equal' if glod == wlod else 'DIFFER',
           'equal' if np.array_equal(gids, wids) else 'DIFFER', err,
           CONTROL_FLOW_SCORE_TOL, tol, glod[0], glod[1]))
    if not ok:
        raise AssertionError('book decoder: the card differs from the CPU')
    rec.update(lod_equal=True, ids_equal=True, scores_max_abs_err=err,
               scores_tol=tol, hypotheses=glod[0], tokens=glod[1])
    return rec


def phase_control_flow():
    """(a) the contrib TrainingDecoder seq2seq trained as captured steps
    (_sequence_model's checks and records), (b) the contrib
    BeamSearchDecoder on the trained weights and (c) the book's While-loop
    LoD beam decoder, at machine_translation's widths on the card (no
    kernel of the port on these paths); returns {'control_flow': launch
    counts}."""
    import torch
    _reset_launch_counts()
    t0 = time.perf_counter()
    srcs = control_flow_sources()

    def generate(test, target, scope, exe, samples):
        return _contrib_generation(scope, srcs)

    # (b) runs as (a)'s serve step, on the scope (a) trained
    records = [_sequence_model('contrib_training_decoder',
                               build_contrib_training, tag='control_flow',
                               serve=generate),
               _book_decode(srcs)]
    torch.cuda.synchronize()
    counts = _launch_counts()
    if any(counts.values()):
        raise AssertionError('the control-flow paths launched %r' % counts)
    secs = time.perf_counter() - t0
    log('[control_flow] phase 7f took %.1f s' % secs)
    log(json.dumps({'control_flow': records, 'seconds': secs}))
    return {'control_flow': counts}

# -- phase 7g ---------------------------------------------------------------

TRAINER_FEEDS = ['src_word', 'trg_word', 'lbl_word']


def _transformer_funcs():
    """train_func and optimizer_func of the Transformer-base Trainer:
    models.transformer.transformer at get_model's widths, returning
    [avg_cost, token_count], and get_model's Adam over the scaled
    noam_decay; and infer_func, the same graph's decoder logits."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import transformer as T
    cfg = TRANSFORMER_BASE

    def build():
        return T.transformer(cfg['src_vocab_size'], cfg['trg_vocab_size'],
                             cfg['max_length'], cfg['n_layer'],
                             cfg['d_model'], cfg['n_head'], cfg['d_inner'])

    def train_func():
        avg_cost, token_count, _ = build()
        return [avg_cost, token_count]

    def optimizer_func():
        lr = fluid.layers.learning_rate_scheduler.noam_decay(
            cfg['d_model'], TRAIN_WARMUP)
        lr = fluid.layers.scale(lr, scale=2.0)
        return fluid.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                                    epsilon=1e-9)

    def infer_func():
        build()
        return logits_var(fluid.default_main_program())

    return train_func, optimizer_func, infer_func


def transformer_trainer(**kw):
    from paddle_tpu_torch import fluid
    train_func, optimizer_func, _ = _transformer_funcs()
    return fluid.Trainer(train_func=train_func, optimizer_func=optimizer_func,
                         place=fluid.CUDAPlace(0), **kw)


def trainer_reader(n, test=False):
    """The first n padded wmt16 batches (paddle.batch, then pad_batch)."""
    from paddle_tpu_torch import batch, reader
    from paddle_tpu_torch.dataset import wmt16
    from paddle_tpu_torch.models.transformer import pad_batch
    cfg = TRANSFORMER_BASE
    raw = (wmt16.test if test else wmt16.train)(cfg['src_vocab_size'],
                                                cfg['trg_vocab_size'])
    return reader.firstn(reader.map_readers(
        lambda b: pad_batch(b, cfg['max_length']),
        batch(raw, TRAIN_BATCH)), n)


@contextlib.contextmanager
def _spans(*names):
    """{name: [(seconds, fields)]} of the obs spans named, recorded while
    the context is open (span() exits and span_record() calls)."""
    from paddle_tpu_torch import obs
    got = {n: [] for n in names}
    real_exit, real_record = obs.Span.__exit__, obs.span_record

    def span_exit(self, *exc):
        out = real_exit(self, *exc)
        if self.name in got:
            got[self.name].append((self.seconds, dict(self.fields)))
        return out

    def span_record(name, seconds, **fields):
        if name in got:
            got[name].append((float(seconds), dict(fields)))
        return real_record(name, seconds, **fields)

    obs.Span.__exit__, obs.span_record = span_exit, span_record
    try:
        yield got
    finally:
        obs.Span.__exit__, obs.span_record = real_exit, real_record


def _secs(recs):
    return [s for s, _ in recs]


def _trainer_state(trainer):
    """Every persistable of the trainer's program, on the host."""
    import torch
    torch.cuda.synchronize()
    return {v.name: trainer.scope.vars[v.name].detach().cpu().clone()
            for v in trainer.train_program.list_vars()
            if v.persistable and v.name in trainer.scope.vars}


def _newest_serial(fluid, ckpt):
    serial = fluid.io.list_checkpoint_serials(ckpt)[-1]
    sdir = os.path.join(ckpt, 'checkpoint_%d' % serial)
    with open(os.path.join(sdir, 'meta.json')) as f:
        return serial, sdir, json.load(f)


def _release():
    """Give the memory of trainers the caller has dropped (their captured
    graphs and pools) back before the next sub-phase builds its own."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _trainer_main(tmp):
    """(a) Transformer-base through fluid.Trainer, double_buffer on, two
    periodic saves; then (f) test() and the Inferencer. Returns (launch
    counts, the losses, the start params' dir, the record)."""
    import torch
    from paddle_tpu_torch import fluid
    cfg = TRANSFORMER_BASE
    ckpt = os.path.join(tmp, 'main')
    start = os.path.join(tmp, 'start')
    t0 = time.perf_counter()
    tr = transformer_trainer(double_buffer=True,
                             checkpoint_config=fluid.CheckpointConfig(
                                 checkpoint_dir=ckpt,
                                 step_interval=TRAINER_INTERVAL))
    tr.save_params(start)
    n_params = sum(int(np.prod(v.shape)) for v in
                   tr.train_program.global_block().all_parameters())
    log('[trainer] built the Transformer-base Trainer (%d parameters) and '
        'saved its start params in %.3f s' % (n_params,
                                              time.perf_counter() - t0))
    losses, tokens, serial_bytes = [], [], []

    def handler(ev):
        if isinstance(ev, fluid.EndStepEvent):
            losses.append(float(np.asarray(ev.metrics[0]).reshape(())))
            tokens.append(float(np.asarray(ev.metrics[1]).reshape(())))
            if ev.step % TRAINER_INTERVAL == 0:
                _, _, meta = _newest_serial(fluid, ckpt)
                serial_bytes.append(meta['params_bytes'])

    _reset_launch_counts()
    with _spans('trainer.step', 'trainer.input_stage',
                'trainer.checkpoint.save', 'checkpoint.save') as sp:
        t0 = time.perf_counter()
        tr.train(num_epochs=1, event_handler=handler,
                 reader=trainer_reader(TRAINER_STEPS),
                 feed_order=TRAINER_FEEDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launch_counts()
    want = ATTENTION_OPS_PER_FORWARD * TRAINER_STEPS
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        if launches[name] != want:
            raise AssertionError(
                'the Trainer launched %s %d times in %d steps; the path '
                'must launch it %d times a step' % (
                    name, launches[name], TRAINER_STEPS,
                    ATTENTION_OPS_PER_FORWARD))
    if len(losses) != TRAINER_STEPS or not np.isfinite(losses).all():
        raise AssertionError('Trainer losses %r' % (losses,))
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError('the Trainer loss did not fall: %r' % (losses,))
    saves = sp['trainer.checkpoint.save']
    if [f['step'] for _, f in saves] != [0, TRAINER_INTERVAL] \
            or len(serial_bytes) != 2:
        raise AssertionError('periodic saves %r' % (saves,))
    if fluid.io.list_checkpoint_serials(ckpt):
        raise AssertionError('a finished train() left its serials')
    stats = tr.exe.cache_stats
    if stats['captures'] != 1 or stats['replays'] != TRAINER_STEPS - 1:
        raise AssertionError('Trainer steps: %r' % (stats,))
    step_s = _secs(sp['trainer.step'])[2:]          # replays only
    waits = _secs(sp['trainer.input_stage'])
    med = float(np.median(step_s))
    tok_s = sum(tokens[2:]) / sum(step_s)
    rec = dict(steps=TRAINER_STEPS, losses=losses, wall_s=wall,
               median_step_ms=med * 1e3,
               step_ms=[x * 1e3 for x in step_s], tokens_per_s=tok_s,
               positions_per_s=TRAIN_BATCH * cfg['max_length'] * 2 / med,
               median_input_wait_ms=float(np.median(waits)) * 1e3,
               input_wait_ms=[x * 1e3 for x in waits],
               input_stage_s=tr.input_stage_s, batches_fed=tr.batches_fed,
               checkpoint_bytes=serial_bytes,
               save_s=_secs(saves), write_s=_secs(sp['checkpoint.save']),
               parameters=n_params, launches_per_step={
                   k: v // TRAINER_STEPS for k, v in launches.items() if v})
    log('[trainer] (a) %d steps, double_buffer on: losses %s' % (
        TRAINER_STEPS, ', '.join('%.4f' % x for x in losses)))
    log('[trainer] (a) median replayed step %.3f ms (steps 3-%d), %.1f '
        'target tokens/s, %.1f source+target positions/s; median '
        'input-stage wait %.4f ms a step (mean %.4f); %d launches a step of '
        'each attention kernel' % (
            med * 1e3, TRAINER_STEPS, tok_s, rec['positions_per_s'],
            rec['median_input_wait_ms'],
            tr.input_stage_s / tr.batches_fed * 1e3,
            ATTENTION_OPS_PER_FORWARD))
    log('[trainer] (a) periodic saves at steps 0 and %d: %s bytes, %s s '
        '(the npz and its CRC: %s s)' % (
            TRAINER_INTERVAL, serial_bytes,
            ', '.join('%.3f' % x for x in rec['save_s']),
            ', '.join('%.3f' % x for x in rec['write_s'])))
    rec.update(_trainer_test_and_infer(tr, tmp))
    del tr
    _release()
    return launches, losses, start, rec


def _trainer_test_and_infer(tr, tmp):
    """(f) test() on the test reader; save_params; the Inferencer on the
    card against the same Inferencer on the CPU."""
    from paddle_tpu_torch import fluid
    cfg = TRANSFORMER_BASE
    test = tr.test(trainer_reader(TRAINER_TEST_BATCHES, test=True),
                   feed_order=TRAINER_FEEDS)
    if len(test) != 2 or not np.isfinite(test).all():
        raise AssertionError('test() gave %r' % (test,))
    params = os.path.join(tmp, 'trained')
    tr.save_params(params)
    _, _, infer_func = _transformer_funcs()
    feed = _grad_check_feed(TRAINER_FEEDS)
    outs = []
    for place in (fluid.CUDAPlace(0), fluid.CPUPlace()):
        inf = fluid.Inferencer(infer_func=infer_func, param_path=params,
                               place=place)
        outs.append(np.asarray(inf.infer(feed)[0]))
        del inf
    got, ref = outs
    rows = feed['src_word'].shape[0]
    if got.shape != (rows, cfg['max_length'], cfg['trg_vocab_size']) \
            or not np.isfinite(got).all():
        raise AssertionError('the Inferencer answered %r' % (got.shape,))
    diff = float(np.abs(got - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    if not diff <= TRAINER_INFER_TOL * scale:
        raise AssertionError(
            'the Inferencer on the card is %.3g from the CPU (largest logit '
            '%.3g, tol %g of it)' % (diff, scale, TRAINER_INFER_TOL))
    log('[trainer] (f) test() over %d test batches: mean loss %.4f, mean '
        'tokens %.1f; the Inferencer on the card against the CPU on %d rows: '
        'max abs diff %.3g (largest logit %.3g, tol %g of it)'
        % (TRAINER_TEST_BATCHES, test[0], test[1], rows, diff, scale,
           TRAINER_INFER_TOL))
    return dict(test=test, infer_max_abs_diff=diff, infer_scale=scale)


def _trainer_preemption(tmp):
    """(b) SIGTERM at BeginStepEvent TRAINER_PREEMPT_AT: an emergency serial
    (meta preempted: true); a fresh Trainer resumes at the next step from
    state bitwise the state at preemption; its next periodic serial is
    intact. (c) The newest serial (the resumed Trainer's own preemption)
    torn by one flipped byte: the next Trainer warns and resumes from the
    serial before. Returns the record."""
    import signal
    import torch
    import warnings
    from paddle_tpu_torch import fluid
    ckpt = os.path.join(tmp, 'preempt')
    k = TRAINER_PREEMPT_AT

    def cfg():
        return fluid.CheckpointConfig(checkpoint_dir=ckpt,
                                      step_interval=TRAINER_PREEMPT_AT - 1,
                                      max_num_checkpoints=3)

    prev = signal.getsignal(signal.SIGTERM)
    tr = transformer_trainer(checkpoint_config=cfg())
    seen = []

    def sigterm(ev):
        if isinstance(ev, fluid.BeginStepEvent):
            seen.append(ev.step)
            if ev.step == k:
                os.kill(os.getpid(), signal.SIGTERM)

    with warnings.catch_warnings(record=True) as rec, \
            _spans('trainer.checkpoint.emergency_flush',
                   'trainer.checkpoint.load', 'checkpoint.verify') as sp:
        warnings.simplefilter('always')
        tr.train(num_epochs=1, event_handler=sigterm,
                 reader=trainer_reader(TRAINER_RESUMED_STEPS),
                 feed_order=TRAINER_FEEDS)
        if signal.getsignal(signal.SIGTERM) is not prev:
            raise AssertionError('train() left its SIGTERM handler installed')
        if not tr.preempted or seen[-1] != k or not any(
                'emergency checkpoint flushed' in str(w.message)
                for w in rec):
            raise AssertionError('no preemption at step %d: %r' % (k, seen))
        serial, _, meta = _newest_serial(fluid, ckpt)
        if meta['trainer_args'] != {'epoch_id': 0, 'step_id': k,
                                    'preempted': True}:
            raise AssertionError('emergency meta %r' % (meta,))
        at_preemption = _trainer_state(tr)
        del tr
        _release()

        tr2 = transformer_trainer(checkpoint_config=cfg())
        resumed = _trainer_state(tr2)
        differ = [n for n, t in at_preemption.items()
                  if not torch.equal(resumed[n], t)]
        if sorted(resumed) != sorted(at_preemption) or differ:
            raise AssertionError('the resumed state differs from the state '
                                 'at preemption in %r' % differ[:8])
        seen2, intact = [], []

        def resumed_handler(ev):
            if isinstance(ev, fluid.BeginStepEvent):
                seen2.append(ev.step)
                if ev.step == TRAINER_RESUMED_STEPS - 1:
                    tr2.request_preemption()
            if isinstance(ev, fluid.EndStepEvent) \
                    and ev.step % (TRAINER_PREEMPT_AT - 1) == 0:
                s, sdir, m = _newest_serial(fluid, ckpt)
                fluid.io._verify_params(s, sdir, m)
                intact.append((s, m['trainer_args']))

        tr2.train(num_epochs=1, event_handler=resumed_handler,
                  reader=trainer_reader(TRAINER_RESUMED_STEPS),
                  feed_order=TRAINER_FEEDS)
    if seen2[0] != k + 1 or not tr2.preempted:
        raise AssertionError('resumed at step %r, not %d' % (seen2[:1], k + 1))
    if intact != [(serial + 1, {'epoch_id': 0, 'step_id': 2 * (k - 1)})]:
        raise AssertionError('the resumed Trainer saved %r' % (intact,))
    del tr2, resumed_handler
    _release()
    n_bytes = meta['params_bytes']
    log('[trainer] (b) SIGTERM at step %d: emergency serial %d (%d bytes, '
        '%.3f s), train() returned with preempted True and the handler '
        'restored; a fresh Trainer loaded it in %.3f s (CRC verify %.3f s), '
        'all %d persistables (Adam moments, @LR_DECAY_COUNTER@) bitwise the '
        'state at preemption, resumed at step %d; its periodic serial %d at '
        'step %d intact (size and CRC32)' % (
            k, serial, n_bytes, _secs(sp['trainer.checkpoint.emergency_flush'])[0],
            _secs(sp['trainer.checkpoint.load'])[0],
            _secs(sp['checkpoint.verify'])[0], len(resumed), k + 1,
            intact[0][0], intact[0][1]['step_id']))

    # (c) the newest serial torn by one flipped byte
    newest, sdir, meta = _newest_serial(fluid, ckpt)
    path = os.path.join(sdir, meta['params_file'])
    with open(path, 'r+b') as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x01]))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        c = cfg()
        tr3 = transformer_trainer(checkpoint_config=c)
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, RuntimeWarning)]
    if not any('serial %d' % newest in m and 'falling back' in m
               for m in msgs) or c.load_serial != newest - 1 \
            or c.step_id != 2 * (k - 1):
        raise AssertionError('no fallback past the torn serial %d: loaded '
                             '%r at step %r; warnings %r'
                             % (newest, c.load_serial, c.step_id, msgs))
    got = _trainer_state(tr3)
    with np.load(os.path.join(ckpt, 'checkpoint_%d' % (newest - 1),
                              '__params__.npz')) as saved:
        differ = [n for n in got
                  if not np.array_equal(saved[n], got[n].numpy())]
    if differ:
        raise AssertionError('the fallback state differs from serial %d in '
                             '%r' % (newest - 1, differ[:8]))
    del tr3
    _release()
    log('[trainer] (c) serial %d torn by one flipped byte: the next Trainer '
        'warned (%s) and resumed from serial %d at step %d, its state '
        'bitwise that serial' % (newest, msgs[0][:80], newest - 1,
                                 2 * (k - 1)))
    return dict(emergency_bytes=n_bytes,
                emergency_s=_secs(sp['trainer.checkpoint.emergency_flush']),
                load_s=_secs(sp['trainer.checkpoint.load']),
                verify_s=_secs(sp['checkpoint.verify']),
                resumed_at=k + 1, fallback_serial=newest - 1)


def _trainer_parity(start, losses, tmp):
    """(d) bundle_steps=TRAINER_BUNDLE and (e) sync='async' from (a)'s start
    weights over (a)'s first TRAINER_PARITY_STEPS batches: losses against
    (a)'s; the bundled loop's periodic gate fires."""
    from paddle_tpu_torch import fluid
    want = np.asarray(losses[:TRAINER_PARITY_STEPS])
    out = {}
    for what, kw in (('bundled', dict(bundle_steps=TRAINER_BUNDLE,
                                      checkpoint_config=fluid.CheckpointConfig(
                                          checkpoint_dir=os.path.join(
                                              tmp, 'bundled'),
                                          step_interval=TRAINER_BUNDLE_INTERVAL))),
                     ('async', dict(sync='async', async_window=2))):
        tr = transformer_trainer(param_path=start, **kw)
        got, ends = [], []

        def handler(ev):
            if isinstance(ev, fluid.EndStepEvent):
                got.append(ev.metrics[0])
                ends.append(ev.step)

        with _spans('trainer.checkpoint.save') as sp:
            tr.train(num_epochs=1, event_handler=handler,
                     reader=trainer_reader(TRAINER_PARITY_STEPS),
                     feed_order=TRAINER_FEEDS)
        got = np.asarray([float(np.asarray(x).reshape(())) for x in got])
        if ends != list(range(TRAINER_PARITY_STEPS)):
            raise AssertionError('%s: EndStepEvents %r' % (what, ends))
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        if not rel <= TRAINER_PARITY_RTOL:
            raise AssertionError('%s losses %r against %r' % (what, got, want))
        saves = [f['step'] for _, f in sp['trainer.checkpoint.save']]
        if what == 'bundled' and saves != [TRAINER_BUNDLE - 1,
                                           2 * TRAINER_BUNDLE - 1]:
            raise AssertionError('the bundled gate saved at %r' % (saves,))
        bitwise = bool(np.array_equal(got, want))
        out[what] = dict(max_rel=rel, bitwise=bitwise, saves=saves)
        log('[trainer] (%s) %s: %d losses against (a)\'s: max relative diff '
            '%.3g, bitwise %s%s' % (
                'd' if what == 'bundled' else 'e', what,
                TRAINER_PARITY_STEPS, rel, bitwise,
                '; periodic saves at steps %r' % saves if saves else ''))
        del tr
        _release()
    return out


def _trainer_input_stage():
    """(g) The conv MNIST net of tests/test_book_high_level_api.py (8
    filters) at models/mnist.py's batch 128, Adam 1e-3, one epoch with
    double_buffer off and then on: steps/s and the median input-stage
    wait a step. A finding, not a check."""
    import torch
    from paddle_tpu_torch import batch, fluid
    from paddle_tpu_torch.dataset import mnist

    def train_func():
        img = fluid.layers.data(name='img', shape=[1, 28, 28],
                                dtype='float32')
        conv = fluid.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=8, pool_size=2,
            pool_stride=2, act='relu')
        predict = fluid.layers.fc(input=conv, size=10, act='softmax')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        avg = fluid.layers.mean(
            fluid.layers.cross_entropy(input=predict, label=label))
        return [avg, fluid.layers.accuracy(input=predict, label=label)]

    out = {}
    for db in (False, True):
        tr = fluid.Trainer(
            train_func=train_func,
            optimizer_func=lambda: fluid.optimizer.Adam(learning_rate=1e-3),
            place=fluid.CUDAPlace(0), double_buffer=db)
        losses = []
        with _spans('trainer.input_stage', 'trainer.step') as sp:
            t0 = time.perf_counter()
            tr.train(num_epochs=1, event_handler=lambda ev: losses.append(
                ev.metrics[0]) if isinstance(ev, fluid.EndStepEvent)
                else None, reader=batch(mnist.train(), TRAINER_MNIST_BATCH),
                feed_order=['img', 'label'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        waits = _secs(sp['trainer.input_stage'])
        steps = _secs(sp['trainer.step'])
        if not np.isfinite([float(np.asarray(x).reshape(-1)[0])
                            for x in losses]).all():
            raise AssertionError('MNIST losses %r' % (losses,))
        out['on' if db else 'off'] = dict(
            steps=len(losses), steps_per_s=len(losses) / wall,
            median_input_wait_ms=float(np.median(waits)) * 1e3,
            mean_input_wait_ms=float(np.mean(waits)) * 1e3,
            median_step_ms=float(np.median(steps[2:])) * 1e3)
        del tr
        _release()
    for k in ('off', 'on'):
        r = out[k]
        log('[trainer] (g) MNIST conv net, batch %d, double_buffer %s: %d '
            'steps, %.1f steps/s, input-stage wait median %.4f ms (mean '
            '%.4f), median replayed step %.4f ms' % (
                TRAINER_MNIST_BATCH, k, r['steps'], r['steps_per_s'],
                r['median_input_wait_ms'], r['mean_input_wait_ms'],
                r['median_step_ms']))
    return out


def phase_trainer():
    """(a) Transformer-base through fluid.Trainer at full width on the card
    (the main path: its launch counts), (b)-(c) preemption, resume and the
    torn-serial fallback, (d)-(e) bundled and async parity, (f) test() and
    the Inferencer, (g) the input stage of a host-bound net. Returns
    {'trainer': launch counts of (a)}."""
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trainer_') as tmp:
        launches, losses, start, rec = _trainer_main(tmp)
        rec['preemption'] = _trainer_preemption(tmp)
        rec['parity'] = _trainer_parity(start, losses, tmp)
    rec['mnist_input_stage'] = _trainer_input_stage()
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log('[trainer] phase 7g took %.1f s' % rec['seconds'])
    log(json.dumps({'trainer': rec}))
    return {'trainer': launches}


# -- phase 7h ---------------------------------------------------------------

def _stream_funcs(held):
    """train_func (DeepFM at full width, both FM tables is_sparse,
    returning [avg_cost]; its prob kept in `held` for the scorer) and
    optimizer_func (Adam(CTR_LR)) of the streaming Trainer."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import deepfm

    def train_func():
        fluid.default_main_program().random_seed = SEED
        fluid.default_startup_program().random_seed = SEED
        feat = fluid.layers.data(name='feat_ids', shape=[deepfm.NUM_FIELDS],
                                 dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        cost, held['prob'], _ = deepfm.deepfm(
            feat, label, embed_dim=CTR_EMBED_DIM, is_sparse=True)
        return [cost]

    return train_func, lambda: fluid.optimizer.Adam(learning_rate=CTR_LR)


def stream_trainer(held, **kw):
    from paddle_tpu_torch import fluid
    train_func, optimizer_func = _stream_funcs(held)
    return fluid.Trainer(train_func=train_func, optimizer_func=optimizer_func,
                         place=fluid.CUDAPlace(0), **kw)


def stream_reader(state):
    """The JAX bench.py:826-836 stream at DeepFM's shape: batch CTR_BATCH of
    26 ids, each the base (STREAM_DRIFT ids further each step) plus a
    Zipf(1.5) draw, mod 2^30, with 0/1 labels. `state` carries the step and
    the generator across train_stream calls; state['last'] is the newest
    batch's raw ids (the client thread's source)."""
    from paddle_tpu_torch.models import deepfm
    F = deepfm.NUM_FIELDS

    def reader():
        while True:
            t = state['t']
            state['t'] = t + 1
            rng = state['rng']
            base = (t * STREAM_DRIFT) % STREAM_UNIVERSE
            ids = (base + rng.zipf(1.5, size=(CTR_BATCH, F))) \
                % STREAM_UNIVERSE
            labels = rng.randint(0, 2, size=(CTR_BATCH, 1))
            state['last'] = ids
            yield [(ids[i], labels[i]) for i in range(CTR_BATCH)]

    return reader


def _stream_serving(tr, held, tmp):
    """The DeepFM scorer (feat_ids -> prob) saved from the trainer's startup
    state, behind two warmed-up ServingEngines in a Router. Returns (router,
    engines, scorer dir)."""
    from paddle_tpu_torch import fluid, inference, serving
    from paddle_tpu_torch.models import deepfm
    d = os.path.join(tmp, 'scorer')
    with fluid.scope_guard(tr.scope):
        fluid.io.save_inference_model(d, ['feat_ids'], [held['prob']],
                                      tr.exe, main_program=tr.train_program)
    engines = []
    for _ in range(2):
        eng = serving.ServingEngine(inference.Predictor(d),
                                    serving.ServingConfig(
                                        max_batch_size=max(STREAM_BUCKETS),
                                        buckets=list(STREAM_BUCKETS)))
        eng.warmup(example_feed={'feat_ids': np.zeros(
            (1, deepfm.NUM_FIELDS), 'int64')})
        engines.append(eng)
    return serving.Router().add_model('deepfm', engines), engines, d


class _StreamClient(object):
    """A client thread sending 1-STREAM_CLIENT_ROWS-row requests of the
    stream's newest ids, translated by the vocab's read-only lookup (the
    serving side of the map), through Router.predict; every
    STREAM_PROBE_EVERY-th request is the 16-row probe (alone in its batch:
    the client waits for each answer, and 16 rows fill the largest
    bucket)."""

    def __init__(self, router, vt, state, probe):
        import threading
        self.router, self.vt, self.state, self.probe = router, vt, state, \
            probe
        self.stop = threading.Event()
        self.latency_s, self.probe_answers, self.errors = [], [], []
        self.thread = threading.Thread(target=self._run, name='stream-client',
                                       daemon=True)

    def _run(self):
        rng = np.random.RandomState(SEED + 7)
        n = 0
        try:
            while not self.stop.is_set():
                n += 1
                if n % STREAM_PROBE_EVERY == 0:
                    out = self.router.predict('deepfm', self.probe,
                                              timeout=60)
                    self.probe_answers.append(out[0].tobytes())
                    continue
                rows = rng.randint(1, STREAM_CLIENT_ROWS + 1)
                raw = self.state['last'][rng.randint(0, CTR_BATCH, rows)]
                feed = {'feat_ids': self.vt.lookup(raw)}
                t0 = time.perf_counter()
                out = self.router.predict('deepfm', feed, timeout=60)
                self.latency_s.append(time.perf_counter() - t0)
                if out[0].shape != (rows, 1) or \
                        not np.isfinite(out[0]).all():
                    raise AssertionError('a served answer %r' % (out[0],))
        except Exception as e:        # reported by the phase
            self.errors.append(e)


@contextlib.contextmanager
def _timed_calls(targets):
    """{label: [seconds, calls]} of the calls to each (owner, attribute,
    label) in `targets` while the context is open, on whatever thread
    makes them (the host split of the streaming loop)."""
    got = {label: [0.0, 0] for _, _, label in targets}
    # (owner, attribute, its own binding or None when inherited)
    saved = [(owner, attr, vars(owner).get(attr)) for owner, attr, _ in
             targets]

    def timed(fn, label):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                got[label][0] += time.perf_counter() - t0
                got[label][1] += 1
        return call

    for owner, attr, label in targets:
        setattr(owner, attr, timed(getattr(owner, attr), label))
    try:
        yield got
    finally:
        for owner, attr, own in saved:
            if own is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)


def _stream_boundaries(router, engines, probe, pub, pushes):
    """Wrap router.push_deltas: record each push's ms, rows and freshness
    lag (the publisher's: the push's end minus the oldest touch it
    carries) into `pushes` and, right after it, take the probe's answer on
    every replica (the answers at the push boundaries)."""
    real = router.push_deltas
    boundary = [e.predict(probe)[0].tobytes() for e in engines]

    def push_deltas(model_id, deltas):
        oldest = pub._oldest_touch
        t0 = time.perf_counter()
        n = real(model_id, deltas)
        pushes.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                           rows=sum(len(r) for r, _ in deltas.values()),
                           lag_s=time.monotonic() - oldest,
                           row_ids=np.asarray(deltas['fm_embed'][0])))
        boundary.extend(e.predict(probe)[0].tobytes() for e in engines)
        return n

    router.push_deltas = push_deltas
    return boundary


def _stream_loop(tmp):
    """(a) the loop and (b)'s checks on it, (c) the preemption. Returns
    (launch counts of the timed steps, the record)."""
    from paddle_tpu_torch import fluid, streaming
    from paddle_tpu_torch.models import deepfm
    held, ckpt = {}, os.path.join(tmp, 'stream')
    t0 = time.perf_counter()
    tr = stream_trainer(held, double_buffer=True,
                        checkpoint_config=fluid.CheckpointConfig(
                            checkpoint_dir=ckpt, step_interval=10 ** 9))
    router, engines, scorer = _stream_serving(tr, held, tmp)
    vt = streaming.VocabTable(deepfm.VOCAB, table='fm_embed',
                              admit_count=STREAM_ADMIT)
    base = STREAM_T0 * STREAM_DRIFT
    vt.preload(range(base - (deepfm.VOCAB - 1), base))
    if vt.stats()['free'] != 0:
        raise AssertionError('the preloaded vocab is not full: %r'
                             % (vt.stats(),))
    pub = streaming.DeltaPublisher(router, 'deepfm',
                                   interval_steps=STREAM_PUBLISH_EVERY)
    build_s = time.perf_counter() - t0
    log('[stream] built the DeepFM Trainer, saved its startup scorer, warmed '
        'two replicas (buckets %s) and preloaded %d raw ids in %.3f s'
        % (list(STREAM_BUCKETS), len(vt), build_s))
    clients = []
    try:
        launches, rec = _stream_run(tr, vt, pub, router, engines, scorer,
                                    clients)
        at_preemption = _trainer_state(tr)
        if not router.shutdown():
            raise AssertionError('a replica did not shut down')
    finally:
        # a failed check must not leave the client or a batcher running
        for client in clients:
            client.stop.set()
            client.thread.join(120)
        router.shutdown(drain=False, timeout=60)
    rec['build_s'] = build_s
    del tr, router, engines, clients
    _release()
    rec['preemption'] = _stream_resume(ckpt, at_preemption)
    return launches, rec


def _stream_run(tr, vt, pub, router, engines, scorer, clients):
    """The body of (a) and (b) on the built loop; the client it starts goes
    into `clients`. Returns (launch counts of the timed steps, the
    record)."""
    import signal
    import torch
    import warnings
    from paddle_tpu_torch import fluid
    state = {'t': STREAM_T0, 'rng': np.random.RandomState(SEED)}
    reader = stream_reader(state)
    # the warm-up and the capture, then the probe: the rows of the newest
    # batch's first 16 examples (rows the stream keeps training)
    tr.train_stream(reader, vocabs={'feat_ids': vt}, publisher=pub,
                    max_steps=STREAM_WARM)
    probe = {'feat_ids': vt.lookup(state['last'][:max(STREAM_BUCKETS)])}
    pushes = []
    boundary = _stream_boundaries(router, engines, probe, pub, pushes)
    captures0 = tr.exe.cache_stats['captures']
    client = _StreamClient(router, vt, state, probe)
    clients.append(client)
    client.thread.start()
    st0 = vt.stats()
    _reset_launch_counts()
    from paddle_tpu_torch.fluid import data_feeder, step_artifact
    from paddle_tpu_torch.streaming import publish, vocab
    split = [(vt, 'translate', 'translate (worker)'),
             (data_feeder.DataFeeder, 'feed', 'feed assembly (worker)'),
             (tr.exe, '_place_feed', 'pinned staging (worker)'),
             (tr.exe, 'run', 'Executor.run'),
             (vocab.Lease, 'release', 'lease release'),
             (vocab.RowResetter, 'reset', 'row resets'),
             (step_artifact.StepArtifact, 'touched_rows', 'touched rows'),
             (publish.DeltaPublisher, 'collect', 'publisher collect'),
             (publish.DeltaPublisher, 'maybe_publish',
              'publish (with the probe answers)')]
    with _spans('trainer.step', 'trainer.input_stage',
                'streaming.publish') as sp, _timed_calls(split) as calls:
        t1 = time.perf_counter()
        n = tr.train_stream(reader, vocabs={'feat_ids': vt}, publisher=pub,
                            max_steps=STREAM_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches = _launch_counts()
    st1 = vt.stats()
    captures1 = tr.exe.cache_stats['captures']
    timed_pushes = list(pushes)
    want = dict.fromkeys(launches, 0)
    want['sparse_adam'] = 2 * STREAM_STEPS
    if n != STREAM_STEPS or launches != want:
        raise AssertionError('the stream ran %d steps and launched %r; the '
                             'path must launch %r' % (n, launches, want))
    if captures1 != captures0 or captures0 != 1:
        raise AssertionError('captures %d before the stream, %d after'
                             % (captures0, captures1))
    admitted = (st1['rows_admitted'] - st0['rows_admitted']) / STREAM_STEPS
    evicted = (st1['rows_evicted'] - st0['rows_evicted']) / STREAM_STEPS
    if not admitted > 0 or not evicted > 0 or not timed_pushes:
        raise AssertionError('the timed steps admitted %.1f and evicted %.1f '
                             'rows a step in %d pushes'
                             % (admitted, evicted, len(timed_pushes)))
    step_s = _secs(sp['trainer.step'])

    # (b) the zero checks, then (c) a SIGTERM at a boundary
    drained = []
    drain = vt.drain_resets

    def record():
        rows = drain()
        drained.extend(rows)
        return rows

    vt.drain_resets = record
    names = ['fm_embed', 'moment1_fm_embed_0', 'moment2_fm_embed_0']
    zeroed, seen = [], []
    prev = signal.getsignal(signal.SIGTERM)

    def handler(ev):
        if not isinstance(ev, fluid.BeginStepEvent):
            return
        seen.append(ev.step)
        if drained:
            idx = torch.as_tensor(drained,
                                  device=tr.scope.vars[names[0]].device)
            for nm in names:
                if tr.scope.vars[nm].index_select(0, idx).any():
                    raise AssertionError('an evicted row of %s is not zero '
                                         'after the boundary' % nm)
            zeroed.append(len(drained))
            del drained[:]
        if len(seen) == STREAM_PREEMPT_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        n2 = tr.train_stream(reader, event_handler=handler,
                             vocabs={'feat_ids': vt}, publisher=pub,
                             max_steps=STREAM_CHECK_STEPS)
    vt.drain_resets = drain
    if signal.getsignal(signal.SIGTERM) is not prev:
        raise AssertionError('train_stream left its SIGTERM handler')
    if not tr.preempted or n2 != STREAM_PREEMPT_AT or not any(
            'emergency checkpoint flushed' in str(w.message) for w in rec):
        raise AssertionError('no preemption at the %d-th boundary: %d steps'
                             % (STREAM_PREEMPT_AT, n2))
    if not zeroed:
        raise AssertionError('no eviction at the checked boundaries')
    client.stop.set()
    client.thread.join(120)
    if client.errors:
        raise client.errors[0]

    # the final publish; the probe answers never torn; the replicas' answer
    # against the trainer-side Predictor on the trainer's FM tables
    pub.publish(lambda name: tr.scope._chain_get(name))
    if not pushes[-1]['row_ids'].size:
        raise AssertionError('the final publish carried no row')
    known = set(boundary)
    torn = [a for a in client.probe_answers if a not in known]
    if not client.probe_answers or torn:
        raise AssertionError('%d of %d probe answers are none of the %d '
                             'answers at the push boundaries' % (
                                 len(torn), len(client.probe_answers),
                                 len(known)))
    check = _stream_final_check(tr, pushes[-1]['row_ids'], engines, scorer)
    lags = [p['lag_s'] for p in timed_pushes]
    rec = dict(
        steps=STREAM_STEPS, wall_s=wall, steps_per_s=STREAM_STEPS / wall,
        median_step_ms=float(np.median(step_s)) * 1e3,
        step_ms=[x * 1e3 for x in step_s],
        median_input_wait_ms=float(np.median(
            _secs(sp['trainer.input_stage']))) * 1e3,
        admitted_per_step=admitted, evicted_per_step=evicted,
        vocab=st1, sparse_adam_per_step=launches['sparse_adam'] // n,
        captures_before=captures0, captures_after=captures1,
        pushes=len(timed_pushes),
        rows_per_push=[p['rows'] for p in timed_pushes],
        push_ms=[p['ms'] for p in timed_pushes],
        median_push_ms=float(np.median([p['ms'] for p in timed_pushes])),
        publish_ms=[x * 1e3 for x in _secs(sp['streaming.publish'])],
        freshness_lag_s=lags, median_freshness_lag_s=float(np.median(lags)),
        publisher=pub.stats(), client_requests=len(client.latency_s),
        client_p50_ms=float(np.median(client.latency_s)) * 1e3,
        client_p99_ms=float(np.percentile(client.latency_s, 99)) * 1e3,
        probe_answers=len(client.probe_answers),
        boundary_answers=len(known), evicted_rows_checked=sum(zeroed),
        host_split_ms_per_step={k: v[0] * 1e3 / n for k, v in calls.items()},
        host_split_calls={k: v[1] for k, v in calls.items()}, **check)
    log('[stream] (a) %d timed steps in %.3f s: %.1f steps/s (%.0f '
        'examples/s); trainer.step median %.3f ms; input-stage wait median '
        '%.4f ms; %.1f rows admitted and %.1f evicted a step; %d sparse_adam '
        'launches a step; captures %d before the stream, %d after' % (
            STREAM_STEPS, wall, rec['steps_per_s'],
            rec['steps_per_s'] * CTR_BATCH, rec['median_step_ms'],
            rec['median_input_wait_ms'], admitted, evicted,
            rec['sparse_adam_per_step'], captures0, captures1))
    log('[stream] (a) %d pushes into 2 replicas: %d-%d rows (median %d), '
        'push ms %.3f-%.3f (median %.3f); freshness lag %.4f-%.4f s '
        '(median %.4f); client: %d requests, p50 %.3f ms, p99 %.3f ms' % (
            len(timed_pushes), min(rec['rows_per_push']),
            max(rec['rows_per_push']), np.median(rec['rows_per_push']),
            min(rec['push_ms']), max(rec['push_ms']), rec['median_push_ms'],
            min(lags), max(lags), rec['median_freshness_lag_s'],
            rec['client_requests'], rec['client_p50_ms'],
            rec['client_p99_ms']))
    log('[stream] (a) host ms a step: %s' % ', '.join(
        '%s %.3f' % kv for kv in rec['host_split_ms_per_step'].items()))
    log('[stream] (b) %d evicted rows zero in fm_embed and both moments '
        'after their boundaries; %d probe answers, each one of the %d '
        'answers at the push boundaries; served against the trainer-side '
        'Predictor: %.3g (tol %g of max(1, |score|))' % (
            sum(zeroed), len(client.probe_answers), len(known),
            check['served_max_err'], STREAM_SERVE_TOL))
    log('[stream] rows where a replica differs from the trainer after the '
        'final publish: %s (zeroed for ids translated ahead of a stop, never '
        'trained, so never pushed)' % check['stale_rows'])
    return launches, rec


def _stream_final_check(tr, rows, engines, scorer):
    """After the final publish: each replica's answer for 16 examples of the
    rows that publish carried against a Predictor of the same scorer given
    the trainer's FM tables (the dense layers are never pushed: both keep
    the startup weights), and the replicas' copies of those rows bitwise
    the trainer's. Also counts the rows where a replica's table differs
    from the trainer's: rows zeroed at a boundary for ids whose batch was
    translated ahead and never trained (prefetched past a stop), which no
    step touched and so no publish carries (a finding, not a check)."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import deepfm
    n = 16 * deepfm.NUM_FIELDS
    rows = np.resize(np.asarray(rows, 'int64'), n).reshape(
        16, deepfm.NUM_FIELDS)
    feed = {'feat_ids': rows}
    ref = inference.Predictor(scorer)
    for name in ('fm_embed', 'fm_first_w'):
        with torch.no_grad():
            ref._scope.vars[name].copy_(tr.scope.vars[name])
    want = ref.run(feed)[0]
    err, stale = 0.0, []
    idx = torch.as_tensor(rows.reshape(-1),
                          device=tr.scope.vars['fm_embed'].device)
    for eng in engines:
        got = eng.predict(feed, timeout=60)[0]
        err = max(err, float(np.max(np.abs(got - want)
                                    / np.maximum(1.0, np.abs(want)))))
        served = eng._model._scope.vars['fm_embed']
        trained = tr.scope.vars['fm_embed']
        for name in ('fm_embed', 'fm_first_w'):
            if not torch.equal(eng._model._scope.vars[name][idx],
                               tr.scope.vars[name][idx]):
                raise AssertionError('a replica\'s %s rows differ from the '
                                     'trainer\'s after the final publish'
                                     % name)
        stale.append(int((served != trained).any(dim=1).sum()))
    if not err <= STREAM_SERVE_TOL:
        raise AssertionError('the served answer is %.3g from the '
                             'trainer-side Predictor\'s' % err)
    return dict(served_max_err=err, served_score=float(want.max()),
                stale_rows=stale)


def _stream_resume(ckpt, at_preemption):
    """(c) the emergency serial's meta holds streaming_vocab; a fresh
    Trainer over the dir resumes the same map and bitwise the same
    state."""
    import torch
    from paddle_tpu_torch import fluid, streaming
    from paddle_tpu_torch.models import deepfm
    serial, sdir, meta = _newest_serial(fluid, ckpt)
    args = meta['trainer_args']
    vocab_state = (args.get('streaming_vocab') or {}).get('feat_ids')
    if not args.get('preempted') or not vocab_state or \
            len(vocab_state['entries']) != deepfm.VOCAB - 1:
        raise AssertionError('the emergency serial %d holds no streaming '
                             'vocab of the full table' % serial)
    t0 = time.perf_counter()
    tr2 = stream_trainer({}, checkpoint_config=fluid.CheckpointConfig(
        checkpoint_dir=ckpt, step_interval=10 ** 9))
    load_s = time.perf_counter() - t0
    vt2 = streaming.VocabTable(deepfm.VOCAB, table='fm_embed',
                               admit_count=STREAM_ADMIT)
    tr2.train_stream(lambda: iter(()), vocabs={'feat_ids': vt2})
    if vt2.state_dict() != vocab_state:
        raise AssertionError('the resumed vocab differs from the preempted '
                             'one')
    got = _trainer_state(tr2)
    differ = [n for n, t in at_preemption.items()
              if not torch.equal(got[n], t)]
    if sorted(got) != sorted(at_preemption) or differ:
        raise AssertionError('the resumed state differs in %r' % differ[:8])
    with open(os.path.join(sdir, 'meta.json')) as f:
        meta_bytes = len(f.read())
    log('[stream] (c) SIGTERM at a boundary: emergency serial %d (%d params '
        'bytes, meta %d bytes with the vocab of %d residents and %d pending '
        'counts); a fresh Trainer (%.3f s) resumed the same map and all %d '
        'persistables bitwise' % (
            serial, meta['params_bytes'], meta_bytes, len(vt2),
            len(vocab_state['pending']), load_s, len(got)))
    del tr2
    _release()
    return dict(serial=serial, params_bytes=meta['params_bytes'],
                meta_bytes=meta_bytes, resume_s=load_s,
                residents=len(vt2), pending=len(vocab_state['pending']))


def _stream_identity():
    """(b) An identity vocab (preload(range(100000)), cold_row=None):
    train_stream over STREAM_IDENTITY batches of synthetic_ctr_reader is
    bitwise Trainer.train over the same batches, from the same state."""
    import torch
    from paddle_tpu_torch import fluid, reader, streaming
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.models import deepfm
    batches = reader.firstn(batch(deepfm.synthetic_ctr_reader(tag='train'),
                                  CTR_BATCH), STREAM_IDENTITY)
    a, b = stream_trainer({}), stream_trainer({})
    with torch.no_grad():
        for n, t in a.scope.vars.items():
            if isinstance(t, torch.Tensor):
                b.scope.vars[n].copy_(t)
    la, lb = [], []

    def losses(sink):
        return lambda ev: sink.append(float(np.asarray(
            ev.metrics[0]).reshape(-1)[0])) \
            if isinstance(ev, fluid.EndStepEvent) else None

    a.train(num_epochs=1, event_handler=losses(la), reader=batches,
            feed_order=['feat_ids', 'label'])
    vt = streaming.VocabTable(deepfm.VOCAB, table='fm_embed', admit_count=1,
                              cold_row=None)
    vt.preload(range(deepfm.VOCAB))
    b.train_stream(batches, event_handler=losses(lb),
                   vocabs={'feat_ids': vt}, feed_order=['feat_ids', 'label'])
    sa, sb = _trainer_state(a), _trainer_state(b)
    differ = [n for n in sa if not torch.equal(sa[n], sb[n])]
    if la != lb or len(la) != STREAM_IDENTITY or differ:
        raise AssertionError('the identity-vocab stream differs from train(): '
                             'losses %r / %r, persistables %r'
                             % (la, lb, differ[:8]))
    log('[stream] (b) identity vocab: train_stream over %d batches bitwise '
        'Trainer.train (losses %s; %d persistables)'
        % (STREAM_IDENTITY, ', '.join('%.4f' % x for x in la), len(sa)))
    del a, b
    _release()
    return dict(identity_steps=STREAM_IDENTITY, identity_losses=la)


def phase_stream():
    """(a) online DeepFM training over a drifting stream through
    Trainer.train_stream, a VocabTable, a DeltaPublisher and a Router of
    two live replicas (the main path: its launch counts), (b) the checks
    on it and the identity drill, (c) preemption and resume. Returns
    {'stream': launch counts of (a)'s timed steps}."""
    import torch
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_stream_') as tmp:
        launches, rec = _stream_loop(tmp)
    rec.update(_stream_identity())
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log('[stream] phase 7h took %.1f s' % rec['seconds'])
    log(json.dumps({'stream': rec}))
    return {'stream': launches}


# -- phase 7i: token streaming and the compiled serving artifact ------------

def _token_stream_burst(router, reqs, cancel=()):
    """Every request of `reqs` through Router.stream from TOKEN_CLIENTS
    client threads (request i on thread i mod TOKEN_CLIENTS, one at a
    time); the requests in `cancel` are cancelled by their client after
    TOKEN_CANCEL_AFTER tokens. Returns (per request dict(t, arrivals,
    ttft_s, result or error), seconds)."""
    import threading
    out = [None] * len(reqs)
    errors = []

    def client(k):
        try:
            for i in range(k, len(reqs), TOKEN_CLIENTS):
                enc, n = reqs[i]
                s = router.stream('mt', {'enc': enc}, max_new_tokens=n)
                ts, arrivals = [], []
                for t, _ in s:
                    ts.append(t)
                    arrivals.append(time.perf_counter())
                    if i in cancel and t >= TOKEN_CANCEL_AFTER:
                        s.cancel()
                        break
                rec = dict(t=ts, arrivals=arrivals, ttft_s=s.ttft_s)
                try:
                    rec['result'] = s.result(600)
                except Exception as e:       # a cancelled stream's
                    rec['error'] = e
                out[i] = rec
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(TOKEN_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    secs = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return out, secs


def _predict_burst(router, reqs):
    """The same requests through Router.predict from TOKEN_CLIENTS
    threads. Returns (results, seconds)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(TOKEN_CLIENTS) as pool:
        results = list(pool.map(
            lambda r: router.predict('mt', {'enc': r[0]},
                                     max_new_tokens=r[1], timeout=600),
            reqs))
    return results, time.perf_counter() - t0


def _same_decode(got, want):
    """(equal tokens, scores within DECODE_SCORE_TOL (1 + |s|), bitwise,
    largest score difference)."""
    d = np.abs(np.asarray(got[1]) - np.asarray(want[1]))
    return (np.array_equal(got[0], want[0]),
            bool((d <= DECODE_SCORE_TOL * (1 + np.abs(want[1]))).all()),
            np.array_equal(got[0], want[0]) and np.array_equal(
                np.asarray(got[1]).view(np.int32),
                np.asarray(want[1]).view(np.int32)),
            float(d.max()))


def _check_delivered(what, ts, result, n):
    """A stream's delivered t: 1..m once each and in order, m = n, or m < n
    where every beam ended at step m (the result padded with end_id)."""
    m = len(ts)
    if ts != list(range(1, m + 1)) or m > n or (
            m < n and not (np.asarray(result[0])[:, m:]
                           == DECODE_CONFIG['end_id']).all()):
        raise AssertionError('%s delivered t %r (limit %d)' % (what, ts, n))


def _pages_available(eng):
    """Pages free or held only by the prefix cache with no user (free to
    evict): what a drained engine must give back whole."""
    return (eng._hist_pool.free_count,
            eng._enc_pool.available(eng._prefix))


def _failover_stream(eng_a, eng_b, enc, n):
    """One stream moved between engines at its second checkpoint, as the
    JAX package's pod failover does it (serving/pod.py:2061-2140, not
    ported yet): engine A streams into a TokenStream with checkpoints
    every TOKEN_CKPT_EVERY tokens; at the second, A is told to cancel; the
    checkpoint's tokens are replayed into the stream (which must drop the
    ones it has) and engine B resumes from the checkpoint into the same
    stream, whose future B's result completes. Returns (delivered t list,
    result, the checkpoint's step)."""
    import threading
    from paddle_tpu_torch import serving
    s = serving.TokenStream('mt')
    outer = concurrent.futures.Future()
    s._attach(outer)
    moved = threading.Event()
    held = {}

    def sink(state):
        held.setdefault('n', 0)
        held['n'] += 1
        if held['n'] == 2:
            held['ckpt'] = state
            eng_a.cancel(held['fut'])
            moved.set()

    held['fut'] = eng_a.submit({'enc': enc}, max_new_tokens=n,
                               on_token=s._on_token, checkpoint=sink,
                               ckpt_every=TOKEN_CKPT_EVERY)
    delivered = []

    def consume():
        for t, _ in s:
            delivered.append(t)

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    if not moved.wait(300):
        raise AssertionError('no second checkpoint within 300 s')
    try:
        held['fut'].result(60)
        raise AssertionError('engine A finished a cancelled stream')
    except serving.StreamCancelled:
        pass
    ckpt = held['ckpt']
    for t in range(1, int(ckpt['step']) + 1):      # the replay
        s._on_token(t, ckpt['ids'][t - 1])
    fut_b = eng_b.submit({'enc': enc}, max_new_tokens=n, resume=ckpt,
                         on_token=s._on_token)
    fut_b.add_done_callback(
        lambda f: outer.set_exception(f.exception()) if f.exception()
        else outer.set_result(f.result()))
    result = outer.result(600)
    th.join(60)
    return delivered, result, int(ckpt['step'])


def _percentiles(xs, ps=(50, 99)):
    return [float(np.percentile(xs, p)) for p in ps] if xs else \
        [float('nan')] * len(ps)


def _token_streaming(rec):
    """(a)-(d) of phase 7i; returns the token_stream path's launch counts
    (the streamed burst of (a))."""
    from paddle_tpu_torch import serving
    weights = mt_decoder_weights()
    reqs = decode_requests()
    cfg = serving.DecodeConfig(**DECODE_CONFIG)
    eng = serving.DecodeEngine(weights, cfg)
    eng_b = serving.DecodeEngine(weights, cfg)
    router = serving.Router(window_s=0.0)
    router.add_model('mt', [eng])
    try:
        eng.warmup()
        eng_b.warmup()
        tok0, steps_p = eng.stats['tokens'], eng._handle.steps
        want, plain_s = _predict_burst(router, reqs)
        plain_tokens = eng.stats['tokens'] - tok0
        plain_dispatches = eng._handle.steps - steps_p
        caps = eng.cache_stats()['captures']

        # (a) the main path: the same burst streamed
        st0, steps0 = eng.stats, eng._handle.steps
        _reset_launch_counts()
        streams, secs = _token_stream_burst(router, reqs)
        launches = _launch_counts()
        st1, steps1 = eng.stats, eng._handle.steps
        bitwise, worst, gaps = True, 0.0, []
        for i, (srec, w) in enumerate(zip(streams, want)):
            _check_delivered('stream %d' % i, srec['t'], srec['result'],
                             reqs[i][1])
            toks_eq, sc_ok, bits, d = _same_decode(srec['result'], w)
            if not (toks_eq and sc_ok):
                raise AssertionError('stream %d: its result differs from '
                                     'Router.predict of the same request '
                                     '(largest score difference %.3g)'
                                     % (i, d))
            bitwise &= bits
            worst = max(worst, d)
            gaps += list(np.diff(srec['arrivals']))
        dispatches = steps1 - steps0
        syncs = st1['host_syncs'] - st0['host_syncs']
        want_l = dict.fromkeys(launches, 0)
        want_l['paged_attention'] = dispatches
        if launches != want_l:
            raise AssertionError('the streamed burst launched %r over %d '
                                 'dispatches; it must launch %r'
                                 % (launches, dispatches, want_l))
        if syncs != dispatches:
            raise AssertionError('the streamed burst made %d host copies '
                                 'over %d dispatches: one a dispatch'
                                 % (syncs, dispatches))
        ttft = _percentiles([r['ttft_s'] for r in streams])
        gap = _percentiles(gaps)
        tokens = st1['tokens'] - st0['tokens']
        rec['a'] = dict(
            requests=len(reqs), tokens=tokens, seconds=secs,
            tokens_per_s=tokens / secs, plain_seconds=plain_s,
            plain_tokens_per_s=plain_tokens / plain_s,
            plain_dispatches=plain_dispatches,
            ttft_p50_s=ttft[0], ttft_p99_s=ttft[1], gap_p50_s=gap[0],
            gap_p99_s=gap[1], dispatches=dispatches, host_syncs=syncs,
            host_syncs_per_dispatch=syncs / dispatches,
            paged_attention_launches=launches['paged_attention'],
            bitwise=bitwise, max_score_diff=worst)
        log('[serving_stream] (a) %d streams from %d client threads: %d '
            'tokens in %.4f s, %.1f tokens/s (the same burst through '
            'Router.predict: %.4f s, %.1f tokens/s, %d dispatches); client '
            'TTFT p50 %.6f s p99 %.6f s; inter-token gap p50 %.6f s p99 '
            '%.6f s; %d dispatches, %d host copies (%.3f a dispatch), '
            'paged_attention launches %d; results equal to Router.predict '
            '(bitwise: %s, largest score difference %.3g)'
            % (len(reqs), TOKEN_CLIENTS, tokens, secs, tokens / secs, plain_s,
               plain_tokens / plain_s, plain_dispatches, ttft[0], ttft[1],
               gap[0], gap[1], dispatches, syncs, syncs / dispatches,
               launches['paged_attention'], bitwise, worst))

        # (b) cancel TOKEN_CANCELS streams after TOKEN_CANCEL_AFTER tokens
        # the longest requests: each far from its end when cancelled
        cancel = set(sorted(range(len(reqs)),
                            key=lambda i: -reqs[i][1])[:TOKEN_CANCELS])
        avail0, free0 = _pages_available(eng), eng.stats['pages_free']
        c0 = eng.stats['cancelled']
        streams_b, _ = _token_stream_burst(router, reqs, cancel=cancel)
        deadline = time.monotonic() + 60
        while (eng.stats['slots_occupied'] or _pages_available(eng)
               != avail0) and time.monotonic() < deadline:
            time.sleep(0.01)
        cancelled = eng.stats['cancelled'] - c0
        bitwise_b = True
        for i, srec in enumerate(streams_b):
            if i in cancel:
                if not isinstance(srec.get('error'), serving.StreamCancelled):
                    raise AssertionError('cancelled stream %d resolved to %r'
                                         % (i, srec.get('result',
                                                        srec.get('error'))))
                continue
            toks_eq, sc_ok, bits, d = _same_decode(srec['result'], want[i])
            if not (toks_eq and sc_ok):
                raise AssertionError('stream %d changed beside the cancelled '
                                     'ones (%.3g)' % (i, d))
            bitwise_b &= bits
        if cancelled != TOKEN_CANCELS or _pages_available(eng) != avail0:
            raise AssertionError(
                '%d streams cancelled (want %d); pages free or evictable '
                '%r after the drain, %r before' % (
                    cancelled, TOKEN_CANCELS, _pages_available(eng),
                    avail0))
        rec['b'] = dict(cancelled=cancelled, pages_available=avail0,
                        pages_free_before=free0,
                        pages_free_after=eng.stats['pages_free'],
                        others_bitwise=bitwise_b)
        log('[serving_stream] (b) %d streams cancelled after %d tokens: '
            'cancelled %d; history pages free and encoder pages free or '
            'evictable %r before and after (pages_free %d before, %d after: '
            'the prefix cache holds what it evicts at will); the other %d '
            'results equal to (a) (bitwise: %s)'
            % (len(cancel), TOKEN_CANCEL_AFTER, cancelled, avail0, free0,
               eng.stats['pages_free'], len(reqs) - len(cancel), bitwise_b))

        # (c) TOKEN_RESUMES streams moved to engine B at their second
        # checkpoint
        caps_b = eng_b.cache_stats()['captures']
        movable = [i for i, (_, n) in enumerate(reqs)
                   if n >= 4 * TOKEN_CKPT_EVERY][:TOKEN_RESUMES]
        resumed0 = eng_b.stats['resumed']
        bitwise_c = True
        for i in movable:
            enc, n = reqs[i]
            delivered, result, at = _failover_stream(eng, eng_b, enc, n)
            _check_delivered('moved stream %d' % i, delivered, result, n)
            toks_eq, sc_ok, bits, d = _same_decode(result, want[i])
            if not (toks_eq and sc_ok) or at != 2 * TOKEN_CKPT_EVERY:
                raise AssertionError('moved stream %d (at %d): its result '
                                     'differs from (a) (%.3g)' % (i, at, d))
            bitwise_c &= bits
        if eng_b.stats['resumed'] - resumed0 != len(movable) or \
                eng_b.cache_stats()['captures'] != caps_b:
            raise AssertionError('engine B resumed %d of %d streams, its '
                                 'captures %d -> %d'
                                 % (eng_b.stats['resumed'] - resumed0,
                                    len(movable), caps_b,
                                    eng_b.cache_stats()['captures']))
        rec['c'] = dict(moved=len(movable), at_step=2 * TOKEN_CKPT_EVERY,
                        bitwise=bitwise_c, captures_b=caps_b)
        log('[serving_stream] (c) %d streams checkpointed every %d tokens, '
            'moved from engine A to engine B at step %d: every t delivered '
            'once, results equal to (a) (bitwise: %s); engine B resumed %d '
            'with its captures unchanged (%d)'
            % (len(movable), TOKEN_CKPT_EVERY, 2 * TOKEN_CKPT_EVERY,
               bitwise_c, len(movable), caps_b))

        # (d) push TOKEN_PUSH_ROWS target-embedding rows between dispatches
        rng = np.random.RandomState(SEED + 11)
        ids = np.concatenate([[0], rng.choice(
            np.arange(1, MT_DECODER['V']), TOKEN_PUSH_ROWS - 1,
            replace=False)])
        rows = (rng.randn(TOKEN_PUSH_ROWS, MT_DECODER['E'])
                / np.sqrt(MT_DECODER['E'])).astype(np.float32)
        probe_enc, probe_n = reqs[1]
        before = router.predict('mt', {'enc': probe_enc},
                                max_new_tokens=probe_n, timeout=600)
        t0 = time.perf_counter()
        router.push_deltas('mt', {'cbd_w_emb': (ids, rows)})
        push_ms = (time.perf_counter() - t0) * 1e3
        after = router.predict('mt', {'enc': probe_enc},
                               max_new_tokens=probe_n, timeout=600)
        if eng.cache_stats()['captures'] != caps:
            raise AssertionError('engine A captured again: %d -> %d'
                                 % (caps, eng.cache_stats()['captures']))
    finally:
        router.shutdown(drain=False)
        eng_b.shutdown(drain=False)
    pushed = dict(weights, w_emb=weights['w_emb'].copy())
    pushed['w_emb'][ids] = rows
    fresh = serving.DecodeEngine(pushed, cfg)
    try:
        fresh_out = fresh.predict({'enc': probe_enc},
                                  max_new_tokens=probe_n, timeout=600)
    finally:
        fresh.shutdown()
    toks_eq, sc_ok, bits, d = _same_decode(after, fresh_out)
    if not toks_eq or not sc_ok:
        raise AssertionError('the probe after the push differs from a fresh '
                             'engine given the rows (%.3g)' % d)
    changed = not np.array_equal(after[1], before[1])
    rec['d'] = dict(rows=TOKEN_PUSH_ROWS, push_ms=push_ms, bitwise=bits,
                    probe_changed=changed, captures=caps)
    log('[serving_stream] (d) push_rows of %d target-embedding rows: %.3f '
        'ms; the probe after it equal to a fresh engine given the rows '
        '(bitwise: %s; its scores changed by the push: %s); captures %d '
        'before and after (abort, resume and push_rows captured nothing)'
        % (TOKEN_PUSH_ROWS, push_ms, bits, changed, caps))
    return launches


def _transformer_scope(seed, place):
    """Transformer-base (TRANSFORMER_BASE) built and initialized from
    `seed` on `place`. Returns (main, scope, exe, logits var)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, unique_name
    from paddle_tpu_torch.models import transformer as T
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = seed
    scope = fluid.Scope()
    with unique_name.guard(), framework.program_guard(main, startup):
        T.transformer(**TRANSFORMER_BASE)
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    return main, scope, exe, logits_var(main)


def _dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


# a fresh process that imports only paddle_tpu_torch: load each artifact
# given as (tag, dir) pairs and call it three times (warm-up, capture,
# replay); the answers saved beside argv[2]
_COMPILED_CHILD = r"""
import json, sys, time
import numpy as np
import paddle_tpu_torch
from paddle_tpu_torch import inference
feed = dict(np.load(sys.argv[1]))
out = {}
for tag, d in zip(sys.argv[3::2], sys.argv[4::2]):
    t0 = time.perf_counter()
    run = inference.load_compiled(d)
    load_s = time.perf_counter() - t0
    first = run(feed)[0]
    same = all(np.array_equal(run(feed)[0], first) for _ in range(2))
    np.save('%s.%s.npy' % (sys.argv[2], tag), first)
    out[tag] = dict(load_s=load_s, stats=run.cache_stats(), same=same)
bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')
       or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]
print(json.dumps(dict(out, bad=bad)))
"""

# an export in a process of its own, so the three exports of (e) run side
# by side: the saved model's Predictor on the card (transpiled to bf16 with
# argv[4] == 'bf16'), exported at the feed of argv[3]
_EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
from paddle_tpu_torch import fluid, inference
model, out, feed = sys.argv[1], sys.argv[2], dict(np.load(sys.argv[3]))
pred = inference.Predictor(model)
if sys.argv[4] == 'bf16':
    fluid.contrib.Float16Transpiler().transpile(pred._program,
                                                scope=pred._scope)
t0 = time.perf_counter()
inference.export_compiled(out, feed, pred._fetch_vars, pred._exe,
                          main_program=pred._program, scope=pred._scope)
print(json.dumps({'export_s': time.perf_counter() - t0}))
"""


def _child(code, *args):
    """A python process running `code` with `args` from the checkout's root
    (its stdout and stderr piped)."""
    return subprocess.Popen([sys.executable, '-c', code] + list(args),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _child_result(proc, what, timeout=900):
    """The last stdout line of a finished child, as JSON; raise with its
    stderr when it failed."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError('%s failed (rc %d): %s'
                             % (what, proc.returncode, err[-4000:]))
    return json.loads(out.strip().splitlines()[-1])


def _timed_turns(fns, n=COMPILED_CALLS):
    """Median wall ms of a call of each of `fns` ({label: fn}), timed in
    turns A B B A (n calls a turn; results dropped as they come, so no
    call finds its pinned fetch buffer still held)."""
    secs = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for k in order:
        for _ in range(n):
            t0 = time.perf_counter()
            fns[k]()
            secs[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) * 1e3 for k, v in secs.items()}


def _compiled_path(tag, d, feed):
    """One artifact loaded in this process and called three times (warm-up,
    capture, replay): its launch counts (the `tag` path), load seconds, the
    runner and its answer."""
    import torch
    from paddle_tpu_torch import inference
    _reset_launch_counts()
    t0 = time.perf_counter()
    run = inference.load_compiled(d)
    load_s = time.perf_counter() - t0
    first = run(feed)[0]
    for _ in range(2):
        if not np.array_equal(run(feed)[0], first):
            raise AssertionError('%s: the calls disagree' % tag)
    torch.cuda.synchronize()
    launches = _launch_counts()
    stats = run.cache_stats()
    if stats['captures'] != 1 or stats['replays'] != 2:
        raise AssertionError('%s: %r after three calls; one capture and a '
                             'replay for every later call' % (tag, stats))
    return launches, load_s, run, first


def _compiled_artifact(rec, tmp):
    """(e) of phase 7i; returns {'compiled': counts, 'amp_compiled':
    counts}. The fp32 export runs here while two processes export the bf16
    program and generation 2 (a second seed) beside it."""
    import torch
    from paddle_tpu_torch import fluid, inference
    B, T = COMPILED_BATCH, TRANSFORMER_BASE['max_length']
    rng = np.random.RandomState(SEED + 13)
    reqs = make_requests(B, 1, T, TRANSFORMER_BASE['trg_vocab_size'], rng)
    feed = {n: np.concatenate([r[n] for r in reqs]) for n in reqs[0]}
    feed_path = os.path.join(tmp, 'feed.npz')
    np.savez(feed_path, **feed)
    model, model2 = os.path.join(tmp, 'model'), os.path.join(tmp, 'model2')
    for seed, d in ((SEED + 1, model2), (SEED, model)):
        main, scope, exe, logits = _transformer_scope(seed,
                                                      fluid.CUDAPlace(0))
        fluid.io.save_inference_model(d, ['src_word', 'trg_word'], [logits],
                                      exe, main_program=main, scope=scope)
    dirs = {'compiled': os.path.join(tmp, 'fp32'),
            'amp_compiled': os.path.join(tmp, 'bf16')}
    dir2 = os.path.join(tmp, 'gen2')
    t0 = time.perf_counter()
    kids = {'amp_compiled': _child(_EXPORT_CHILD, model, dirs['amp_compiled'],
                                   feed_path, 'bf16'),
            'gen2': _child(_EXPORT_CHILD, model2, dir2, feed_path, 'fp32')}
    export_s = {}
    try:
        t1 = time.perf_counter()
        inference.export_compiled(dirs['compiled'], feed, [logits], exe,
                                  main_program=main, scope=scope)
        export_s['compiled'] = time.perf_counter() - t1
        for tag, kid in kids.items():
            export_s[tag] = _child_result(kid, 'the %s export' % tag)[
                'export_s']
    finally:
        for kid in kids.values():
            if kid.poll() is None:
                kid.kill()
                kid.wait()
    exports_s = time.perf_counter() - t0
    del main, scope, exe
    # a fresh process loads both artifacts while this one does
    fresh = _child(_COMPILED_CHILD, feed_path, os.path.join(tmp, 'child'),
                   *[x for tag in dirs for x in (tag, dirs[tag])])
    try:
        pred = inference.Predictor(model)
        pred16 = transpiled_predictor(model)
        preds = {'compiled': pred, 'amp_compiled': pred16}
        wants = {tag: p.run(feed)[0] for tag, p in preds.items()}
        held = {}

        def held_by(tag, got, want):
            if got.shape != (B, T, TRANSFORMER_BASE['trg_vocab_size']) or \
                    got.dtype != np.float32 or not np.isfinite(got).all():
                raise AssertionError('%s answered %s %r'
                                     % (tag, got.dtype, got.shape))
            if tag == 'compiled':
                err = float((np.abs(got - want)
                             / np.maximum(1.0, np.abs(want))).max())
                ok = err <= COMPILED_TOL
            else:
                err = _rel_l2(got, want)
                ok = err <= AMP_CROSS_DEVICE_TOL
            if not ok:
                raise AssertionError('%s against Predictor.run: %.3g'
                                     % (tag, err))
            return err, bool(np.array_equal(got, want))

        launches, out = {}, {}
        for tag in dirs:
            counts, load_s, run, got = _compiled_path(tag, dirs[tag], feed)
            kern = 'flash_attention_fwd' if tag == 'compiled' \
                else 'flash_attention_fwd_bf16'
            want_l = dict.fromkeys(counts, 0)
            want_l[kern] = ATTENTION_OPS_PER_FORWARD * 3
            if counts != want_l:
                raise AssertionError('%s: 3 calls launched %r; they must '
                                     'launch %r' % (tag, counts, want_l))
            launches[tag] = counts
            err, bits = held_by(tag, got, wants[tag])
            preds[tag].run(feed)        # the Predictor's capture
            ms = _timed_turns({'predictor': lambda p=preds[tag]: p.run(feed),
                               'compiled': lambda r=run: r(feed)})
            out[tag] = dict(export_s=export_s[tag], load_s=load_s,
                            bytes=_dir_bytes(dirs[tag]),
                            replay_ms=ms['compiled'],
                            predictor_ms=ms['predictor'], err=err,
                            bitwise=bits,
                            launches_per_call=counts[kern] // 3)
            del run
        child = _child_result(fresh, 'the fresh process')
    finally:
        if fresh.poll() is None:
            fresh.kill()
            fresh.wait()
    if child.pop('bad'):
        raise AssertionError('the fresh process imported JAX')
    for tag in dirs:
        c = child[tag]
        err, bits = held_by(tag, np.load(os.path.join(
            tmp, 'child.%s.npy' % tag)), wants[tag])
        if not c['same'] or c['stats']['captures'] != 1:
            raise AssertionError('the fresh process\'s %s: %r' % (tag, c))
        o = out[tag]
        o.update(child_load_s=c['load_s'], child_err=err,
                 child_bitwise=bits)
        log('[serving_stream] (e) %s artifact of Transformer-base at batch '
            '%d: export %.3f s (the three exports side by side %.3f s), %d '
            'bytes on disk; loaded in %.3f s here, %.3f s in a fresh process '
            'that imports only paddle_tpu_torch; %d %s launches a call; a '
            'replayed call %.3f ms beside Predictor.run\'s %.3f ms (wall, '
            'fetch to the host included, medians of %d calls in turns A B B '
            'A); against Predictor.run: %s %.3g (bitwise: %s), the fresh '
            'process %.3g (bitwise: %s)'
            % (tag, B, o['export_s'], exports_s, o['bytes'], o['load_s'],
               c['load_s'], o['launches_per_call'],
               'flash_attention_fwd' if tag == 'compiled'
               else 'flash_attention_fwd_bf16', o['replay_ms'],
               o['predictor_ms'], 2 * COMPILED_CALLS,
               'max |diff| / max(1, |logit|)' if tag == 'compiled'
               else 'relative L2', o['err'], o['bitwise'], err, bits))
    out['exports_s'] = exports_s
    out['gen2_export_s'] = export_s['gen2']
    rec['e'] = out

    # Router.swap(model, path) with no builder, under traffic
    want2 = inference.load_compiled(dir2)(feed)[0]
    rec['e']['swap'] = _swap_under_traffic(model, dir2, feed,
                                           wants['compiled'], want2)
    torch.cuda.synchronize()
    return launches


def _swap_under_traffic(model, dir2, feed, want1, want2):
    """Generation 1 a ServingEngine over a Predictor of `model`,
    generation 2 the artifact at dir2, cut over by Router.swap('tfm',
    dir2) with no builder while a client thread sends 16-row requests: no
    future fails or is lost; answers before the cutover equal want1,
    after it want2 (COMPILED_TOL)."""
    import threading
    from paddle_tpu_torch import inference, serving
    cfg = serving.ServingConfig(max_batch_size=COMPILED_BATCH,
                                buckets=[COMPILED_BATCH])
    eng = serving.ServingEngine(inference.Predictor(model), cfg)
    eng.warmup(example_feed=feed)
    router = serving.Router(window_s=0.0)
    router.add_model('tfm', [eng])
    futs, stop, errors = [], threading.Event(), []

    def client():
        try:
            while not stop.is_set():
                futs.append(router.submit('tfm', feed))
                futs[-1].result(600)
        except Exception as e:
            errors.append(e)

    th = threading.Thread(target=client, daemon=True)
    try:
        th.start()
        while len(futs) < 3 and not errors:
            time.sleep(0.01)
        t0 = time.perf_counter()
        version = router.swap('tfm', dir2)
        swap_s = time.perf_counter() - t0
        n_swap = len(futs)
        while len(futs) < n_swap + 3 and not errors:
            time.sleep(0.01)
        stop.set()
        th.join(600)
        if errors:
            raise errors[0]
        answers = [f.result(600)[0] for f in futs]
    finally:
        stop.set()
        router.shutdown()
    gens = []
    for a in answers:
        for g, w in ((1, want1), (2, want2)):
            if (np.abs(a - w) / np.maximum(1.0, np.abs(w))).max() \
                    <= COMPILED_TOL:
                gens.append(g)
                break
        else:
            raise AssertionError('an answer during the swap is neither '
                                 'generation\'s')
    if version != 2 or gens != sorted(gens) or gens[0] != 1 \
            or gens[-1] != 2:
        raise AssertionError('swap: version %d, generations in order %r'
                             % (version, gens))
    log('[serving_stream] (e) Router.swap(\'tfm\', path) with no builder '
        'under a client of %d-row requests: %.3f s (load, warmup of bucket '
        '%d, cutover); %d requests, none lost or failed: %d answered by '
        'the Predictor generation, then %d by the artifact'
        % (COMPILED_BATCH, swap_s, COMPILED_BATCH, len(answers),
           gens.count(1), gens.count(2)))
    return dict(seconds=swap_s, requests=len(answers),
                gen1=gens.count(1), gen2=gens.count(2))


def phase_serving_stream():
    """Phase 7i: (a)-(d) token streaming on phase 6's decode engine (the
    token_stream path), (e) the compiled artifact (the compiled and
    amp_compiled paths) and Router.swap to it. Returns {path: launch
    counts}."""
    import torch
    t0 = time.perf_counter()
    rec = {}
    out = {'token_stream': _token_streaming(rec)}
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_compiled_') as tmp:
        out.update(_compiled_artifact(rec, tmp))
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log('[serving_stream] phase 7i took %.1f s' % rec['seconds'])
    log(json.dumps({'serving_stream': rec}, default=float))
    return out


# -- phase 7j: tiered embedding storage and the run-log report --------------

def tier_reader(state, universe, fields, float_label=False):
    """bench.py:956-967's stream (bench_tiered) at CTR_BATCH: each step's
    ids are the base (TIER_DRIFT ids further each step) plus a
    Zipf(TIER_ZIPF) draw, mod `universe`; labels 0/1 (DeepFM) or
    standard normal (the drill's squared loss). `state` carries the step
    and the generator across train_stream calls."""
    def reader():
        while True:
            t = state['t']
            state['t'] = t + 1
            rng = state['rng']
            base = (t * TIER_DRIFT) % universe
            ids = (base + rng.zipf(TIER_ZIPF, size=(CTR_BATCH, fields))) \
                % universe
            if float_label:
                ids = ids.reshape(CTR_BATCH, fields, 1)
                labels = rng.randn(CTR_BATCH, 1).astype('float32')
            else:
                labels = rng.randint(0, 2, size=(CTR_BATCH, 1))
            yield [(ids[i], labels[i]) for i in range(CTR_BATCH)]

    return reader


def _tier_vocab(tiered, arena_dir):
    """The leg's vocab: VocabTable(100000, table='fm_embed', admit_count=
    TIER_ADMIT), behind a host_arena of TIER_SLOTS slots when tiered,
    preloaded full with ids 1..99,999: the window the stream starts in,
    as a table that has been serving it holds (most steps evict, and an
    evicted id the stream draws twice more re-admits warm)."""
    from paddle_tpu_torch import streaming
    from paddle_tpu_torch.models import deepfm
    vt = streaming.VocabTable(deepfm.VOCAB, table='fm_embed',
                              admit_count=TIER_ADMIT)
    tab = (streaming.TieredVocabTable(
        vt, streaming.host_arena(arena_dir, slots=TIER_SLOTS))
        if tiered else vt)
    tab.preload(range(1, deepfm.VOCAB))
    if vt.stats()['free'] != 0:
        raise AssertionError('the preloaded vocab is not full: %r'
                             % (vt.stats(),))
    return tab


def _push_lags(router, pub):
    """Wrap router.push_deltas: each push's freshness lag (its end minus
    the oldest touch it carries, the publisher's own measure) and ms."""
    real, pushes = router.push_deltas, []

    def push_deltas(model_id, deltas):
        oldest = pub._oldest_touch
        t0 = time.perf_counter()
        n = real(model_id, deltas)
        pushes.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                           lag_s=time.monotonic() - oldest, rows=n))
        return n

    router.push_deltas = push_deltas
    return pushes


def _quiet_threads(before, timeout=30.0):
    """Wait until no thread but those in `before` is alive: the prefetch
    worker a train_stream leaves behind finishes its last translation
    (it is not joined on an early return)."""
    import threading
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in threading.enumerate() if t not in before]:
            return
        time.sleep(0.01)
    raise AssertionError('a train_stream worker is still alive after %.0f s'
                         % timeout)


def _tier_leg(tr, tab, router, tiered):
    """TIER_WARM steps (warm-up and capture), then TIER_STEPS timed steps
    of the stream through train_stream with a DeltaPublisher into the
    router. Returns (launch counts of the timed steps, the record, the
    reader's state)."""
    import threading
    import torch
    from paddle_tpu_torch import streaming
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.obs.report import percentile_exact
    threads = set(threading.enumerate())
    state = {'t': 0, 'rng': np.random.RandomState(SEED)}
    reader = tier_reader(state, TIER_UNIVERSE, deepfm.NUM_FIELDS)
    pub = streaming.DeltaPublisher(router, 'deepfm',
                                   interval_steps=STREAM_PUBLISH_EVERY)
    vocabs = {'feat_ids': tab}
    tr.train_stream(reader, vocabs=vocabs, publisher=pub,
                    max_steps=TIER_WARM)
    real_push = router.push_deltas
    pushes = _push_lags(router, pub)
    captures0 = tr.exe.cache_stats['captures']
    vt = tab.vocab if tiered else tab
    st0 = vt.stats()
    if tiered:
        tier0 = dict(hits=tab.tier_hits, misses=tab.tier_misses,
                     spilled=tab.spilled, restored=tab.restored,
                     dropped=tab.dropped_full,
                     waits=tab._spiller.host_waits,
                     restore_i=len(tab.restore_ms_samples),
                     spill_i=len(tab.spill_ms_samples))
        split = [(tab, 'apply_step_boundary', 'tier boundary'),
                 (tab._spiller, 'spill', 'spill: gather, copy, wait, zero'),
                 (tab.arena, 'put_many', 'arena put_many'),
                 (tab._restorer, 'restore', 'restore: scatter'),
                 (tab.arena, 'discard_many', 'arena discard_many'),
                 (tab, 'translate', 'translate (worker)')]
    else:
        split = [(streaming.RowResetter, 'reset', 'row resets'),
                 (vt, 'translate', 'translate (worker)')]
    split += [(tr.exe, 'run', 'Executor.run')]
    _reset_launch_counts()
    try:
        with _spans('trainer.step') as sp, _timed_calls(split) as calls:
            t1 = time.perf_counter()
            n = tr.train_stream(reader, vocabs=vocabs, publisher=pub,
                                max_steps=TIER_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
    finally:
        router.push_deltas = real_push
    _quiet_threads(threads)
    launches = _launch_counts()
    st1 = vt.stats()
    captures1 = tr.exe.cache_stats['captures']
    want = dict.fromkeys(launches, 0)
    want['sparse_adam'] = 2 * TIER_STEPS
    if n != TIER_STEPS or launches != want:
        raise AssertionError('the %s leg ran %d steps and launched %r; the '
                             'path must launch %r' % (
                                 'tiered' if tiered else 'plain', n,
                                 launches, want))
    if captures1 != captures0 or captures0 != 1:
        raise AssertionError('captures %d before the stream, %d after'
                             % (captures0, captures1))
    step_s = _secs(sp['trainer.step'])
    lags = [p['lag_s'] for p in pushes]
    rec = dict(
        steps=n, wall_s=wall, steps_per_s=n / wall,
        median_step_ms=float(np.median(step_s)) * 1e3,
        admitted_per_step=(st1['rows_admitted'] - st0['rows_admitted']) / n,
        evicted_per_step=(st1['rows_evicted'] - st0['rows_evicted']) / n,
        sparse_adam_per_step=launches['sparse_adam'] / n,
        captures_before=captures0, captures_after=captures1,
        pushes=len(pushes), push_ms=[p['ms'] for p in pushes],
        freshness_lag_s=lags,
        median_freshness_lag_s=float(np.median(lags)) if lags else None,
        host_split_ms_per_step={k: v[0] * 1e3 / n for k, v in calls.items()},
        host_split_calls={k: v[1] for k, v in calls.items()})
    if not pushes or not rec['evicted_per_step'] > 0:
        raise AssertionError('the timed steps evicted %.1f rows a step in %d '
                             'pushes' % (rec['evicted_per_step'], len(pushes)))
    if tiered:
        hits = tab.tier_hits - tier0['hits']
        misses = tab.tier_misses - tier0['misses']
        restore_ms = tab.restore_ms_samples[tier0['restore_i']:]
        spill_ms = tab.spill_ms_samples[tier0['spill_i']:]
        waits = tab._spiller.host_waits - tier0['waits']
        arena_bytes = os.path.getsize(os.path.join(tab.arena.path,
                                                   'arena.npy'))
        rec.update(
            hit_rate=hits / float(max(1, hits + misses)),
            hit_rate_cumulative=tab.hit_rate(), tier_hits=hits,
            tier_misses=misses, spilled=tab.spilled - tier0['spilled'],
            restored=tab.restored - tier0['restored'],
            dropped_full=tab.dropped_full - tier0['dropped'],
            restore_p50_ms=percentile_exact(restore_ms, 50),
            restore_p99_ms=percentile_exact(restore_ms, 99),
            spill_p50_ms=percentile_exact(spill_ms, 50),
            spill_p99_ms=percentile_exact(spill_ms, 99),
            boundaries_with_spills=len(spill_ms),
            host_waits=waits,
            host_waits_per_boundary=waits / float(max(1, len(spill_ms))),
            boundary_share_of_step=(
                calls['tier boundary'][0] / wall),
            arena_file_bytes=arena_bytes, arena=tab.arena.stats())
        if rec['spilled'] <= 0 or rec['restored'] <= 0 or \
                rec['dropped_full'] or waits != len(spill_ms):
            raise AssertionError('the tiered leg spilled %d, restored %d, '
                                 'dropped %d, waited %d times at %d '
                                 'spilling boundaries' % (
                                     rec['spilled'], rec['restored'],
                                     rec['dropped_full'], waits,
                                     len(spill_ms)))
    else:
        rec['boundary_share_of_step'] = calls['row resets'][0] / wall
    return launches, rec, state


def _tier_resume(tr, tab, state, router, ckpt, arena_dir):
    """(c) a SIGTERM at a boundary of the tiered leg, sent by the reader as
    it hands over the batch after the STREAM_PREEMPT_AT-th step: that
    batch is translated (its admissions and evictions are the tier's
    pending ops, its warm ids staged) and never trained. The emergency
    serial holds the vocab, the spill map and those pending ops, equal to
    the live table's; the trainer then runs TIER_RESUME_STEPS more batches
    (the uninterrupted run: its first boundary applies the pending ops
    from the staged rows), and a fresh Trainer over the dir with a fresh
    host_arena over the same directory resumes the same map and spill map
    (the directory's manifest too), every persistable bitwise, and runs
    the same batches bitwise the uninterrupted run: losses, persistables
    and the tier's state, its spilled ids by their CRC32 (the two arenas
    hand out free slots in other orders: the uninterrupted one never
    reuses a slot the serial references before a checkpoint commits).
    Both trainers run these steps with double_buffer off: on an early
    return the prefetch worker, released by the queue's drain, translates
    one more batch after the serial is written (reader/pipeline.py, as in
    the JAX package), so the live table would run a batch ahead of the
    serial at a moment no check can pin down: the resumed run reads its
    pending ops from the arena, the uninterrupted one from the rows the
    translation staged."""
    import signal
    import torch
    import warnings
    from paddle_tpu_torch import fluid, streaming
    from paddle_tpu_torch.models import deepfm
    stream = tier_reader(state, TIER_UNIVERSE, deepfm.NUM_FIELDS)

    def reader():
        for i, batch in enumerate(stream()):
            if i == STREAM_PREEMPT_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    pub = streaming.DeltaPublisher(router, 'deepfm',
                                   interval_steps=STREAM_PUBLISH_EVERY)
    tr.double_buffer = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        n = tr.train_stream(reader, vocabs={'feat_ids': tab}, publisher=pub,
                            max_steps=STREAM_CHECK_STEPS)
    if not tr.preempted or n != STREAM_PREEMPT_AT or not any(
            'emergency checkpoint flushed' in str(w.message)
            for w in caught):
        raise AssertionError('no preemption at the %d-th boundary: %d steps'
                             % (STREAM_PREEMPT_AT, n))
    serial, sdir, meta = _newest_serial(fluid, ckpt)
    saved = (meta['trainer_args'].get('streaming_vocab') or {}).get(
        'feat_ids') or {}
    live = json.loads(json.dumps(tab.state_dict()))
    if not meta['trainer_args'].get('preempted') or \
            not saved.get('tiered') or saved != live or \
            not saved['arena']['entries'] or not saved['ops']:
        raise AssertionError('the emergency serial %d does not hold the live '
                             'tiered vocab (tiered %r, %d spilled ids, equal '
                             'to the live table: %r)' % (
                                 serial, saved.get('tiered'),
                                 len((saved.get('arena') or {}).get(
                                     'entries', [])), saved == live))
    at_preemption = _trainer_state(tr)
    more = list(itertools.islice(stream(), TIER_RESUME_STEPS))

    def run_more(trainer, table):
        losses = []
        trainer.train_stream(
            lambda: iter(more), vocabs={'feat_ids': table},
            event_handler=lambda ev: losses.append(
                np.asarray(ev.metrics[0]).tobytes())
            if isinstance(ev, fluid.EndStepEvent) else None)
        sd = json.loads(json.dumps(table.state_dict()))
        sd['arena']['entries'] = sorted(
            (raw, crc) for raw, _, crc in sd['arena']['entries'])
        return losses, _trainer_state(trainer), sd

    want = run_more(tr, tab)
    t0 = time.perf_counter()
    tr2 = stream_trainer({}, checkpoint_config=fluid.CheckpointConfig(
        checkpoint_dir=ckpt, step_interval=10 ** 9))
    tab2 = streaming.TieredVocabTable(
        streaming.VocabTable(deepfm.VOCAB, table='fm_embed',
                             admit_count=TIER_ADMIT),
        streaming.host_arena(arena_dir, slots=TIER_SLOTS))
    tr2.train_stream(lambda: iter(()), vocabs={'feat_ids': tab2})
    resume_s = time.perf_counter() - t0
    with open(os.path.join(tab2.arena.path, 'manifest.json')) as f:
        manifest = json.load(f)
    got_sd = json.loads(json.dumps(tab2.state_dict()))
    if got_sd != saved or sorted(map(tuple, manifest['entries'])) != \
            sorted(map(tuple, saved['arena']['entries'])):
        raise AssertionError('the resumed tier differs from the serial\'s '
                             '(map equal: %r, manifest equal: %r)' % (
                                 got_sd == saved,
                                 sorted(map(tuple, manifest['entries']))
                                 == sorted(map(tuple,
                                               saved['arena']['entries']))))
    got = _trainer_state(tr2)
    differ = [k for k, t in at_preemption.items()
              if not torch.equal(got[k], t)]
    if sorted(got) != sorted(at_preemption) or differ:
        raise AssertionError('the resumed state differs in %r' % differ[:8])
    resumed = run_more(tr2, tab2)
    differ = [k for k, t in want[1].items()
              if not torch.equal(resumed[1][k], t)]
    if resumed[0] != want[0] or differ or resumed[2] != want[2]:
        first = [i for i, (a, b) in enumerate(zip(resumed[0], want[0]))
                 if a != b][:1]
        raise AssertionError(
            'the resumed run differs from the uninterrupted one: losses '
            'first at step %r, persistables %r, tier keys %r' % (
                first, differ[:8],
                [k for k in want[2] if resumed[2].get(k) != want[2][k]]))
    ops = [k for k, _, _ in saved['ops']]
    log('[tier] (c) SIGTERM at a boundary: emergency serial %d holds the '
        'vocab (%d residents), the spill map (%d ids) and %d pending ops '
        '(%d spills, %d restores) of the batch translated and never trained, '
        'equal to the live table; a fresh Trainer and host_arena resumed '
        'them (the manifest too) and all %d persistables bitwise in %.3f s; '
        '%d more steps bitwise the uninterrupted run (losses, persistables, '
        'tier state)' % (serial, len(saved['vocab']['entries']),
                         len(saved['arena']['entries']), len(ops),
                         ops.count('spill'), ops.count('restore'),
                         len(got), resume_s, TIER_RESUME_STEPS))
    del tr2, tab2
    _release()
    return dict(serial=serial, spilled_ids=len(saved['arena']['entries']),
                pending_ops=len(ops), pending_spills=ops.count('spill'),
                pending_restores=ops.count('restore'), resume_s=resume_s,
                more_steps=TIER_RESUME_STEPS)


def _tier_drill_funcs():
    """bench.py:939-950's net (bench_tiered) at DeepFM's field count: one
    is_sparse `emb_w` of TIER_DRILL_UNIVERSE + 1 rows (Constant(0): a
    zeroed row equals a never-trained one), an fc to 1, reduce_sum,
    squared loss, Adam(TIER_DRILL_LR)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import deepfm

    def train_func():
        fluid.default_main_program().random_seed = SEED
        fluid.default_startup_program().random_seed = SEED
        ids = fluid.layers.data(name='ids', shape=[deepfm.NUM_FIELDS, 1],
                                dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(
            ids, size=[TIER_DRILL_UNIVERSE + 1, CTR_EMBED_DIM],
            is_sparse=True, param_attr=fluid.ParamAttr(
                name='emb_w', initializer=fluid.initializer.Constant(0.0)))
        pred = fluid.layers.fc(input=emb, size=1, num_flatten_dims=2,
                               param_attr=fluid.ParamAttr(name='fc_w'))
        score = fluid.layers.reduce_sum(pred, dim=1)
        return [fluid.layers.mean(fluid.layers.square(score - label))]

    return train_func, lambda: fluid.optimizer.Adam(
        learning_rate=TIER_DRILL_LR)


def _tier_drill(arena_dir):
    """(b) the JAX tests/test_tiers.py:513 drill at chip size: three legs
    over the same TIER_DRILL_STEPS batches from the same start weights,
    double_buffer off (every leg makes the same vocab decisions): a
    reference whose capacity covers every id the batches hold, tiered at
    TIER_DRILL_CAP, plain at TIER_DRILL_CAP. The tiered losses are bitwise
    the reference's at every step, the plain leg diverges, the tier
    spilled >= 3 and restored >= 1, and no leg captures in its second
    half."""
    import torch
    from paddle_tpu_torch import fluid, streaming
    from paddle_tpu_torch.models import deepfm
    state = {'t': 0, 'rng': np.random.RandomState(SEED + 1)}
    batches = list(itertools.islice(tier_reader(
        state, TIER_DRILL_UNIVERSE, deepfm.NUM_FIELDS, float_label=True)(),
        TIER_DRILL_STEPS))
    seen = len({int(i) for b in batches for ids, _ in b
                for i in ids.reshape(-1)})
    train_func, optimizer_func = _tier_drill_funcs()
    start = None
    legs = {}
    for leg in ('reference', 'tiered', 'plain'):
        tr = fluid.Trainer(train_func=train_func,
                           optimizer_func=optimizer_func,
                           place=fluid.CUDAPlace(0), double_buffer=False)
        if start is None:
            start = _trainer_state(tr)
        else:
            with torch.no_grad():
                for k, t in start.items():
                    tr.scope.vars[k].copy_(t)
        cap = seen + 1 if leg == 'reference' else TIER_DRILL_CAP
        vt = streaming.VocabTable(cap, table='emb_w', admit_count=1)
        tab = (streaming.TieredVocabTable(
            vt, streaming.HostArena(os.path.join(arena_dir, 'drill'),
                                    TIER_DRILL_UNIVERSE))
            if leg == 'tiered' else vt)
        losses, captures = [], []
        half = TIER_DRILL_STEPS // 2
        for part in (batches[:half], batches[half:]):
            tr.train_stream(
                lambda part=part: iter(part), vocabs={'ids': tab},
                event_handler=lambda ev: losses.append(
                    np.asarray(ev.metrics[0]).copy())
                if isinstance(ev, fluid.EndStepEvent) else None)
            captures.append(tr.exe.cache_stats['captures'])
        if captures[1] != captures[0] or len(losses) != TIER_DRILL_STEPS:
            raise AssertionError('the %s leg captured %r in its halves, %d '
                                 'losses' % (leg, captures, len(losses)))
        legs[leg] = (losses, tab, vt.stats())
        del tr
        _release()
    ref, tiered, plain = (legs[k][0] for k in ('reference', 'tiered',
                                               'plain'))
    tab = legs['tiered'][1]
    differ = [i for i, (a, b) in enumerate(zip(ref, tiered))
              if not np.array_equal(a, b)]
    diverged = [i for i, (a, b) in enumerate(zip(ref, plain))
                if not np.array_equal(a, b)]
    if differ or not diverged or tab.spilled < 3 or tab.restored < 1 or \
            legs['reference'][2]['rows_evicted']:
        raise AssertionError(
            'the drill: tiered differs from the reference at steps %r, the '
            'plain leg diverges at %r, spilled %d, restored %d, reference '
            'evictions %d' % (differ[:8], diverged[:8], tab.spilled,
                              tab.restored,
                              legs['reference'][2]['rows_evicted']))
    rec = dict(steps=TIER_DRILL_STEPS, ids_seen=seen,
               reference_capacity=seen + 1, capacity=TIER_DRILL_CAP,
               spilled=tab.spilled, restored=tab.restored,
               hit_rate=tab.hit_rate(),
               plain_first_divergence=diverged[0],
               plain_max_loss_diff=float(max(
                   abs(float(a.reshape(-1)[0]) - float(b.reshape(-1)[0]))
                   for a, b in zip(ref, plain))))
    log('[tier] (b) the drill: %d steps of %d ids over %d distinct; the '
        'tiered leg at capacity %d (spilled %d, restored %d, hit rate %.4f) '
        'bitwise the reference (capacity %d) at every step; the plain leg '
        'first diverges at step %d (max |loss diff| %.6g); no capture in '
        'any second half' % (
            TIER_DRILL_STEPS, CTR_BATCH * deepfm.NUM_FIELDS, seen,
            TIER_DRILL_CAP, tab.spilled, tab.restored, tab.hit_rate(),
            seen + 1, diverged[0], rec['plain_max_loss_diff']))
    return rec


def _tier_report(path):
    """(d) the phase's run log through the port's obs.report: no malformed
    record, the streaming and tiers sections printed; tools/slo_budgets.json
    graded over the process's registry, each key ok, violation or missing;
    a violation fails."""
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.obs import report, slo
    events, errors = report.load_events(path)
    if errors or not events:
        raise AssertionError('the run log holds %d malformed record(s): %r'
                             % (len(errors), errors[:3]))
    text = report.summarize(events)
    lines = text.splitlines()
    sections = {}
    for head in ('-- streaming --', '-- tiers --'):
        if head not in lines:
            raise AssertionError('the report has no %s section:\n%s'
                                 % (head, text))
        i = lines.index(head)
        j = i + 1
        while j < len(lines) and lines[j].strip():
            j += 1
        sections[head] = lines[i:j]
        for line in lines[i:j]:
            log('[tier] (d) %s' % line)
    budgets = slo.SloBudget.from_file(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'tools',
        'slo_budgets.json'))
    res = budgets.evaluate(registry=obs.REGISTRY, events=events)
    for line in res.lines():
        log('[tier] (d) %s' % line)
    if res.violations:
        raise AssertionError('SLO violations: %r' % (res.violations,))
    return dict(records=len(events), malformed=len(errors),
                sections=sections,
                slo_ok={b: m for b, _, m in res.ok},
                slo_missing=[m.budget for m in res.missing])


def _tier_legs(tmp):
    """(a) the tiered leg (the phase's main path: its launch counts) and the
    plain leg over the same stream, one Router of two replicas between
    them; (c) on the tiered leg's trainer, with the run log on."""
    from paddle_tpu_torch import fluid, obs
    held, ckpt = {}, os.path.join(tmp, 'ckpt')
    arena_dir = os.path.join(tmp, 'arena')
    t0 = time.perf_counter()
    tr = stream_trainer(held, double_buffer=True,
                        checkpoint_config=fluid.CheckpointConfig(
                            checkpoint_dir=ckpt, step_interval=10 ** 9))
    router, engines, _ = _stream_serving(tr, held, tmp)
    tab = _tier_vocab(True, arena_dir)
    build_s = time.perf_counter() - t0
    try:
        launches, tiered, state = _tier_leg(tr, tab, router, True)
        obs.enable(os.path.join(tmp, 'obs'))
        try:
            tiered['preemption'] = _tier_resume(tr, tab, state, router,
                                                ckpt, arena_dir)
            path = obs.run_log_path()
        finally:
            obs.disable()
        del tr, tab
        _release()
        tr = stream_trainer({}, double_buffer=True)
        _, plain, _ = _tier_leg(tr, _tier_vocab(False, None), router, False)
        del tr
        if not router.shutdown():
            raise AssertionError('a replica did not shut down')
    finally:
        router.shutdown(drain=False, timeout=60)
    _release()
    tiered['build_s'] = build_s
    return launches, tiered, plain, path


def phase_tier():
    """Phase 7j: (a) full-width DeepFM through train_stream over a
    TieredVocabTable against a plain VocabTable on bench_tiered's stream,
    (b) the bitwise drill, (c) preemption and resume of the tiered leg,
    (d) the run log's report and the SLO budgets. Returns {'tier': launch
    counts of (a)'s timed tiered steps}."""
    import torch
    from paddle_tpu_torch import obs
    t0 = time.perf_counter()
    rec = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_tier_') as tmp:
        launches, rec['tiered'], rec['plain'], path = _tier_legs(tmp)
        a, b = rec['tiered'], rec['plain']
        log('[tier] (a) tiered: %d timed steps at %.1f steps/s (plain %.1f, '
            'ratio %.3f); trainer.step median %.3f ms (plain %.3f); %.1f '
            'rows admitted and %.1f evicted a step; hit rate %.4f over the '
            'timed steps (%.4f with the preload); spilled %d, restored %d, '
            'dropped_full %d; %d sparse_adam launches a step; captures %d '
            'before, %d after' % (
                a['steps'], a['steps_per_s'], b['steps_per_s'],
                a['steps_per_s'] / b['steps_per_s'], a['median_step_ms'],
                b['median_step_ms'], a['admitted_per_step'],
                a['evicted_per_step'], a['hit_rate'],
                a['hit_rate_cumulative'], a['spilled'], a['restored'],
                a['dropped_full'], a['sparse_adam_per_step'],
                a['captures_before'], a['captures_after']))
        log('[tier] (a) restore ms p50 %.3f p99 %.3f; spill ms p50 %.3f p99 '
            '%.3f; %.2f host waits a spilling boundary (%d boundaries); the '
            'boundary %.1f%% of the tiered leg\'s wall (plain resets %.1f%%);'
            ' arena file %d bytes; freshness lag median %.4f s (plain %.4f)'
            % (a['restore_p50_ms'], a['restore_p99_ms'], a['spill_p50_ms'],
               a['spill_p99_ms'], a['host_waits_per_boundary'],
               a['boundaries_with_spills'],
               100.0 * a['boundary_share_of_step'],
               100.0 * b['boundary_share_of_step'], a['arena_file_bytes'],
               a['median_freshness_lag_s'], b['median_freshness_lag_s']))
        for tag, r in (('tiered', a), ('plain', b)):
            log('[tier] (a) %s host ms a step: %s' % (tag, ', '.join(
                '%s %.3f' % kv for kv in r['host_split_ms_per_step'].items())))
        rec['drill'] = _tier_drill(os.path.join(tmp, 'arena'))
        rec['report'] = _tier_report(path)
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log('[tier] phase 7j took %.1f s' % rec['seconds'])
    log(json.dumps({'tier': rec}, default=float))
    return {'tier': launches}


# -- phase 7k: the pass pipeline and int8 weight quantization ----------------

@contextlib.contextmanager
def _opt_level(mode):
    """PADDLE_TPU_OPT=mode inside the block; as it was outside."""
    prev = os.environ.get('PADDLE_TPU_OPT')
    os.environ['PADDLE_TPU_OPT'] = mode
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop('PADDLE_TPU_OPT', None)
        else:
            os.environ['PADDLE_TPU_OPT'] = prev


def _pool_of(run):
    """Run `run` twice (a signature's warm-up, then its capture and first
    replay); returns the memory the capture reserved (its graph pool)."""
    run()
    r0 = _reserved()
    run()
    return _reserved() - r0


def _in_turns(fns, n=PASSES_TIMED):
    """{tag: median host ms} of the calls of each fn (ending in
    torch.cuda.synchronize), the fns called in turns n times."""
    import torch
    secs = {t: [] for t in fns}
    for _ in range(n):
        for t, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[t].append(time.perf_counter() - t0)
    return {t: float(np.median(v)) * 1e3 for t, v in secs.items()}


def _passes_int8(tmp, rec):
    """(a): Transformer-base quantized offline and served from its int8
    artifact. Returns the launch counts of the served path."""
    import torch
    from paddle_tpu_torch import fluid, inference, serving
    from paddle_tpu_torch.fluid.passes import quant_pass
    cfg = TRANSFORMER_BASE
    main, scope, exe, logits = _transformer_scope(SEED, fluid.CUDAPlace(0))
    dirs = {'fp32': os.path.join(tmp, 'fp32'),
            'int8': os.path.join(tmp, 'int8')}
    fluid.io.save_inference_model(dirs['fp32'], ['src_word', 'trg_word'],
                                  [logits], exe, main_program=main,
                                  scope=scope)
    infer = main.clone(for_test=True).prune([logits])
    n_weights = quant_pass.quantize_weights(infer, scope)
    fluid.io.save_inference_model(
        dirs['int8'], ['src_word', 'trg_word'],
        [infer.global_block().var(logits.name)], exe, main_program=infer,
        scope=scope)
    del main, scope, exe, infer
    params = {t: os.path.getsize(os.path.join(d, '__params__.npz'))
              for t, d in dirs.items()}
    with np.load(os.path.join(dirs['int8'], '__params__.npz')) as z:
        kinds = {}
        for n in z.files:
            kinds[str(z[n].dtype)] = kinds.get(str(z[n].dtype), 0) + 1
    if not n_weights or kinds.get('int8') != n_weights:
        raise AssertionError('int8 artifact: %d weights quantized, arrays '
                             'by dtype %r' % (n_weights, kinds))
    ratio = params['int8'] / params['fp32']
    log('[passes] (a) Transformer-base: %d weights quantized; artifact '
        'params %d bytes int8 against %d fp32 (%.4fx); int8 arrays by '
        'dtype %r' % (n_weights, params['int8'], params['fp32'], ratio,
                      kinds))
    reqs = make_requests(PASSES_REQUESTS, 4, cfg['max_length'],
                         cfg['trg_vocab_size'], np.random.RandomState(SEED))
    pred = inference.Predictor(dirs['int8'])
    if pred._scope.vars[[n for n in pred._scope.vars
                         if n.endswith('@quant.int8')][0]].dtype \
            != torch.int8:
        raise AssertionError('the int8 Predictor did not load int8')
    engine = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=PASSES_BATCH, max_queue_delay_ms=20.0))
    try:
        _reset_launch_counts()
        buckets = engine.warmup()
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(engine.submit, reqs))
        answers = [f.result(timeout=600)[0] for f in futs]
        torch.cuda.synchronize()
        launches = _launch_counts()
        batches = engine.stats['batches']
    finally:
        engine.shutdown()
    runs = serving.engine.WARMUP_RUNS * len(buckets) + batches
    want = {k: 0 for k in launches}
    want['flash_attention_fwd'] = ATTENTION_OPS_PER_FORWARD * runs
    if launches != want:
        raise AssertionError('int8 serving launched %r for %d forwards; '
                             'want %r' % (launches, runs, want))
    f32 = inference.Predictor(dirs['fp32'])
    worst = 0.0
    for req, ans in zip(reqs, answers):
        n = req['src_word'].shape[0]
        if ans.shape != (n, cfg['max_length'], cfg['trg_vocab_size']) or \
                not np.isfinite(ans).all():
            raise AssertionError('int8 answer shape %r or non-finite'
                                 % (ans.shape,))
        ref = f32.run(req)[0]
        rel = float(np.abs(ans - ref).max() / np.abs(ref).max())
        worst = max(worst, rel)
    if not worst < PASSES_INT8_TOL:
        raise AssertionError('int8 against fp32: max |diff| / max |fp32| '
                             '%.4f (bound %g)' % (worst, PASSES_INT8_TOL))
    cpu = inference.Predictor(dirs['int8'], place=fluid.CPUPlace())
    small = {k: v[:1] for k, v in reqs[0].items()}
    ref = cpu.run(small)[0]
    cross = float(np.abs(answers[0][:1] - ref).max())
    np.testing.assert_allclose(answers[0][:1], ref, atol=CROSS_DEVICE_TOL,
                               rtol=CROSS_DEVICE_TOL)
    del cpu
    log('[passes] (a) %d requests in %d batch(es) through ServingEngine '
        'over the int8 Predictor: flash_attention_fwd %d launches = %d x '
        '%d forwards; against the fp32 Predictor max |diff| / max |fp32| '
        '%.4f (bound %g); one row against the int8 artifact on the CPU: '
        'max abs diff %.3g (tol %g)'
        % (len(reqs), batches, launches['flash_attention_fwd'],
           ATTENTION_OPS_PER_FORWARD, runs, worst, PASSES_INT8_TOL, cross,
           CROSS_DEVICE_TOL))
    # the served batch replayed: fresh Predictors (fresh graph pools)
    feed = {n: np.repeat(a[:1], PASSES_BATCH, axis=0)
            for n, a in reqs[0].items()}
    preds = {'fp32': inference.Predictor(dirs['fp32']),
             'int8': inference.Predictor(dirs['int8'])}
    del f32, pred
    _release()
    pools = {t: _pool_of(lambda p=p: p.run(feed)) for t, p in preds.items()}
    ms = _in_turns({t: (lambda p=p: p.run(feed)) for t, p in preds.items()})
    busy = {t: _device_busy(lambda p=p: p.run(feed), 2)
            for t, p in preds.items()}
    rec['int8_serving'] = dict(
        weights_quantized=n_weights, params_bytes=params,
        bytes_ratio=ratio, worst_rel_to_fp32=worst, cpu_max_abs=cross,
        batches=batches, forwards=runs,
        flash_attention_fwd=launches['flash_attention_fwd'],
        batch=PASSES_BATCH, replay_ms=ms,
        device_busy_ms={t: b[0] for t, b in busy.items()},
        kernels_per_replay={t: b[3] for t, b in busy.items()},
        graph_pool_gb={t: v / 1e9 for t, v in pools.items()})
    log('[passes] (a) batch %d replayed, Predictor.run with the fetch on '
        'the host: int8 %.4f ms, fp32 %.4f ms (median of %d in turns); '
        'device busy %.4f / %.4f ms; kernel records a replay %.0f / %.0f; '
        'graph pool %.3f / %.3f GB'
        % (PASSES_BATCH, ms['int8'], ms['fp32'], PASSES_TIMED,
           busy['int8'][0], busy['fp32'][0], busy['int8'][3],
           busy['fp32'][3], pools['int8'] / 1e9, pools['fp32'] / 1e9))
    return launches


def _passes_resnet(tmp, rec):
    """(b): ResNet-50 served before and after InferenceTranspiler."""
    import warnings
    import torch
    from paddle_tpu_torch import fluid, inference
    main, startup, _, _, _ = build_resnet('NCHW')
    # the classifier's logits (the softmax's input): random weights
    # saturate the probabilities, which would hide a wrong fold
    logits = _input_of(main, 'softmax', 'X')
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    for op in main.global_block().ops:
        if op.type != 'batch_norm':
            continue
        for slot, lo, hi in (('Scale', 0.8, 1.2), ('Bias', -0.05, 0.05),
                             ('Mean', -0.05, 0.05),
                             ('Variance', 0.8, 1.2)):
            t = scope.vars[op.input(slot)[0]]
            t.copy_(torch.from_numpy(
                rng.uniform(lo, hi, tuple(t.shape)).astype('float32')))
    d = os.path.join(tmp, 'resnet50')
    fluid.io.save_inference_model(d, ['data'], [logits], exe,
                                  main_program=main.clone(for_test=True),
                                  scope=scope)
    del main, startup, scope, exe
    preds = {'before': inference.Predictor(d),
             'after': inference.Predictor(d)}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        fluid.InferenceTranspiler().transpile(preds['after']._program,
                                              scope=preds['after']._scope)
    types = {k: [op.type for op in p._program.global_block().ops]
             for k, p in preds.items()}
    folded = types['before'].count('batch_norm')
    if folded != RESNET_BN_FOLDS or 'batch_norm' in types['after']:
        raise AssertionError('InferenceTranspiler left %d of %d batch '
                             'norms; want all %d folded' % (
                                 types['after'].count('batch_norm'),
                                 folded, RESNET_BN_FOLDS))
    feed = {'data': rng.randn(RESNET_BATCH, 3, 224, 224).astype('float32')}
    pools = {k: _pool_of(lambda p=p: p.run(feed)) for k, p in preds.items()}
    outs = {k: p.run(feed)[0] for k, p in preds.items()}
    diff = float(np.abs(outs['after'] - outs['before']).max()
                 / np.abs(outs['before']).max())
    if outs['after'].shape != (RESNET_BATCH, 1000) or \
            not np.isfinite(outs['after']).all() or \
            not diff <= PASSES_FOLD_TOL:
        raise AssertionError('ResNet-50 after the fold: shape %r, max abs '
                             'diff over max |logit| %.3g (tol %g)' % (
                                 outs['after'].shape, diff, PASSES_FOLD_TOL))
    ms = _in_turns({k: (lambda p=p: p.run(feed)) for k, p in preds.items()})
    busy = {k: _device_busy(lambda p=p: p.run(feed), 2)
            for k, p in preds.items()}
    rec['resnet_fold'] = dict(
        bn_folded=folded, ops={k: len(v) for k, v in types.items()},
        rel_diff=diff, max_abs_logit=float(np.abs(outs['before']).max()),
        replay_ms=ms, device_busy_ms={k: b[0] for k, b in busy.items()},
        kernels_per_replay={k: b[3] for k, b in busy.items()},
        graph_pool_gb={k: v / 1e9 for k, v in pools.items()})
    log('[passes] (b) ResNet-50 batch %d: %d batch norms folded by '
        'InferenceTranspiler (%d -> %d ops); logits max abs diff over max '
        '|logit| %.3g (tol %g); replay %.4f -> %.4f ms (median of %d in turns); '
        'device busy %.4f -> %.4f ms; kernel records a replay %.0f -> '
        '%.0f; graph pool %.3f -> %.3f GB'
        % (RESNET_BATCH, folded, len(types['before']),
           len(types['after']), diff, PASSES_FOLD_TOL, ms['before'],
           ms['after'], PASSES_TIMED, busy['before'][0], busy['after'][0],
           busy['before'][3], busy['after'][3], pools['before'] / 1e9,
           pools['after'] / 1e9))


def _passes_arm(main, init, feeds, fetch, mode):
    """PASSES_STEPS steps of `main` from `init` at PADDLE_TPU_OPT=mode on a
    fresh executor (warm-up, capture, replay). Returns (losses, the state
    after them (clones), launches, the artifact, executor, scope)."""
    import torch
    from paddle_tpu_torch import fluid
    with _opt_level(mode):
        scope = fluid.Scope()
        scope.vars.update({n: t.clone() for n, t in init.vars.items()})
        exe = fluid.Executor()
        _reset_launch_counts()
        losses = [exe.run(main, feed=f, fetch_list=[fetch], scope=scope)[0]
                  for f in feeds]
        torch.cuda.synchronize()
        launches = _launch_counts()
        art = exe.step_artifact(main, feeds[-1], [fetch], scope=scope)
    state = {n: t.clone() for n, t in scope.vars.items()}
    if exe.cache_stats['captures'] != 1:
        raise AssertionError('%s: %r' % (mode, exe.cache_stats))
    return losses, state, launches, art, exe, scope


def _passes_replays(arms, main, feed, fetch):
    """{mode: (median replay ms in turns, busy ms, kernel records)} of more
    steps of each arm (after the compared steps), each at its own
    PADDLE_TPU_OPT level: its artifact's replays."""
    def step(mode, exe, scope):
        with _opt_level(mode):
            exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)
    fns = {m: (lambda m=m, a=a: step(m, a[4], a[5]))
           for m, a in arms.items()}
    captures = {m: a[4].cache_stats['captures'] for m, a in arms.items()}
    ms = _in_turns(fns, n=5)
    out = {m: (ms[m],) + _device_busy(fn, 1)[::3] for m, fn in fns.items()}
    if {m: a[4].cache_stats['captures'] for m, a in arms.items()} \
            != captures:
        raise AssertionError('the timed steps captured again: %r'
                             % captures)
    return out


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _passes_training(rec):
    """(c): Transformer-base training at PADDLE_TPU_OPT off and default,
    fp32 and under AMP. Returns the launch counts of the two optimized
    paths."""
    import torch
    from paddle_tpu_torch import fluid
    main, startup, avg_cost, names, reader = build_trainer()
    init = fluid.Scope()
    fluid.Executor().run(startup, scope=init)
    it = reader()
    feeds = [as_feed(next(it), names) for _ in range(PASSES_STEPS)]
    attn = ('flash_attention_fwd', 'flash_attention_bwd_dq',
            'flash_attention_bwd_dkv')
    out, counts = {}, {}
    for amp in (False, True):
        tag = 'amp' if amp else 'fp32'
        if amp:
            fluid.amp.decorate_program(main)
        arms = {m: _passes_arm(main, init, feeds, avg_cost, m)
                for m in ('off', 'default')}
        (lo, so, _, ao, _, _), (ld, sd, cd, ad, _, _) = \
            arms['off'], arms['default']
        report = ad.program._opt_report
        if amp:
            if ao.amp is not True or ad.amp is not False or \
                    not ad.program._amp_ir:
                raise AssertionError('AMP arms: runtime amp %r, pass amp %r'
                                     % (ao.amp, ad.amp))
            gaps = [abs(float(np.asarray(a).reshape(())) -
                        float(np.asarray(b).reshape(())))
                    / _bf16_ulp(float(np.asarray(a).reshape(())))
                    for a, b in zip(lo, ld)]
            if not max(gaps) <= 1.0:
                raise AssertionError('AMP pass losses %r against runtime '
                                     'AMP %r: %r bf16 ulps' % (ld, lo, gaps))
            want = {k: 0 for k in cd}
            want.update((k + '_bf16', ATTENTION_OPS_PER_FORWARD *
                         PASSES_STEPS) for k in attn)
            path, check = 'amp_opt_training', 'losses within %s bf16 ulps' \
                % ', '.join('%.3f' % g for g in gaps)
        else:
            if not all(np.array_equal(a, b) for a, b in zip(lo, ld)):
                raise AssertionError('PADDLE_TPU_OPT default losses %r, off '
                                     '%r' % (ld, lo))
            diff = [n for n in so if not torch.equal(so[n], sd[n])]
            if diff:
                raise AssertionError('default and off differ in %r after '
                                     '%d steps' % (diff[:8], PASSES_STEPS))
            want = {k: 0 for k in cd}
            want.update((k, ATTENTION_OPS_PER_FORWARD * PASSES_STEPS)
                        for k in attn)
            path, check = 'opt_training', 'losses and all %d persistables ' \
                'bitwise equal' % len(so)
        if cd != want:
            raise AssertionError('%s launched %r over %d steps; want %r'
                                 % (path, cd, PASSES_STEPS, want))
        counts[path] = cd
        rep = _passes_replays(arms, main, feeds[-1], avg_cost)
        out[tag] = dict(report=report.to_dict(),
                        losses={m: [float(np.asarray(x).reshape(()))
                                    for x in a[0]] for m, a in arms.items()},
                        replay_ms={m: r[0] for m, r in rep.items()},
                        device_busy_ms={m: r[1] for m, r in rep.items()},
                        kernels_per_replay={m: r[2] for m, r in rep.items()})
        log('[passes] (c) Transformer-base training %s, batch %d, dropout '
            '0.1, %d steps: default against off: %s; %r; %s per step of '
            'each attention kernel %d; replay %.4f / %.4f ms, device busy '
            '%.4f / %.4f ms, kernel records a replay %.0f / %.0f (default '
            '/ off)' % (tag, TRAIN_BATCH, PASSES_STEPS, check, report, path,
                        ATTENTION_OPS_PER_FORWARD, rep['default'][0],
                        rep['off'][0], rep['default'][1], rep['off'][1],
                        rep['default'][2], rep['off'][2]))
        del arms, so, sd, ao, ad
        _release()
    rec['training'] = out
    return counts


def phase_passes():
    """Phase 7k: (a) int8 Transformer-base serving, (b) ResNet-50 through
    InferenceTranspiler, (c) Transformer-base training at PADDLE_TPU_OPT
    default against off, fp32 and under the AMP pass, (d) no pass
    failure. Returns {path: launch counts} of int8_serving, opt_training
    and amp_opt_training."""
    import torch
    from paddle_tpu_torch import obs
    t0 = time.perf_counter()
    rec = {}
    counts = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_passes_') as tmp:
        counts['int8_serving'] = _passes_int8(tmp, rec)
        _release()
        _passes_resnet(tmp, rec)
        _release()
    counts.update(_passes_training(rec))
    errors = obs.REGISTRY.counter('passes.errors').snapshot()['value']
    if errors:
        raise AssertionError('%d pass failure(s) fell back to the '
                             'unoptimized program' % errors)
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log(json.dumps({'passes': rec}))
    log('[passes] phase 7k took %.1f s' % rec['seconds'])
    return counts


# -- phase 7l: detection and the vision rules ---------------------------------

def _conv_bn(layers, x, k, c, stride, pad, groups=1):
    """mobilenet_ssd.py's conv_bn: a bias-free convolution, batch norm,
    relu."""
    conv = layers.conv2d(x, num_filters=c, filter_size=k, stride=stride,
                         padding=pad, groups=groups, bias_attr=False)
    return layers.batch_norm(conv, act='relu')


def mobilenet_19(layers, img):
    """MobileNet-v1 at scale 1.0 (mobilenet_ssd.py's mobile_net) up to its
    19x19x512 map (module11): a strided conv_bn, then depthwise-separable
    blocks (a depthwise 3x3 conv_bn, groups = channels, and a pointwise
    one)."""
    x = _conv_bn(layers, img, 3, 32, 2, 1)                        # 150
    for c1, c2, s in ((32, 64, 1), (64, 128, 2), (128, 128, 1),
                      (128, 256, 2), (256, 256, 1), (256, 512, 2)):
        x = _conv_bn(layers, _conv_bn(layers, x, 3, c1, s, 1, groups=c1),
                     1, c2, 1, 0)                             # ... 19
    for _ in range(5):
        x = _conv_bn(layers, _conv_bn(layers, x, 3, 512, 1, 1, groups=512),
                     1, 512, 1, 0)
    return x


def mobilenet_ssd_maps(layers, img):
    """The six maps multi_box_head reads: 19x19x512, 10x10x1024 and the
    extra blocks' 5, 3, 2 and 1 (a 1x1 conv_bn, then a strided 3x3)."""
    m11 = mobilenet_19(layers, img)
    x = _conv_bn(layers, _conv_bn(layers, m11, 3, 512, 2, 1, groups=512),
                 1, 1024, 1, 0)                                   # 10
    maps = [m11, _conv_bn(layers, _conv_bn(layers, x, 3, 1024, 1, 1,
                                           groups=1024), 1, 1024, 1, 0)]
    for c1, c2 in ((256, 512), (128, 256), (128, 256), (64, 128)):
        maps.append(_conv_bn(layers, _conv_bn(layers, maps[-1], 1, c1, 1, 0),
                             3, c2, 2, 1))                        # 5 3 2 1
    return maps


def ssd_program(train):
    """MobileNet-SSD at full width; train: ssd_loss under RMSProp with
    L2Decay (returns main, startup, loss); else the detection_output
    program (returns main, startup, nmsed). Both under a fresh
    unique_name guard: the same parameter names."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    layers = fluid.layers
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name='image', shape=[3, SSD_IMAGE, SSD_IMAGE])
        locs, confs, box, box_var = layers.multi_box_head(
            inputs=mobilenet_ssd_maps(layers, img), image=img,
            base_size=SSD_IMAGE, num_classes=SSD_CLASSES,
            aspect_ratios=[[2.]] + [[2., 3.]] * 5, min_ratio=20,
            max_ratio=90, offset=0.5, flip=True)
        if box.shape[0] != SSD_PRIORS:
            raise AssertionError('multi_box_head gave %d priors, not %d'
                                 % (box.shape[0], SSD_PRIORS))
        if not train:
            return main, startup, layers.detection_output(
                locs, confs, box, box_var, **SSD_NMS)
        gt_box = layers.data(name='gt_box', shape=[4], lod_level=1)
        gt_label = layers.data(name='gt_label', shape=[1], dtype='int64',
                               lod_level=1)
        loss = layers.reduce_sum(layers.ssd_loss(locs, confs, gt_box,
                                                 gt_label, box, box_var))
        fluid.optimizer.RMSProp(
            learning_rate=SSD_LR,
            regularization=fluid.regularizer.L2Decay(SSD_L2)).minimize(loss)
    return main, startup, loss


def rpn_program():
    """An RPN head on MobileNet's 19x19 map: a 3x3 conv, 9 objectness
    logits and 36 box offsets a position over anchor_generator's 9 anchors
    (3,249 in all), rpn_target_assign's defaults, sigmoid cross entropy
    on the sampled slots and smooth_l1 on the foreground ones."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    layers = fluid.layers
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name='image', shape=[3, SSD_IMAGE, SSD_IMAGE])
        gt_box = layers.data(name='gt_box', shape=[4], lod_level=1)
        feat = mobilenet_19(layers, img)
        conv = layers.conv2d(feat, num_filters=512, filter_size=3,
                             padding=1, act='relu')
        cls = layers.conv2d(conv, num_filters=9, filter_size=1)
        bbox = layers.conv2d(conv, num_filters=36, filter_size=1)
        anchors, _ = layers.anchor_generator(
            feat, anchor_sizes=[64., 128., 256.], aspect_ratios=[0.5, 1., 2.],
            stride=[16., 16.])
        anchors = layers.reshape(anchors, [-1, 4])
        if anchors.shape[0] != RPN_ANCHORS:
            raise AssertionError('%d anchors, not %d' % (anchors.shape[0],
                                                         RPN_ANCHORS))
        score, loc, label, target = layers.rpn_target_assign(
            layers.reshape(layers.transpose(bbox, [0, 2, 3, 1]), [0, -1, 4]),
            layers.reshape(layers.transpose(cls, [0, 2, 3, 1]), [0, -1, 1]),
            anchors, gt_box)
        lbl = layers.cast(label, 'float32')              # -1, 0 or 1
        fg = layers.clip(lbl, 0.0, 1.0)
        sampled = layers.clip(layers.scale(lbl, bias=1.0), 0.0, 1.0)
        fg4 = layers.expand(fg, [1, 1, 4])
        cls_loss = layers.reduce_sum(
            layers.sigmoid_cross_entropy_with_logits(score, fg) * sampled)
        box_loss = layers.reduce_sum(layers.smooth_l1(
            loc, target, inside_weight=fg4, outside_weight=fg4, sigma=3.0))
        loss = layers.scale(cls_loss + box_loss, scale=1.0 / 256)
        fluid.optimizer.Momentum(learning_rate=1e-3,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _lod(fluid, rows):
    """A LoDTensor of per-image row arrays."""
    return fluid.create_lod_tensor(np.concatenate(rows, 0),
                                   [[len(r) for r in rows]],
                                   fluid.CPUPlace())


def _gt_rows(rng, n, scale=1.0, labels=True):
    """n corner boxes (times scale) and, with labels, their labels 1-20."""
    xy = rng.uniform(0.0, 0.75, (n, 2))
    box = np.concatenate([xy, np.minimum(xy + rng.uniform(
        0.1, 0.4, (n, 2)), 1.0)], 1).astype('float32') * scale
    if not labels:
        return box
    return box, rng.randint(1, SSD_CLASSES, (n, 1)).astype('int64')


def _ssd_batches(rng):
    """SSD_STEPS (images, [per-image boxes], [per-image labels]): the
    images cycle through SSD_IMAGE_POOL seeded batches, 1-8 boxes an
    image, one image of 9-16 in each of SSD_WIDE_BATCHES."""
    images = [rng.uniform(-1, 1, (SSD_BATCH, 3, SSD_IMAGE, SSD_IMAGE))
              .astype('float32') for _ in range(SSD_IMAGE_POOL)]
    out = []
    for step in range(SSD_STEPS):
        counts = rng.randint(1, 9, SSD_BATCH)
        if step in SSD_WIDE_BATCHES:
            counts[step % SSD_BATCH] = rng.randint(9, 17)
        gts = [_gt_rows(rng, int(n)) for n in counts]
        out.append((images[step % SSD_IMAGE_POOL], [g[0] for g in gts],
                    [g[1] for g in gts]))
    return out


def _ssd_feed(fluid, batch, rows=None, nudge=None):
    images, boxes, labels = batch
    rows = rows or len(boxes)
    img = images[:rows]
    if nudge is not None:
        img = (img * (1 + RESNET_INPUT_NOISE * nudge[:rows])) \
            .astype('float32')
    return {'image': img, 'gt_box': _lod(fluid, boxes[:rows]),
            'gt_label': _lod(fluid, labels[:rows])}


def _det_card_against_cpu(what, main, loss, initial, feed_of, rows):
    """Step 1 of `main` from `initial` at `rows` images on the card and on
    the CPU, and on the CPU again with the images scaled by 1 +
    RESNET_INPUT_NOISE * noise: the loss within max(RESNET_GRAD_TOL,
    RESNET_GRAD_SPREAD x the nudge's move) and the gradients' median
    relative L2 within RESNET_GRAD_SPREAD x the nudge's own (phase 7's
    rule for ResNet-50). Returns the record."""
    from paddle_tpu_torch import fluid
    gnames = _autodiff_grads(main)
    noise = np.random.RandomState(SEED).randn(rows, 3, SSD_IMAGE, SSD_IMAGE)
    outs, secs = {}, {}
    for where, place, nudge in (('card', fluid.CUDAPlace(0), None),
                                ('cpu', fluid.CPUPlace(), None),
                                ('nudged', fluid.CPUPlace(), noise)):
        s = fluid.Scope()
        s.load_numpy(initial, place)
        t0 = time.perf_counter()
        outs[where] = fluid.Executor(place).run(
            main, feed=feed_of(rows, nudge), fetch_list=[loss] + gnames,
            scope=s)
        secs[where] = time.perf_counter() - t0
    med_g, worst_g = _grad_spread(outs, gnames, 'card', 'cpu')
    med_n, worst_n = _grad_spread(outs, gnames, 'nudged', 'cpu')
    lc, lp, ln = (float(np.asarray(outs[w][0]).reshape(-1)[0])
                  for w in ('card', 'cpu', 'nudged'))
    loss_rel, loss_spread = abs(lc - lp) / abs(lp), abs(ln - lp) / abs(lp)
    bad = [n for i, n in enumerate(gnames)
           if not np.isfinite(outs['card'][1 + i]).all()]
    rec = dict(rows=rows, cpu_s=secs['cpu'], card_s=secs['card'],
               loss_card=lc, loss_cpu=lp, loss_rel=loss_rel,
               loss_nudged_rel=loss_spread, grads=len(gnames),
               grad_median_rel=med_g, grad_max_rel=worst_g[0],
               grad_max_name=worst_g[1], nudged_median_rel=med_n,
               nudged_max_rel=worst_n[0])
    log('[detection] %s step 1 from the startup weights, card vs CPU at %d '
        'images (CPU %.2f s): loss %.6f vs %.6f (relative %.3g; the '
        'nudge moves it %.3g); %d gradients, |diff| / |cpu| (L2) median '
        '%.3g, max %.3g (%s); the CPU against itself nudged by %g: median '
        '%.3g, max %.3g' % (what, rows, secs['cpu'], lc, lp, loss_rel,
                             loss_spread, len(gnames), med_g, worst_g[0],
                             worst_g[1], RESNET_INPUT_NOISE, med_n,
                             worst_n[0]))
    if bad or not (loss_rel <= max(RESNET_GRAD_TOL,
                                   RESNET_GRAD_SPREAD * loss_spread)
                   and med_g <= RESNET_GRAD_SPREAD * med_n):
        raise AssertionError(
            '%s step 1, card vs CPU: loss %.3g (the nudge %.3g), gradients '
            '%.3g against the CPU\'s own %.3g (tol %g x), non-finite %r'
            % (what, loss_rel, loss_spread, med_g, med_n,
               RESNET_GRAD_SPREAD, bad))
    return rec


def _ssd_priors(main):
    """The training program's priors and variances, [P, 4] each on the
    card, from its prior_box ops' rule."""
    import torch
    from paddle_tpu_torch.fluid import lowering
    rule = lowering.get_rule('prior_box')
    blk = main.global_block()
    boxes, variances = [], []
    for op in blk.ops:
        if op.type != 'prior_box':
            continue
        fh, fw = blk.var(op.input('Input')[0]).shape[2:]
        out = rule({'Input': [torch.zeros((1, 1, fh, fw)).cuda()],
                    'Image': [torch.zeros((1, 1, SSD_IMAGE, SSD_IMAGE))
                              .cuda()]}, op.attrs, None)
        boxes.append(out['Boxes'].reshape(-1, 4))
        variances.append(out['Variances'].reshape(-1, 4))
    return torch.cat(boxes), torch.cat(variances)


def _kernels_of(fn):
    return sum(device_kernel_counts(fn).values())


def _ssd_loss_alone(main, batch, rec):
    """ssd_loss's rule alone at the step's shapes (its forward and
    backward), and its matching alone, each captured and replayed: their
    device ms and kernels beside the step's."""
    import torch
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.lowering import Ctx, SeqValue
    from paddle_tpu_torch.fluid.ops_impl import detection_ops
    priors, pvar = _ssd_priors(main)
    g = torch.Generator().manual_seed(SEED)
    loc = torch.randn(SSD_BATCH, SSD_PRIORS, 4, generator=g).cuda() \
        .requires_grad_()
    conf = torch.randn(SSD_BATCH, SSD_PRIORS, SSD_CLASSES, generator=g) \
        .cuda().requires_grad_()
    _, boxes, labels = batch
    width = 8
    lens = torch.tensor([len(b) for b in boxes]).cuda()
    gtb = torch.zeros(SSD_BATCH, width, 4)
    gtl = torch.zeros(SSD_BATCH, width, 1, dtype=torch.int64)
    for i, (b, lb) in enumerate(zip(boxes, labels)):
        gtb[i, :len(b)] = torch.from_numpy(b)
        gtl[i, :len(b)] = torch.from_numpy(lb)
    gtb, gtl = gtb.cuda(), gtl.cuda()
    ins = {'Loc': [loc], 'Conf': [conf], 'GtBox': [SeqValue(gtb, lens)],
           'GtLabel': [SeqValue(gtl, lens)], 'PriorBox': [priors],
           'PriorBoxVar': [pvar]}
    rule = lowering.get_rule('ssd_loss')
    ctx = Ctx(torch.device('cuda'))

    def loss_fwd_bwd():
        out = rule(ins, {}, ctx)['Loss']
        torch.autograd.grad(out.sum(), [loc, conf])

    valid = torch.arange(width, device=lens.device)[None] < lens[:, None]
    dist = detection_ops._iou(gtb, priors).masked_fill(~valid[..., None],
                                                       -1e9)

    def matching():
        detection_ops._match(dist, 'per_prediction', 0.5)

    rec['ssd_loss_rule_ms'] = time_graph_ms(loss_fwd_bwd, iters=5)
    rec['ssd_loss_rule_kernels'] = _kernels_of(loss_fwd_bwd)
    rec['matching_ms'] = time_graph_ms(matching, iters=5)
    rec['matching_kernels'] = _kernels_of(matching)


def _ssd_training(rec):
    """(a) MobileNet-SSD trained SSD_STEPS captured steps; the loss falls;
    step 1 card against CPU; returns (scope, executor, the state after
    training, the batches, launch counts)."""
    import torch
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    main, startup, loss = ssd_program(train=True)
    rng = np.random.RandomState(SEED)
    batches = _ssd_batches(rng)
    feeds = [_ssd_feed(fluid, b) for b in batches]
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    n_ops = len(main.global_block().ops)
    log('[detection] MobileNet-SSD (%d ops, %d parameters, %d priors, %d '
        'classes): built, initialized and %d batches of %d made in %.2f s'
        % (n_ops, len(main.all_parameters()), SSD_PRIORS, SSD_CLASSES,
           SSD_STEPS, SSD_BATCH, time.perf_counter() - t0))
    _reset_launch_counts()
    losses, secs, pool = [], [], 0
    for i, feed in enumerate(feeds):
        if i == 1:
            r0 = _reserved()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if i == 1:
            pool = _reserved() - r0
    counts = _launch_counts()
    stats = exe.cache_stats
    replayed = [s for i, s in enumerate(secs)
                if i >= 2 and i not in SSD_WIDE_BATCHES]
    med = float(np.median(replayed))
    first = float(np.mean(losses[:SSD_WINDOW]))
    last = float(np.mean(losses[-SSD_WINDOW:]))
    log('[detection] MobileNet-SSD losses %s'
        % ', '.join('%.4f' % x for x in losses))
    log('[detection] step seconds %s' % ', '.join('%.4f' % x for x in secs))
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError('MobileNet-SSD: the loss did not fall (mean '
                             'of the first %d %.4f, the last %.4f): %r'
                             % (SSD_WINDOW, first, last, losses))
    if stats['captures'] < 2:
        raise AssertionError('MobileNet-SSD: %r captures, want one a time '
                             'bucket (8 and 16)' % (stats,))
    busy, idle, wall, records = _device_busy(
        lambda: exe.run(main, feed=feeds[2], fetch_list=[loss],
                        scope=scope), 3)
    rec['ssd_training'] = dict(
        losses=losses, step_s=secs, median_replay_ms=med * 1e3,
        images_per_s=SSD_BATCH / med, device_busy_ms=busy,
        idle_share=1.0 - busy / (med * 1e3), traced_idle_share=idle,
        kernels_per_replay=records, graph_pool_gb=pool / 1e9,
        cache_stats=dict(stats), ops=n_ops)
    _ssd_loss_alone(main, batches[2], rec['ssd_training'])
    r = rec['ssd_training']
    log('[detection] MobileNet-SSD batch %d: median replay %.4f ms (%.1f '
        'images/s), device busy %.4f ms (idle %.3f of the replay), %.0f '
        'kernels a replay, graph pool %.3f GB, %d captures (buckets 8 and '
        '16); ssd_loss\'s rule alone (forward and backward) %.4f ms, %d '
        'kernels (%.3f of the busy step), its matching %.4f ms, %d kernels'
        % (SSD_BATCH, r['median_replay_ms'], r['images_per_s'], busy,
           r['idle_share'], records, r['graph_pool_gb'], stats['captures'],
           r['ssd_loss_rule_ms'], r['ssd_loss_rule_kernels'],
           r['ssd_loss_rule_ms'] / busy, r['matching_ms'],
           r['matching_kernels']))
    noise_batch = batches[0]
    rec['ssd_step1'] = _det_card_against_cpu(
        'MobileNet-SSD', main, loss, initial,
        lambda rows, nudge: _ssd_feed(fluid, noise_batch, rows, nudge),
        SSD_CPU_BATCH)
    state = scope.to_numpy()
    del exe, scope
    _release()
    return state, counts


def _nms_near_threshold(boxes, scores, attrs):
    """{image: [(class, iou)]} of the pairs among each class's top-k
    candidates whose IoU lies within SSD_NMS_TIE of the NMS threshold."""
    import torch
    from paddle_tpu_torch.fluid.ops_impl import detection_ops
    thr, k = attrs['nms_threshold'], attrs['nms_top_k']
    s = torch.from_numpy(scores).transpose(1, 2)           # [B, C, M]
    b = torch.from_numpy(boxes)
    out = {}
    for i in range(s.shape[0]):
        for c in range(1, s.shape[1]):
            order = torch.argsort(-s[i, c], stable=True)[:k]
            iou = detection_ops._iou(b[i, order], b[i, order])
            near = ((iou - thr).abs() <= SSD_NMS_TIE).triu(1)
            if near.any():
                out.setdefault(i, []).append(
                    (c, float(iou[near][0])))
    return out


def _map_labels(rng, rows):
    """Ground truth an image for detection_map from the served rows: the
    top 3 kept detections' labels and boxes moved by up to 0.03, and 2
    random labelled boxes."""
    out = []
    for r in rows:
        kept = r[r[:, 0] >= 0][:3]
        box = np.clip(kept[:, 2:6] + rng.uniform(-0.03, 0.03,
                                                 kept[:, 2:6].shape), 0, 1)
        rb, rl = _gt_rows(rng, 2)
        out.append(np.concatenate([
            np.concatenate([kept[:, :1], box], 1),
            np.concatenate([rl.astype('float32'), rb], 1)], 0)
            .astype('float32'))
    return out


def _ssd_serving(tmp, state, rec):
    """(a) The detection_output program served through Predictor on the
    card: rows against the CPU rule, replay and NMS timings, mAP card
    against CPU. Returns launch counts."""
    import torch
    from paddle_tpu_torch import fluid, inference
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.lowering import Ctx
    from paddle_tpu_torch.fluid.ops_impl import detection_ops
    main, startup, nmsed = ssd_program(train=False)
    blk = main.global_block()
    nms_op = [op for op in blk.ops if op.type == 'multiclass_nms'][0]
    dec, sc = blk.var(nms_op.input('BBoxes')[0]), \
        blk.var(nms_op.input('Scores')[0])
    scope = fluid.Scope()
    scope.load_numpy(state, fluid.CUDAPlace(0))
    exe = fluid.Executor()
    d = os.path.join(tmp, 'mobilenet_ssd')
    fluid.io.save_inference_model(d, ['image'], [nmsed, dec, sc], exe,
                                  main_program=main, scope=scope)
    del scope, exe
    rng = np.random.RandomState(SEED + 1)
    images = [rng.uniform(-1, 1, (SSD_SERVE_BATCH, 3, SSD_IMAGE, SSD_IMAGE))
              .astype('float32') for _ in range(SSD_MAP_BATCHES)]
    pred = inference.Predictor(d)
    _reset_launch_counts()
    pool = _pool_of(lambda: pred.run({'image': images[0]}))
    outs = [pred.run({'image': x}) for x in images]
    counts = _launch_counts()
    nms_rule = lowering.get_rule('multiclass_nms')
    cpu_ctx = Ctx(torch.device('cpu'))
    equal, excused = 0, {}
    for rows, boxes, scores in outs:
        if rows.shape != (SSD_SERVE_BATCH, SSD_NMS['keep_top_k'], 6) or \
                not np.isfinite(rows).all() or rows[..., 0].min() < -1 or \
                rows[..., 0].max() >= SSD_CLASSES:
            raise AssertionError('served rows: shape %r, labels %r..%r'
                                 % (rows.shape, rows[..., 0].min(),
                                    rows[..., 0].max()))
        want = nms_rule({'BBoxes': [torch.from_numpy(boxes)],
                         'Scores': [torch.from_numpy(scores)]},
                        nms_op.attrs, cpu_ctx)['Out'].numpy()
        near = None
        for i in range(SSD_SERVE_BATCH):
            if np.array_equal(rows[i], want[i]):
                equal += 1
                continue
            near = near if near is not None else \
                _nms_near_threshold(boxes, scores, nms_op.attrs)
            if i not in near:
                bad = np.argwhere((rows[i] != want[i]).any(-1))[:, 0]
                raise AssertionError(
                    'image %d: the card\'s NMS rows %r differ from the CPU '
                    'rule\'s on the same boxes and scores, and no IoU of '
                    'its candidates lies within %g of the threshold: card '
                    '%r, cpu %r' % (i, bad[:5].tolist(), SSD_NMS_TIE,
                                    rows[i, bad[:2]], want[i, bad[:2]]))
            excused[len(excused)] = near[i]
    kept = float(np.mean([(r[0][..., 0] >= 0).sum(-1).mean() for r in outs]))
    feed = {'image': images[0]}
    timed = _in_turns({'replay': lambda: pred.run(feed)}, n=SSD_TIMED)
    busy, idle, wall, records = _device_busy(lambda: pred.run(feed), 3)
    # the multiclass_nms rule alone, and its suppression loop alone, on the
    # card on the first batch's decoded boxes and scores
    boxes = torch.from_numpy(outs[0][1]).cuda()
    scores = torch.from_numpy(outs[0][2]).cuda()
    ctx = Ctx(torch.device('cuda'))

    def nms():
        nms_rule({'BBoxes': [boxes], 'Scores': [scores]}, nms_op.attrs, ctx)

    s = detection_ops._drop_class(scores.transpose(1, 2), 1, 0)
    order = torch.argsort(-s, dim=-1, stable=True)[..., :SSD_NMS['nms_top_k']]
    cand = torch.gather(boxes[:, None].expand(-1, s.shape[1], -1, -1), 2,
                        order[..., None].expand(-1, -1, -1, 4))
    iou = detection_ops._iou(cand, cand)
    valid = torch.gather(s, -1, order) > SSD_NMS['score_threshold']

    def loop():
        detection_ops._nms_keep(iou, valid, SSD_NMS['nms_threshold'], 1.0)

    nms_ms, loop_ms = time_graph_ms(nms, iters=3), time_graph_ms(loop, iters=3)
    rec['ssd_serving'] = dict(
        batch=SSD_SERVE_BATCH, rows_equal=equal,
        rows_excused=excused, kept_rows_mean=kept,
        replay_ms=timed['replay'], device_busy_ms=busy,
        idle_share=1.0 - busy / timed['replay'], traced_idle_share=idle,
        kernels_per_replay=records, graph_pool_gb=pool / 1e9,
        nms_rule_ms=nms_ms, nms_rule_kernels=_kernels_of(nms),
        nms_loop_ms=loop_ms, nms_loop_kernels=_kernels_of(loop),
        nms_share_of_busy=nms_ms / busy)
    r = rec['ssd_serving']
    log('[detection] served MobileNet-SSD detection_output at batch %d: %d '
        'of %d image rows equal to the CPU rule on the card\'s boxes and '
        'scores, %d decided within %g of the threshold %r; %.1f kept rows '
        'an image; replay %.4f ms (median of %d), device busy %.4f ms, '
        '%.0f kernels a replay, graph pool %.3f GB; multiclass_nms alone '
        '%.4f ms, %d kernels (%.3f of the busy replay), its suppression '
        'loop %.4f ms, %d kernels'
        % (SSD_SERVE_BATCH, equal, SSD_SERVE_BATCH * len(outs),
           len(excused), SSD_NMS_TIE, excused, kept, r['replay_ms'],
           SSD_TIMED, busy, records, r['graph_pool_gb'], nms_ms,
           r['nms_rule_kernels'], r['nms_share_of_busy'], loop_ms,
           r['nms_loop_kernels']))
    _ssd_map([o[0] for o in outs], rng, rec)
    del pred
    _release()
    return counts


def _ssd_map(served, rng, rec):
    """detection_map over the served batches through
    fluid.metrics.DetectionMAP, card against CPU."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    layers = fluid.layers
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        det = layers.data(name='det', shape=[SSD_NMS['keep_top_k'], 6])
        gt = layers.data(name='gt', shape=[5], lod_level=1)
        m = layers.detection_map(det, gt, class_num=SSD_CLASSES,
                                 overlap_threshold=0.5)
    exes = {'card': fluid.Executor(), 'cpu': fluid.Executor(fluid.CPUPlace())}
    metrics = {w: fluid.metrics.DetectionMAP() for w in exes}
    per = {w: [] for w in exes}
    for rows in served:
        labels = _map_labels(rng, rows)
        feed = {'det': rows, 'gt': _lod(fluid, labels)}
        for w, e in exes.items():
            v = float(np.asarray(e.run(main, feed=feed, fetch_list=[m],
                                       scope=fluid.Scope())[0]))
            per[w].append(v)
            metrics[w].update(v)
    got, want = metrics['card'].eval(), metrics['cpu'].eval()
    diff = max(abs(a - b) for a, b in zip(per['card'], per['cpu']))
    map_op = [op for op in main.global_block().ops
              if op.type == 'detection_map'][0]
    loop_ms, loop_kernels = _map_rule_alone(served[-1], labels,
                                            map_op.attrs)
    rec['ssd_map'] = dict(card=got, cpu=want, per_batch_card=per['card'],
                          per_batch_cpu=per['cpu'], max_abs_diff=diff,
                          rule_ms=loop_ms, rule_kernels=loop_kernels)
    log('[detection] detection_map (integral, overlap 0.5) over %d served '
        'batches through DetectionMAP: card %.6f, CPU %.6f (per batch %s; '
        'max |diff| %.3g, tol %g); the rule alone on a batch %.4f ms, %d '
        'kernels' % (len(served), got, want,
                     ', '.join('%.4f' % v for v in per['card']), diff,
                     SSD_MAP_TOL, loop_ms, loop_kernels))
    if not (0.0 < got <= 1.0 and diff <= SSD_MAP_TOL):
        raise AssertionError('detection_map card %r, CPU %r, per batch '
                             '%r / %r' % (got, want, per['card'],
                                          per['cpu']))


def _map_rule_alone(rows, labels, attrs):
    """detection_map's rule alone on the card on one served batch (its
    labels padded to the feeder's bucket of 8), captured and replayed:
    (device ms, kernels)."""
    import torch
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.lowering import Ctx, SeqValue
    lab = np.zeros((len(labels), 8, 5), 'float32')
    for i, r in enumerate(labels):
        lab[i, :len(r)] = r
    ins = {'DetectRes': [torch.from_numpy(rows).cuda()],
           'Label': [SeqValue(torch.from_numpy(lab).cuda(), torch.tensor(
               [len(r) for r in labels]).cuda())]}
    rule = lowering.get_rule('detection_map')
    ctx = Ctx(torch.device('cuda'))

    def fn():
        rule(ins, attrs, ctx)

    return time_graph_ms(fn, iters=3), _kernels_of(fn)


def _rpn(rec):
    """(b) The RPN head: RPN_STEPS captured steps at RPN_BATCH, step 1
    card against CPU. Returns launch counts."""
    import torch
    from paddle_tpu_torch import fluid
    main, startup, loss = rpn_program()
    rng = np.random.RandomState(SEED + 2)
    images = rng.uniform(-1, 1, (RPN_BATCH, 3, SSD_IMAGE, SSD_IMAGE)) \
        .astype('float32')
    batches = [(images, [_gt_rows(rng, int(n), scale=SSD_IMAGE,
                                  labels=False)
                         for n in rng.randint(1, 9, RPN_BATCH)])
               for _ in range(RPN_STEPS)]

    def feed_of(batch, rows=None, nudge=None):
        img, boxes = batch
        rows = rows or len(boxes)
        img = img[:rows]
        if nudge is not None:
            img = (img * (1 + RESNET_INPUT_NOISE * nudge[:rows])) \
                .astype('float32')
        return {'image': img, 'gt_box': _lod(fluid, boxes[:rows])}

    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    _reset_launch_counts()
    losses, secs = [], []
    for b in batches:
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed_of(b), fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
    counts = _launch_counts()
    if not np.isfinite(losses).all() or exe.cache_stats['replays'] < 1:
        raise AssertionError('RPN: losses %r, cache %r'
                             % (losses, exe.cache_stats))
    med = float(np.median(secs[2:]))
    rec['rpn_training'] = dict(losses=losses, step_s=secs,
                               median_replay_ms=med * 1e3,
                               images_per_s=RPN_BATCH / med,
                               anchors=RPN_ANCHORS)
    log('[detection] RPN head (%d anchors) at batch %d: losses %s; median '
        'replay %.4f ms (%.1f images/s)'
        % (RPN_ANCHORS, RPN_BATCH, ', '.join('%.4f' % x for x in losses),
           med * 1e3, RPN_BATCH / med))
    rec['rpn_step1'] = _det_card_against_cpu(
        'RPN head', main, loss, initial,
        lambda rows, nudge: feed_of(batches[0], rows, nudge), RPN_CPU_BATCH)
    del exe, scope
    _release()
    return counts


def _vision_cases(rng):
    """(op type, inputs, attrs, output slot, inputs to differentiate) of
    the 14 rules at vision sizes."""
    def f(*shape):
        return rng.randn(*shape).astype('float32')

    rois = np.concatenate([rng.randint(0, 2, (128, 1)),
                           _gt_rows(rng, 128, scale=SSD_IMAGE,
                                    labels=False)], 1).astype('float32')
    probs = np.abs(f(8, 2, 64, 64))
    probs /= probs.sum(1, keepdims=True)
    one = dict(strides=[1, 1, 1], paddings=[1, 1, 1], dilations=[1, 1, 1],
               groups=1)
    return [
        ('conv3d', {'Input': [f(2, 16, 16, 16, 16)],
                    'Filter': [f(32, 16, 3, 3, 3)]}, one, 'Output',
         ['Input', 'Filter']),
        ('conv2d_transpose', {'Input': [f(8, 512, 19, 19)],
                              'Filter': [f(512, 256, 4, 4)]},
         dict(strides=[2, 2], paddings=[1, 1], dilations=[1, 1], groups=1),
         'Output', ['Input', 'Filter']),
        ('conv3d_transpose', {'Input': [f(2, 16, 8, 8, 8)],
                              'Filter': [f(16, 8, 4, 4, 4)]},
         dict(one, strides=[2, 2, 2]), 'Output', ['Input', 'Filter']),
        ('pool3d', {'X': [f(2, 16, 16, 16, 16)]},
         dict(pooling_type='max', ksize=[2, 2, 2], strides=[2, 2, 2],
              paddings=[0, 0, 0]), 'Out', ['X']),
        ('smooth_l1_loss', {'X': [f(16, 256, 4)], 'Y': [f(16, 256, 4)],
                            'InsideWeight': [np.abs(f(16, 256, 4))],
                            'OutsideWeight': [np.abs(f(16, 256, 4))]},
         {'sigma': 3.0}, 'Out', ['X', 'Y']),
        ('rank_loss', {'Label': [(rng.rand(256, 1) > 0.5)
                                 .astype('float32')],
                       'Left': [f(256, 1)], 'Right': [f(256, 1)]}, {},
         'Out', ['Left', 'Right']),
        ('dice_loss', {'X': [probs], 'Label': [(rng.rand(8, 2, 64, 64) > 0.5)
                                               .astype('int64')]},
         {'epsilon': 1e-5}, 'Out', ['X']),
        ('huber_loss', {'X': [f(256, 1)], 'Y': [f(256, 1)]},
         {'delta': 1.0}, 'Out', ['X', 'Y']),
        ('lrn', {'X': [f(8, 96, 55, 55)]},
         {'n': 5, 'k': 1.0, 'alpha': 1e-4, 'beta': 0.75}, 'Out', ['X']),
        ('prelu', {'X': [f(8, 64, 38, 38)], 'Alpha': [f(1, 64, 1, 1)]},
         {'mode': 'channel'}, 'Out', ['X', 'Alpha']),
        ('bilinear_interp', {'X': [f(8, 256, 19, 19)]},
         {'out_h': 38, 'out_w': 38}, 'Out', ['X']),
        ('bilinear_interp', {'X': [f(8, 32, 150, 150)]},
         {'out_h': 75, 'out_w': 75}, 'Out', ['X']),
        ('nearest_interp', {'X': [f(8, 256, 19, 19)]},
         {'out_h': 38, 'out_w': 38}, 'Out', ['X']),
        ('roi_pool', {'X': [f(2, 512, 19, 19)], 'ROIs': [rois]},
         {'pooled_height': 7, 'pooled_width': 7,
          'spatial_scale': 1.0 / 16}, 'Out', ['X']),
        ('mean_iou', {'Predictions': [rng.randint(0, SSD_CLASSES,
                                                  (8, 64, 64))],
                      'Labels': [rng.randint(0, SSD_CLASSES, (8, 64, 64))]},
         {'num_classes': SSD_CLASSES}, 'OutMeanIou', []),
    ]


@contextlib.contextmanager
def _sync_checked(on_card):
    """torch.cuda.set_sync_debug_mode('error') inside the block on the card:
    a rule that waits for the card there raises."""
    import torch
    if not on_card:
        yield
        return
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _vision_rule(op_type, ins, attrs, slot, wrt, device, cot):
    """The rule on `device` under the sync check (on the card), its output
    and the VJP of sum(out * cot) for wrt, as numpy."""
    import torch
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.fluid.lowering import Ctx
    card = device == 'cuda'

    def put(a):
        t = torch.from_numpy(np.array(a))
        return t.cuda() if card else t

    tins = {s: [put(a) for a in vs] for s, vs in ins.items()}
    leaves = [tins[s][0].requires_grad_() for s in wrt]
    with _sync_checked(card):
        outs = lowering.get_rule(op_type)(tins, attrs,
                                          Ctx(torch.device(device)))
    out = outs[slot]
    grads = torch.autograd.grad((out * put(cot)).sum(), leaves) if wrt \
        else []
    extra = [outs[s].cpu().numpy() for s in ('OutWrong', 'OutCorrect')
             if op_type == 'mean_iou']
    return out.detach().cpu().numpy(), [g.cpu().numpy() for g in grads], \
        extra


def _vision_ops(rec):
    """(c) Each of the 14 rules on the card against its CPU rule, forward
    and VJP."""
    rng = np.random.RandomState(SEED + 3)
    rows = []
    for op_type, ins, attrs, slot, wrt in _vision_cases(rng):
        shape = _vision_rule(op_type, ins, attrs, slot, [], 'cpu',
                             None)[0].shape
        cot = np.asarray(rng.randn(*shape), 'float32')
        cpu, cpu_g, cpu_x = _vision_rule(op_type, ins, attrs, slot, wrt,
                                         'cpu', cot)
        card, card_g, card_x = _vision_rule(op_type, ins, attrs, slot, wrt,
                                            'cuda', cot)
        err = float(np.abs(card - cpu).max()) / max(1.0,
                                                    float(np.abs(cpu).max()))
        gerr = max([float(np.abs(a - b).max()) / max(1.0, float(
            np.abs(b).max())) for a, b in zip(card_g, cpu_g)] or [0.0])
        exact = all(np.array_equal(a, b) for a, b in zip(card_x, cpu_x))
        rows.append(dict(op=op_type, shape=list(card.shape), out_err=err,
                         vjp_err=gerr, counts_equal=exact))
        if not (err <= VISION_TOL and gerr <= VISION_TOL and exact):
            raise AssertionError('%s on the card against the CPU rule: '
                                 'output %.3g, VJP %.3g (tol %g), counts '
                                 'equal %r' % (op_type, err, gerr,
                                               VISION_TOL, exact))
    rec['vision_ops'] = rows
    log('[detection] the 14 vision rules, card against CPU (forward and '
        'VJP, |diff| over max(1, |cpu|), tol %g): %s'
        % (VISION_TOL, '; '.join('%s %s %.2g / %.2g' % (
            r['op'], 'x'.join(map(str, r['shape'])), r['out_err'],
            r['vjp_err']) for r in rows)))


def phase_detection():
    """Phase 7l: (a) MobileNet-SSD trained and served, mAP; (b) an RPN
    head; (c) the 14 vision rules op by op. Returns {path: launch counts}
    of ssd_training, ssd_serving and rpn_training (no kernel of the port
    runs on them)."""
    import torch
    t0 = time.perf_counter()
    rec = {}
    counts = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_detection_') as tmp:
        state, counts['ssd_training'] = _ssd_training(rec)
        counts['ssd_serving'] = _ssd_serving(tmp, state, rec)
    del state
    counts['rpn_training'] = _rpn(rec)
    _vision_ops(rec)
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log(json.dumps({'detection': rec}))
    log('[detection] phase 7l took %.1f s' % rec['seconds'])
    return counts


# -- phase 7m: the rest of the training surface -------------------------------

def build_word2vec_head(head):
    """word2vec's N-gram net at get_model's widths (models/word2vec.py: four
    context words read one shared 2073x32 table, concatenated, fc 256
    sigmoid) with layers.nce (W2V_NEG negatives) or layers.hsigmoid over
    the vocabulary in place of its softmax, mean, get_model's SGD (at
    W2V_NCE_LR for nce); its reader at get_model's batch 64. Returns
    (main, startup, avg_cost, reader, feed names)."""
    from paddle_tpu_torch import batch, fluid
    from paddle_tpu_torch.dataset import imikolov
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import word2vec
    word_dict = imikolov.build_dict()
    if len(word_dict) != W2V_DICT:
        raise AssertionError('imikolov.build_dict() has %d words, not %d'
                             % (len(word_dict), W2V_DICT))
    main, startup = _program_pair()
    names = ['word_%d' % i for i in range(word2vec.N)]
    with unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        words = [layers.data(name=n, shape=[1], dtype='int64')
                 for n in names]
        embeds = [layers.embedding(
            input=w, size=[W2V_DICT, word2vec.EMBED_SIZE],
            param_attr=fluid.ParamAttr(name='shared_w')) for w in words[:-1]]
        hidden = layers.fc(input=layers.concat(input=embeds, axis=1),
                           size=word2vec.HIDDEN_SIZE, act='sigmoid')
        if head == 'nce':
            cost = layers.nce(input=hidden, label=words[-1],
                              num_total_classes=W2V_DICT)
        else:
            cost = layers.hsigmoid(input=hidden, label=words[-1],
                                   num_classes=W2V_DICT)
        avg_cost = layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=W2V_NCE_LR if head == 'nce'
                            else W2V_LR).minimize(avg_cost)
    reader = batch(imikolov.train(word_dict, word2vec.N), 64)
    return main, startup, avg_cost, reader, names


def _w2v_feeds(reader, names, n):
    """n feeds of the reader's full batches, its epoch cycled."""
    epoch = [np.asarray(b, 'int64') for b in reader() if len(b) == 64]
    return [{name: epoch[i % len(epoch)][:, j:j + 1].copy()
             for j, name in enumerate(names)} for i in range(n)]


def _op_of(program, op_type):
    return [op for op in program.global_block().ops
            if op.type == op_type][0]


def _w2v_card_against_cpu(what, main, loss, initial, feed):
    """Step 1 of `main` from `initial` on the card and on the CPU, and on
    the CPU again from the weights nudged by AMP_STATE_NOISE: the loss
    within max(RESNET_GRAD_TOL, RESNET_GRAD_SPREAD x the nudge's move) and
    the gradients' median relative L2 within RESNET_GRAD_SPREAD x the
    nudge's own. Returns the record."""
    from paddle_tpu_torch import fluid
    gnames = _autodiff_grads(main)
    nudged = _nudged(initial, np.random.RandomState(SEED))
    outs = {}
    for where, place, state in (('card', fluid.CUDAPlace(0), initial),
                                ('cpu', fluid.CPUPlace(), initial),
                                ('nudged', fluid.CPUPlace(), nudged)):
        s = fluid.Scope()
        s.load_numpy(state, place)
        outs[where] = fluid.Executor(place).run(
            main, feed=feed, fetch_list=[loss] + gnames, scope=s)
    med_g, worst_g = _grad_spread(outs, gnames, 'card', 'cpu')
    med_n, worst_n = _grad_spread(outs, gnames, 'nudged', 'cpu')
    lc, lp, ln = (float(np.asarray(outs[w][0]).reshape(-1)[0])
                  for w in ('card', 'cpu', 'nudged'))
    loss_rel, loss_spread = abs(lc - lp) / abs(lp), abs(ln - lp) / abs(lp)
    rec = dict(loss_card=lc, loss_cpu=lp, loss_rel=loss_rel,
               loss_nudged_rel=loss_spread, grads=len(gnames),
               grad_median_rel=med_g, grad_max_rel=worst_g[0],
               grad_max_name=worst_g[1], nudged_median_rel=med_n,
               nudged_max_rel=worst_n[0])
    log('[surface] %s step 1 from the startup weights, card vs CPU: loss '
        '%.6f vs %.6f (relative %.3g; the nudge moves it %.3g); %d '
        'gradients, |diff| / |cpu| (L2) median %.3g, max %.3g (%s); the '
        'CPU against itself nudged by %g: median %.3g, max %.3g'
        % (what, lc, lp, loss_rel, loss_spread, len(gnames), med_g,
           worst_g[0], worst_g[1], AMP_STATE_NOISE, med_n, worst_n[0]))
    if not (loss_rel <= max(RESNET_GRAD_TOL, RESNET_GRAD_SPREAD * loss_spread)
            and med_g <= RESNET_GRAD_SPREAD * med_n):
        raise AssertionError(
            '%s step 1, card vs CPU: loss %.3g (the nudge %.3g), gradients '
            '%.3g against the CPU\'s own %.3g (tol %g x)'
            % (what, loss_rel, loss_spread, med_g, med_n,
               RESNET_GRAD_SPREAD))
    return rec


def _w2v_nce_cost_check(main, fetch, state, feed, card_out):
    """The step's Cost on the card against the same step on the CPU from
    the same weights, the CPU's draw replaced by the negatives the card's
    step drew (sampled_ops.nce_negatives patched for this one run)."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.ops_impl import sampled_ops
    labels = np.asarray(card_out[1])
    neg = torch.from_numpy(labels[0, 1:].copy())
    real = sampled_ops.nce_negatives
    sampled_ops.nce_negatives = lambda n, k, device, generator: \
        neg.to(device)
    try:
        s = fluid.Scope()
        s.load_numpy(state, fluid.CPUPlace())
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=s)
    finally:
        sampled_ops.nce_negatives = real
    if not np.array_equal(np.asarray(cpu[1]), labels):
        raise AssertionError('word2vec NCE: the CPU step did not take the '
                             'card\'s negatives')
    card_cost, cpu_cost = np.asarray(card_out[2]), np.asarray(cpu[2])
    return float(np.abs(card_cost - cpu_cost).max()) / max(
        1.0, float(np.abs(cpu_cost).max()))


def _w2v_train(head, rec):
    """(a) / (b): word2vec with the `head` trained W2V_STEPS captured
    steps; the loss falls; NCE's draws and Cost, or hsigmoid's step 1, as
    the phase's note says. Returns the launch counts."""
    import torch
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    main, startup, loss, reader, names = build_word2vec_head(head)
    feeds = _w2v_feeds(reader, names, W2V_STEPS)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    fetch = [loss]
    if head == 'nce':
        op = _op_of(main, 'nce')
        fetch += [op.output('SampleLabels')[0], op.output('Cost')[0]]
    what = 'word2vec ' + head
    log('[surface] %s (%d ops, %d parameters): built, initialized and %d '
        'batches of 64 read in %.2f s' % (
            what, len(main.global_block().ops), len(main.all_parameters()),
            len(feeds), time.perf_counter() - t0))
    _reset_launch_counts()
    losses, secs, pool, kept, before = [], [], 0, {}, None
    for i, feed in enumerate(feeds):
        if i == 1:
            r0 = _reserved()
        if head == 'nce' and i == W2V_COST_STEP:
            before = scope.to_numpy()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 1:
            pool = _reserved() - r0
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
        if i in (2, 3, W2V_COST_STEP):
            kept[i] = out
    counts = _launch_counts()
    stats = dict(exe.cache_stats)
    first = float(np.mean(losses[:W2V_WINDOW]))
    last = float(np.mean(losses[-W2V_WINDOW:]))
    log('[surface] %s losses every 10th step %s' % (
        what, ', '.join('%.5f' % x for x in losses[::10])))
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError('%s: the loss did not fall (mean of the first '
                             '%d %.5f, the last %.5f)' % (
                                 what, W2V_WINDOW, first, last))
    if stats['captures'] != 1 or stats['replays'] != W2V_STEPS - 1:
        raise AssertionError('%s: %r after %d steps' % (what, stats,
                                                        W2V_STEPS))
    med = float(np.median(secs[2:]))
    busy, idle, wall, records = _device_busy(
        lambda: exe.run(main, feed=feeds[2], fetch_list=[loss],
                        scope=scope), 3)
    r = dict(losses_first_mean=first, losses_last_mean=last,
             losses=losses, median_replay_ms=med * 1e3,
             samples_per_s=64 / med, device_busy_ms=busy,
             idle_share=1.0 - busy / (med * 1e3), traced_idle_share=idle,
             kernels_per_replay=records, graph_pool_gb=pool / 1e9,
             cache_stats=stats)
    if head == 'nce':
        a, b = (np.asarray(kept[i][1]) for i in (2, 3))
        shared = all((np.asarray(kept[i][1])[:, 1:]
                      == np.asarray(kept[i][1])[0, 1:]).all() for i in kept)
        if np.array_equal(a[0, 1:], b[0, 1:]) or not shared:
            raise AssertionError('word2vec NCE: replays 2 and 3 drew the '
                                 'same negatives %r, or a step\'s rows did '
                                 'not share theirs' % (a[0, 1:],))
        r['negatives_replay_2'] = a[0, 1:].tolist()
        r['negatives_replay_3'] = b[0, 1:].tolist()
        r['cost_err'] = _w2v_nce_cost_check(main, fetch, before,
                                            feeds[W2V_COST_STEP],
                                            kept[W2V_COST_STEP])
        if not r['cost_err'] <= W2V_COST_TOL:
            raise AssertionError('word2vec NCE step %d: Cost %.3g from the '
                                 'CPU\'s on the same negatives (tol %g)'
                                 % (W2V_COST_STEP, r['cost_err'],
                                    W2V_COST_TOL))
        tail = ('; negatives of replays 2 and 3 %s / %s; step %d\'s Cost '
                'against the CPU on its negatives %.3g'
                % (r['negatives_replay_2'], r['negatives_replay_3'],
                   W2V_COST_STEP, r['cost_err']))
    else:
        r['step1'] = _w2v_card_against_cpu(what, main, loss, initial,
                                           feeds[0])
        tail = ''
    log('[surface] %s: %d captured steps at batch 64, loss %.5f -> %.5f '
        '(means of the first and last %d), median replay %.4f ms (%.0f '
        'samples/s), device busy %.4f ms (idle %.3f of the replay), %.0f '
        'kernels a replay, graph pool %.3f GB%s'
        % (what, W2V_STEPS, first, last, W2V_WINDOW, med * 1e3, 64 / med,
           busy, r['idle_share'], records, r['graph_pool_gb'], tail))
    rec['w2v_' + head] = r
    del exe, scope
    _release()
    return counts


def _extra_cases(rng):
    """The 27 rules, each a spec: op, ins {slot: array}, attrs, the output
    slots (the first one's VJP is checked), wrt (inputs made parameters
    and differentiated), layer (built through generate_layer_fn), inplace
    {output slot: parameter input slot}."""
    import torch
    from paddle_tpu_torch.fluid import lowering

    def f(*s):
        return np.asarray(rng.randn(*s), 'float32')

    def lab(*s):
        return (rng.rand(*s) > 0.5).astype('float32')

    x_pool = f(8, 16, 32, 32)
    pool_attrs = {'ksize': [3, 3], 'strides': [2, 2], 'paddings': [1, 1]}
    pooled = lowering.get_rule('max_pool2d_with_index')(
        {'X': [torch.from_numpy(x_pool)]}, pool_attrs,
        lowering.Ctx(torch.device('cpu')))
    match = np.where(rng.rand(32, 2278) < 0.05,
                     rng.randint(0, 8, (32, 2278)), -1).astype('int32')
    rows = np.float32([[0.1, 0.2, 0.3, 0.4, 0.0], [0.97, 0.01, 0.01, 0.01,
                                                   0.0],
                       [0.0, 0.5, 0.0, 0.25, 0.25], [0.2] * 5])
    return [
        dict(op='cumsum', ins={'X': f(64, 256)}, wrt=['X'], layer=True,
             attrs={'axis': 1, 'exclusive': True, 'reverse': True}),
        dict(op='l1_norm', ins={'X': f(64, 256)}, wrt=['X'], layer=True),
        dict(op='squared_l2_norm', ins={'X': f(64, 256)}, wrt=['X'],
             layer=True),
        dict(op='squared_l2_distance', ins={'X': f(64, 128),
                                            'Y': f(1, 128)},
             wrt=['X', 'Y'], layer=True),
        dict(op='minus', ins={'X': f(64, 256), 'Y': f(64, 256)},
             wrt=['X', 'Y'], layer=True),
        dict(op='fill', ins={}, outs=['Out'], attrs={
            'shape': [4, 8], 'value': rng.randn(32).tolist(),
            'dtype': 'float32'}),
        dict(op='fill_zeros_like', ins={'X': f(64, 256)}, layer=True),
        dict(op='norm', ins={'X': f(64, 32, 8)}, wrt=['X'], layer=True,
             attrs={'axis': 1, 'epsilon': 1e-10}),
        dict(op='log_loss', ins={'Predicted': rng.uniform(
            0.05, 0.95, (64, 1)).astype('float32'), 'Labels': lab(64, 1)},
             outs=['Loss'], wrt=['Predicted'], attrs={'epsilon': 1e-4}),
        dict(op='hinge_loss', ins={'Logits': f(64, 1), 'Labels': lab(64, 1)},
             outs=['Loss'], wrt=['Logits']),
        dict(op='margin_rank_loss', ins={
            'Label': np.where(rng.rand(64, 1) > 0.5, 1.0, -1.0).astype(
                'float32'), 'X1': f(64, 1), 'X2': f(64, 1)},
             outs=['Out', 'Activated'], wrt=['X1', 'X2'],
             attrs={'margin': 0.1}),
        dict(op='modified_huber_loss', ins={'X': f(64, 1), 'Y': lab(64, 1)},
             outs=['Out', 'IntermediateVal'], wrt=['X']),
        dict(op='sampling_id', ins={'X': np.repeat(rows, EXTRA_DRAWS, 0)},
             layer=True, law=rows),
        dict(op='conv_shift', ins={'X': f(64, 256), 'Y': f(64, 5)},
             wrt=['X', 'Y'], layer=True),
        dict(op='bilinear_tensor_product', ins={
            'X': f(64, 32), 'Y': f(64, 24), 'Weight': f(16, 32, 24),
            'Bias': f(1, 16)}, wrt=['X', 'Y', 'Weight', 'Bias']),
        dict(op='proximal_gd', ins={
            'Param': f(64, 256), 'Grad': f(64, 256),
            'LearningRate': np.float32([0.1])},
             outs=['ParamOut'], params=['Param'],
             inplace={'ParamOut': 'Param'}, attrs={'l1': 0.01, 'l2': 0.02}),
        dict(op='proximal_adagrad', ins={
            'Param': f(64, 256), 'Moment': np.abs(f(64, 256)) + 0.1,
            'Grad': f(64, 256), 'LearningRate': np.float32([0.1])},
             outs=['ParamOut', 'MomentOut'], params=['Param', 'Moment'],
             inplace={'ParamOut': 'Param', 'MomentOut': 'Moment'},
             attrs={'l1': 0.01, 'l2': 0.02}),
        dict(op='max_pool2d_with_index', ins={'X': x_pool},
             outs=['Out', 'Mask'], wrt=['X'], attrs=pool_attrs),
        dict(op='unpool', ins={
            'X': pooled['Out'].numpy(), 'Indices': pooled['Mask'].numpy()},
             wrt=['X'], attrs=dict(pool_attrs, unpooling_type='max',
                                   output_size=[32, 32])),
        dict(op='spp', ins={'X': f(8, 16, 13, 13)}, wrt=['X'], layer=True,
             attrs={'pyramid_height': 3, 'pooling_type': 'max'}),
        dict(op='positive_negative_pair', ins={
            'Score': np.round(f(256, 2), 1),
            'Label': rng.randint(0, 3, (256, 1)).astype('float32'),
            'QueryID': rng.randint(0, 16, (256, 1)).astype('int64'),
            'Weight': np.abs(f(256, 1))},
             outs=['PositivePair', 'NegativePair', 'NeutralPair'],
             attrs={'column': 1}),
        dict(op='precision_recall', ins={
            'Indices': rng.randint(0, 10, (256, 1)).astype('int64'),
            'Labels': rng.randint(0, 10, (256, 1)).astype('int64'),
            'Weights': np.abs(f(256, 1)), 'StatesInfo': np.abs(f(10, 4))},
             outs=['BatchMetrics', 'AccumMetrics', 'AccumStatesInfo'],
             attrs={'class_number': 10}),
        dict(op='fake_quantize', ins={'X': f(64, 256)},
             outs=['Out', 'OutMovingScale'], wrt=['X'],
             attrs={'bit_length': 8}),
        dict(op='fake_dequantize_max_abs', ins={
            'X': np.round(f(64, 256) * 40), 'Scale': np.float32([2.7])},
             wrt=['X', 'Scale'], attrs={'num_bits': 8}),
        dict(op='mine_hard_examples', ins={
            'ClsLoss': np.round(np.abs(f(32, 2278)), 1),
            'MatchIndices': match, 'MatchDist': rng.rand(32, 2278).astype(
                'float32')},
             outs=['NegIndices', 'UpdatedMatchIndices'],
             attrs={'neg_pos_ratio': 3.0, 'neg_dist_threshold': 0.5}),
        dict(op='nce', ins={
            'Input': f(64, 256), 'Label': rng.randint(
                0, W2V_DICT, (64, 1)).astype('int64'),
            'Weight': f(W2V_DICT, 256) * 0.1, 'Bias': f(W2V_DICT, 1) * 0.1},
             outs=['Cost', 'SampleLogits', 'SampleLabels'],
             wrt=['Input', 'Weight', 'Bias'],
             attrs={'num_total_classes': W2V_DICT,
                    'num_neg_samples': W2V_NEG}),
        dict(op='hierarchical_sigmoid', ins={
            'X': f(64, 256), 'W': f(W2V_DICT - 1, 256) * 0.1,
            'Bias': f(1, W2V_DICT - 1) * 0.1, 'Label': rng.randint(
                0, W2V_DICT, (64, 1)).astype('int64')},
             outs=['Out', 'PreOut'], wrt=['X', 'W', 'Bias'],
             attrs={'num_classes': W2V_DICT}),
    ]


def _extra_program(spec, rng):
    """One program of the rule: its parameters (wrt and in-place inputs),
    its data feeds, the fetch list (the outputs, then the gradients of
    sum(first output * cot) for wrt). Returns (main, startup, params
    {name: array}, feed, fetch names)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.fluid.layer_helper import LayerHelper
    main, startup = _program_pair()
    params, feed = {}, {}
    wrt = spec.get('wrt', [])
    with unique_name.guard(), fluid.program_guard(main, startup):
        ins = {}
        for slot, a in spec['ins'].items():
            if slot in wrt or slot in spec.get('params', ()):
                v = LayerHelper('rule_input').create_parameter(
                    attr=fluid.ParamAttr(name='p_' + slot.lower()),
                    shape=list(a.shape), dtype=str(a.dtype))
                params[v.name] = a
            else:
                v = fluid.layers.data(name='in_' + slot.lower(),
                                      shape=list(a.shape), dtype=str(a.dtype),
                                      append_batch_size=False)
                feed[v.name] = a
            ins[slot] = v
        if spec.get('layer'):
            gen = fluid.layers.generate_layer_fn(spec['op'])
            outs = {'Out': gen(*[ins[s] for s in ('X', 'Y') if s in ins],
                               **spec.get('attrs', {}))}
        else:
            helper = LayerHelper(spec['op'])
            outs = {}
            for slot in spec.get('outs', ['Out']):
                if slot in spec.get('inplace', {}):
                    outs[slot] = ins[spec['inplace'][slot]]
                else:
                    outs[slot] = helper.create_variable_for_type_inference(
                        'float32')
            helper.append_op(type=spec['op'],
                             inputs={s: [v] for s, v in ins.items()},
                             outputs={s: [v] for s, v in outs.items()},
                             attrs=spec.get('attrs', {}))
        fetch = [outs[s].name for s in (spec.get('outs') or ['Out'])]
        if wrt:
            first = outs[(spec.get('outs') or ['Out'])[0]]
            cot = fluid.layers.data(name='cot', shape=list(first.shape),
                                    dtype='float32', append_batch_size=False)
            feed['cot'] = np.asarray(rng.randn(*first.shape), 'float32')
            total = fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(first, cot))
            fetch += [g.name for _, g in fluid.backward.append_backward(
                total)]
    return main, startup, params, feed, fetch


def _extra_run(main, startup, params, feed, fetch, place, runs):
    """`runs` steps of the program on `place` from `params`; returns (the
    executor, its scope, each step's fetches)."""
    from paddle_tpu_torch import fluid
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    scope.load_numpy(params, place)
    return exe, scope, [exe.run(main, feed=feed, fetch_list=fetch,
                                scope=scope) for _ in range(runs)]


def _chi_square(counts, p):
    """The chi-square of counts against the law p over p's live entries,
    its 1e-6 upper quantile, and whether a dead entry was drawn."""
    from scipy.stats import chi2
    live = p > 0
    e = counts.sum() * p[live]
    return (float(((counts[live] - e) ** 2 / e).sum()),
            float(chi2.ppf(1 - 1e-6, live.sum() - 1)),
            bool(counts[~live].any()))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float('inf')
    if not np.issubdtype(b.dtype, np.floating):
        return 0.0 if np.array_equal(a, b) else float('inf')
    return float(np.abs(a.astype('float64') - b).max()) / max(
        1.0, float(np.abs(b).max())) if b.size else 0.0


def _extra_rules(rec):
    """(c) The 27 rules, each captured alone through Executor() against the
    same program on the CPU."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.ops_impl import sampled_ops
    rng = np.random.RandomState(SEED + 7)
    rows = []
    for spec in _extra_cases(rng):
        op = spec['op']
        main, startup, params, feed, fetch = _extra_program(spec, rng)
        runs = EXTRA_UPDATES if spec.get('inplace') else 3
        exe, scope, card = _extra_run(main, startup, params, feed, fetch,
                                      fluid.CUDAPlace(0), runs)
        stats = dict(exe.cache_stats)
        if stats['captures'] != 1 or stats['replays'] != runs - 1:
            raise AssertionError('%s: %r after %d runs' % (op, stats, runs))
        n_out = len(spec.get('outs') or ['Out'])
        row = dict(op=op, layer=bool(spec.get('layer')),
                   shape=list(np.asarray(card[-1][0]).shape))
        if 'law' in spec:
            a, b = np.asarray(card[1][0]), np.asarray(card[2][0])
            if np.array_equal(a, b):
                raise AssertionError('sampling_id: two replays drew the '
                                     'same ids')
            stats_rows = []
            for i, p in enumerate(spec['law']):
                got = b[i * EXTRA_DRAWS:(i + 1) * EXTRA_DRAWS]
                stat, bound, dead = _chi_square(
                    np.bincount(got, minlength=p.size), p)
                stats_rows.append(stat)
                if dead or not stat < bound:
                    raise AssertionError(
                        'sampling_id row %d on the card: chi-square %.3g '
                        '(bound %.3g), a zero entry drawn %r'
                        % (i, stat, bound, dead))
            row.update(chi_square=stats_rows, chi_square_bound=bound)
        else:
            if op == 'nce':
                neg = torch.from_numpy(np.asarray(card[-1][2])[0, 1:].copy())
                real = sampled_ops.nce_negatives
                sampled_ops.nce_negatives = \
                    lambda n, k, device, generator: neg.to(device)
            try:
                cpu = _extra_run(main, startup, params, feed, fetch,
                                 fluid.CPUPlace(), runs)[2]
            finally:
                if op == 'nce':
                    sampled_ops.nce_negatives = real
            out_err = max(_rel(card[j][i], cpu[j][i]) for j in range(runs)
                          if spec.get('inplace') or j == runs - 1
                          for i in range(n_out))
            vjp_err = max([_rel(card[-1][i], cpu[-1][i])
                           for i in range(n_out, len(fetch))] or [0.0])
            row.update(out_err=out_err, vjp_err=vjp_err)
            if not (out_err <= EXTRA_TOL and vjp_err <= EXTRA_TOL):
                raise AssertionError('%s on the card against the CPU: '
                                     'outputs %.3g, VJP %.3g (tol %g)'
                                     % (op, out_err, vjp_err, EXTRA_TOL))
        busy, _, _, records = _device_busy(
            lambda: exe.run(main, feed=feed, fetch_list=fetch,
                            scope=scope), 3)
        row.update(device_ms=busy, kernels_per_replay=records)
        rows.append(row)
        del exe, scope
    rec['rules'] = rows
    log('[surface] the 27 rules, each captured alone, card against CPU '
        '(outputs and VJP, |diff| over max(1, |cpu|), tol %g; device ms and '
        'device records a replay, fetch copies included): %s'
        % (EXTRA_TOL, '; '.join(
            '%s %s %.4f ms %.0f' % (
                r['op'], ('chi2 %s' % ','.join('%.1f' % s for s in
                                                r['chi_square']))
                if 'chi_square' in r else '%.2g/%.2g' % (
                    r['out_err'], r['vjp_err']),
                r['device_ms'], r['kernels_per_replay']) for r in rows)))


def _initializers(rec):
    """(d) TruncatedNormal, MSRA (uniform and normal), Bilinear and
    NumpyArrayInitializer in one startup program on the card against the
    CPU; a depthwise conv2d_transpose at stride 2 with the Bilinear
    filter."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.fluid.layer_helper import LayerHelper
    rng = np.random.RandomState(SEED + 8)
    values = np.asarray(rng.randn(64, 48), 'float32')
    main, startup = _program_pair()
    init = fluid.initializer
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[16, 19, 19], dtype='float32')
        up = fluid.layers.conv2d_transpose(
            x, num_filters=16, filter_size=4, stride=2, padding=1, groups=16,
            param_attr=fluid.ParamAttr(name='bilinear_w',
                                       initializer=init.Bilinear()),
            bias_attr=False)
        helper = LayerHelper('init')
        for name, shape, ini in (
                ('tn_w', [1024, 1024], init.TruncatedNormal(scale=2.0)),
                ('msra_u', [512, 256, 3, 3], init.MSRA()),
                ('msra_n', [512, 256, 3, 3], init.MSRA(uniform=False)),
                ('np_w', [64, 48], init.NumpyArrayInitializer(values))):
            helper.create_parameter(attr=fluid.ParamAttr(
                name=name, initializer=ini), shape=shape, dtype='float32')
    feed = {'x': np.asarray(rng.randn(8, 16, 19, 19), 'float32')}
    got = {}
    for where, place in (('card', fluid.CUDAPlace(0)),
                         ('cpu', fluid.CPUPlace())):
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        outs = [exe.run(main, feed=feed, fetch_list=[up], scope=scope)[0]
                for _ in range(3 if where == 'card' else 1)]
        got[where] = (scope.to_numpy(['bilinear_w', 'np_w', 'tn_w',
                                      'msra_u', 'msra_n']), outs[-1])
    card, cpu = got['card'][0], got['cpu'][0]
    exact = {n: bool(np.array_equal(card[n], cpu[n]))
             for n in ('bilinear_w', 'np_w')}
    tn = card['tn_w'].astype('float64')
    fan_in = 256 * 9
    limit = float(np.sqrt(6.0 / fan_in))
    r = dict(bitwise=exact, tn_max_abs=float(np.abs(tn).max()),
             tn_std=float(tn.std()), tn_std_want=0.8796 * 2.0,
             msra_u_max_abs=float(np.abs(card['msra_u']).max()),
             msra_u_limit=limit,
             msra_n_std=float(card['msra_n'].astype('float64').std()),
             msra_n_std_want=float(np.sqrt(2.0 / fan_in)),
             upsample_err=_rel(got['card'][1], got['cpu'][1]))
    checks = {
        'Bilinear and NumpyArrayInitializer bitwise': all(exact.values()),
        'TruncatedNormal inside 2 std': r['tn_max_abs'] <= 4.0,
        'TruncatedNormal std': abs(r['tn_std'] / r['tn_std_want'] - 1)
        <= INIT_STD_TOL,
        'MSRA uniform limit': r['msra_u_max_abs'] <= limit and
        abs(r['msra_u_max_abs'] / limit - 1) <= INIT_STD_TOL,
        'MSRA normal std': abs(r['msra_n_std'] / r['msra_n_std_want'] - 1)
        <= INIT_STD_TOL,
        'bilinear upsample': r['upsample_err'] <= RESIZE_TOL}
    rec['initializers'] = r
    log('[surface] initializers on the card: %s; TruncatedNormal(2) max '
        '|w| %.4f, std %.5f (the truncated law\'s %.5f); MSRA uniform max '
        '|w| %.6f (limit %.6f), normal std %.6f (want %.6f); the Bilinear '
        'depthwise conv2d_transpose 19 -> 38, card against CPU %.3g'
        % (exact, r['tn_max_abs'], r['tn_std'], r['tn_std_want'],
           r['msra_u_max_abs'], limit, r['msra_n_std'],
           r['msra_n_std_want'], r['upsample_err']))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError('initializers on the card: %s failed (%r)'
                             % (bad, r))


def _resize_width_1(rec):
    """(e) bilinear_interp at output dims of 1 (and the sizes around them),
    forward and VJP on the card under the sync check against the CPU."""
    rng = np.random.RandomState(SEED + 9)
    rows = []
    for h, w, oh, ow in RESIZE_CASES:
        ins = {'X': [np.asarray(rng.randn(4, 8, h, w), 'float32')]}
        attrs = {'out_h': oh, 'out_w': ow}
        cot = np.asarray(rng.randn(4, 8, oh, ow), 'float32')
        cpu, cpu_g, _ = _vision_rule('bilinear_interp', ins, attrs, 'Out',
                                     ['X'], 'cpu', cot)
        card, card_g, _ = _vision_rule('bilinear_interp', ins, attrs, 'Out',
                                       ['X'], 'cuda', cot)
        err, gerr = _rel(card, cpu), _rel(card_g[0], cpu_g[0])
        rows.append(dict(size=[h, w, oh, ow], out_err=err, vjp_err=gerr))
        if not (err <= RESIZE_TOL and gerr <= RESIZE_TOL):
            raise AssertionError('bilinear_interp %dx%d -> %dx%d on the '
                                 'card: %.3g / %.3g (tol %g)'
                                 % (h, w, oh, ow, err, gerr, RESIZE_TOL))
    rec['resize'] = rows
    log('[surface] bilinear_interp, card against CPU (forward / VJP): %s'
        % '; '.join('%dx%d->%dx%d %.2g/%.2g' % (tuple(r['size']) + (
            r['out_err'], r['vjp_err'])) for r in rows))


def phase_training_surface():
    """Phase 7m: (a) word2vec with the NCE head and (b) with the
    hsigmoid head trained captured; (c) the 27 rules alone; (d) the
    initializers; (e) the width-1 bilinear resize. Returns {path: launch
    counts} of w2v_nce_training and w2v_hsigmoid_training (no kernel of
    the port runs on them)."""
    import torch
    t0 = time.perf_counter()
    rec = {}
    counts = {'w2v_nce_training': _w2v_train('nce', rec),
              'w2v_hsigmoid_training': _w2v_train('hsigmoid', rec)}
    _extra_rules(rec)
    _initializers(rec)
    _resize_width_1(rec)
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log(json.dumps({'training_surface': rec}))
    log('[surface] phase 7m took %.1f s' % rec['seconds'])
    return counts


# -- phase 7n: the recordio half of the data path ---------------------------

def _recordio_shards(tmp, rec):
    """RIO_SAMPLES raw flowers samples written by write_samples into
    RIO_SHARDS shards; every record read back by the native prefetch
    scanner and by RecordIOReader held bitwise to the sample written
    (sha256 of its arrays), and the scanners' MB/s over the shards, the
    page cache warm (the shards were just written). Returns the shard
    paths."""
    from paddle_tpu_torch.dataset import flowers
    from paddle_tpu_torch.reader import recordio
    from paddle_tpu_torch.utils import native

    def digest(arrays):
        h = hashlib.sha256()
        for a in arrays:
            a = np.ascontiguousarray(a)
            h.update(a.dtype.str.encode() + repr(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    t0 = time.perf_counter()
    native.load()
    rec['native_build_s'] = time.perf_counter() - t0
    rec['native_library'] = os.path.relpath(
        native.LIBRARY.library_path(), os.path.dirname(native._PKG_DIR))
    samples = list(flowers._raw_reader('train', RIO_SAMPLES)())
    written = [digest([np.asarray(x) for x in s]) for s in samples]
    per = RIO_SAMPLES // RIO_SHARDS
    paths = [os.path.join(tmp, 'flowers-%05d.ptrio' % i)
             for i in range(RIO_SHARDS)]
    t0 = time.perf_counter()
    for i, p in enumerate(paths):
        recordio.write_samples(p, iter(samples[i * per:(i + 1) * per]))
    rec['write_s'] = time.perf_counter() - t0
    del samples
    nbytes = sum(os.path.getsize(p) for p in paths)
    rec['shard_bytes'] = nbytes
    for name, scan in (('prefetch', lambda p: native.recordio_prefetch_iter(
            p, 4)), ('scanner', native.recordio_iter),
            ('python', recordio.RecordIOReader)):
        t0 = time.perf_counter()
        n = sum(1 for p in paths for _ in scan(p))
        secs = time.perf_counter() - t0
        rec['scan_mb_s_' + name] = nbytes / secs / 1e6
        if n != RIO_SAMPLES:
            raise AssertionError('%s scanned %d records, %d written'
                                 % (name, n, RIO_SAMPLES))
    for name, scan in (('prefetch', lambda p: native.recordio_prefetch_iter(
            p, 4)), ('python', recordio.RecordIOReader)):
        got = [digest(recordio._unpack_sample(payload))
               for p in paths for payload in scan(p)]
        if got != written:
            bad = [i for i, (g, w) in enumerate(zip(got, written)) if g != w]
            raise AssertionError('the %s reader gave %d records, %d not the '
                                 'sample written (first %r)'
                                 % (name, len(got), len(bad), bad[:5]))
    log('[recordio] wrote %d raw flowers samples (256x320x3 uint8 and a '
        'label) into %d shards, %.1f MB, in %.2f s; every record read back '
        'bitwise by the native prefetch scanner and by RecordIOReader; '
        'scanner MB/s over the shards, page cache warm (just written): '
        'prefetch %.0f, plain scanner %.0f, python RecordIOReader %.0f; '
        'native library built or found in %.2f s (%s); card: %s'
        % (RIO_SAMPLES, RIO_SHARDS, nbytes / 1e6, rec['write_s'],
           rec['scan_mb_s_prefetch'], rec['scan_mb_s_scanner'],
           rec['scan_mb_s_python'], rec['native_build_s'],
           rec['native_library'], nvidia_smi_line()))
    return paths


def _flowers_chain(paths, place=None):
    """open_files -> shuffle(RIO_SHUFFLE) -> batch(RESNET_BATCH) -> the
    batched transform (seed: the batch index) -> double_buffer(place): a
    reader of (images [32, 3, 224, 224] float32, labels [32, 1] int64),
    staged into pinned memory on the prefetch thread. Its data vars live
    in a program of their own."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dataset import image
    main, startup = _program_pair()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        layers = fluid.layers
        r = layers.open_files(paths, shapes=[[-1, 256, 320, 3], [-1, 1]],
                              lod_levels=[0, 0], dtypes=['uint8', 'int64'])
        r = layers.batch(layers.shuffle(r, buffer_size=RIO_SHUFFLE),
                         RESNET_BATCH)
        batches = r._gen

        def transformed():
            for i, b in enumerate(batches()):
                imgs = np.stack([s[0] for s in b])
                labels = np.stack([s[1] for s in b]).reshape(-1, 1)
                yield image.simple_transform_batch(
                    imgs, 256, 224, True, mean=RIO_MEAN, seed=i), labels

        r._gen = transformed
        return layers.double_buffer(r, place=place)


def _plain_flowers_batches(paths, n):
    """The chain's first n batches built the plain way from the same
    shards: RecordIOReader, the reader decorators' shuffle under the same
    random.seed, the plain numpy transform."""
    import random
    from paddle_tpu_torch import reader as reader_mod
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.dataset import image
    from paddle_tpu_torch.reader import recordio

    def samples():
        for p in paths:
            for payload in recordio.RecordIOReader(p):
                yield recordio._unpack_sample(payload)

    random.seed(SEED)
    out = []
    for i, b in enumerate(batch(reader_mod.shuffle(samples, RIO_SHUFFLE),
                                RESNET_BATCH)()):
        if i == n:
            break
        out.append((image._transform_batch_plain(
            np.stack([s[0] for s in b]), 256, 224, True, mean=RIO_MEAN,
            seed=i), np.stack([s[1] for s in b]).reshape(-1, 1)))
    return out


def _chain_training(what, paths, exe, main, scope, avg_cost, to_feed,
                    plain, rec):
    """RIO_STEPS steps of a captured step fed by the chain, then
    RIO_MEMORY_STEPS of the same step fed one batch already on the card.
    Holds: the first two batches Executor.run receives bitwise the plain
    path's; finite losses; one capture. Records images/s of both feeds
    over the replayed steps, and the input wait a step."""
    import random
    import torch
    import gc
    r = _flowers_chain(paths, place=exe.place)
    random.seed(SEED)
    it = r()
    losses, waits, steps, seen = [], [], [], []
    pauses, started = [], []

    def gc_clock(phase, info):
        if phase == 'start':
            started.append(time.perf_counter())
        elif started:
            pauses.append((info['generation'],
                           time.perf_counter() - started.pop()))

    host0 = torch.cuda.host_memory_stats()
    gc.callbacks.append(gc_clock)
    _reset_launch_counts()
    feed_s, allocs = [], []

    def alloc_counts():
        return (torch.cuda.memory_stats().get('num_device_alloc', 0),
                torch.cuda.host_memory_stats().get('num_host_alloc', 0))

    for i in range(RIO_STEPS):
        a0 = alloc_counts()
        t0 = time.perf_counter()
        imgs, labels = next(it)
        t1 = time.perf_counter()
        if i < len(plain):
            seen.append((np.array(imgs), np.array(labels)))
        feed = to_feed(imgs, labels)
        t2 = time.perf_counter()
        loss, = exe.run(main, feed=feed, fetch_list=[avg_cost], scope=scope)
        t3 = time.perf_counter()
        a1 = alloc_counts()
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        waits.append(t1 - t0)
        feed_s.append(t2 - t1 if i >= len(plain) else None)
        steps.append(t3 - t0)
        allocs.append((a1[0] - a0[0], a1[1] - a0[1]))
    gc.callbacks.remove(gc_clock)
    host1 = torch.cuda.host_memory_stats()
    it.close()
    launches = _launch_counts()
    for j, ((gi, gl), (wi, wl)) in enumerate(zip(seen, plain)):
        if gi.tobytes() != wi.tobytes() or gl.tobytes() != wl.tobytes():
            raise AssertionError(
                '%s: batch %d from the chain is not the plain path\'s '
                '(max |diff| %r)' % (what, j, float(np.abs(
                    gi.astype(np.float64) - wi).max())))
    if not np.isfinite(losses).all():
        raise AssertionError('%s: non-finite loss %r' % (what, losses))
    if exe.cache_stats['captures'] != 1:
        raise AssertionError('%s: %r' % (what, exe.cache_stats))
    on_card = to_feed(torch.from_numpy(seen[0][0]).to(exe.device),
                      torch.from_numpy(seen[0][1]).to(exe.device))
    mem = []
    for _ in range(RIO_MEMORY_STEPS):
        t0 = time.perf_counter()
        exe.run(main, feed=on_card, fetch_list=[avg_cost], scope=scope)
        mem.append(time.perf_counter() - t0)
    replayed, settled = steps[2:], steps[RIO_SETTLED:]
    out = dict(
        losses=losses,
        images_s_chain=RESNET_BATCH * len(replayed) / sum(replayed),
        images_s_chain_settled=RESNET_BATCH * len(settled) / sum(settled),
        images_s_memory=RESNET_BATCH * len(mem[1:]) / sum(mem[1:]),
        step_ms_chain_median=1e3 * float(np.median(replayed)),
        step_ms_memory_median=1e3 * float(np.median(mem[1:])),
        wait_ms_median=1e3 * float(np.median(waits[2:])),
        wait_ms_p90=1e3 * float(np.percentile(waits[2:], 90)),
        wait_ms_first=1e3 * waits[0],
        step_ms=[round(1e3 * x, 3) for x in steps],
        wait_ms=[round(1e3 * x, 3) for x in waits],
        feed_ms=[None if x is None else round(1e3 * x, 3) for x in feed_s],
        device_host_allocs=allocs,
        gc_pauses_ms={g: round(1e3 * sum(t for gg, t in pauses if gg == g), 3)
                      for g in sorted({g for g, _ in pauses})},
        gc_collections=len(pauses),
        pinned_allocs=host1.get('num_host_alloc', 0)
        - host0.get('num_host_alloc', 0),
        captures=exe.cache_stats['captures'])
    out['chain_over_memory'] = out['images_s_chain'] / out['images_s_memory']
    out['settled_over_memory'] = (out['images_s_chain_settled']
                                  / out['images_s_memory'])
    rec[what] = out
    log('[recordio] %s: %d steps fed by the chain, losses %s' % (
        what, RIO_STEPS, ', '.join('%.4f' % x for x in losses)))
    log('[recordio] %s: %.1f images/s from the chain (steps 3-%d, median '
        'step %.2f ms; %.1f over steps %d-%d, %.3f of the memory-fed rate) '
        'against %.1f fed a batch already on the card '
        '(median %.2f ms), %.3f of it; input wait a step median %.3f ms, '
        'p90 %.3f ms (the first %.1f ms); the first %d batches bitwise '
        'the plain path\'s; in the chain\'s steps %d garbage collections '
        '(ms by generation %s) and %d pinned host allocations; card: %s'
        % (what, out['images_s_chain'], RIO_STEPS,
           out['step_ms_chain_median'], out['images_s_chain_settled'],
           RIO_SETTLED + 1, RIO_STEPS, out['settled_over_memory'],
           out['images_s_memory'],
           out['step_ms_memory_median'], out['chain_over_memory'],
           out['wait_ms_median'], out['wait_ms_p90'], out['wait_ms_first'],
           len(plain), out['gc_collections'], out['gc_pauses_ms'],
           out['pinned_allocs'], nvidia_smi_line()))
    log('[recordio] %s: step ms %s; input wait ms %s; to_feed ms (after '
        'the checked batches) %s; (device, pinned host) allocations a step '
        '%s' % (what, out['step_ms'], out['wait_ms'], out['feed_ms'],
                 allocs))
    return launches


def _recordio_resnet(paths, rec):
    """(a) ResNet-50 (flowers, 102 classes, Momentum 0.01/0.9) fp32 NCHW,
    then the AMP NHWC tower of phase 7b with the batch cast to bf16 on
    the card at the feed, each fed by the chain. Returns the launch
    counts."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.dataset import image
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.reader import recordio
    plain = _plain_flowers_batches(paths, 2)
    # the transform alone at batch 32, native against plain
    raw = np.stack([s[0] for _, s in zip(range(RESNET_BATCH),
                                         recordio.read_samples(paths[0]))])
    for name, fn in (('native', image.simple_transform_batch),
                     ('plain', image._transform_batch_plain)):
        fn(raw, 256, 224, True, mean=RIO_MEAN, seed=0)
        t0 = time.perf_counter()
        for k in range(RIO_TRANSFORM_REPS):
            fn(raw, 256, 224, True, mean=RIO_MEAN, seed=k)
        secs = (time.perf_counter() - t0) / RIO_TRANSFORM_REPS
        rec['transform_images_s_' + name] = RESNET_BATCH / secs
    rec['cpu_count'] = os.cpu_count()
    log('[recordio] simple_transform_batch at batch %d (256x320 -> crop '
        '224, flip, mean): native %.0f images/s, plain numpy %.0f, with '
        'os.cpu_count() %d; card: %s'
        % (RESNET_BATCH, rec['transform_images_s_native'],
           rec['transform_images_s_plain'], rec['cpu_count'],
           nvidia_smi_line()))
    counts = {}
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost = resnet.get_model(data_set='flowers', depth=50,
                                    batch_size=RESNET_BATCH)[0]
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    launches = _chain_training(
        'resnet50_fp32_nchw', paths, exe, main, scope, avg_cost,
        lambda x, y: {'data': x, 'label': y}, plain, rec)
    counts = {n: counts.get(n, 0) + v for n, v in launches.items()}
    del exe, scope
    main, startup, avg_cost = build_resnet_amp('NHWC')
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)

    def bf16_nhwc(x, y):
        x = torch.as_tensor(x).to(exe.device, non_blocking=True)
        x = x.permute(0, 2, 3, 1)
        return {'data': x.to(torch.bfloat16).contiguous(), 'label': y}

    launches = _chain_training('resnet50_amp_nhwc', paths, exe, main, scope,
                               avg_cost, bf16_nhwc, plain, rec)
    counts = {n: counts.get(n, 0) + v for n, v in launches.items()}
    del exe, scope
    return counts


def _recordio_sentiment(tmp, rec):
    """(b) RIO_LOD_BATCHES batches of imdb for understand_sentiment
    (phase 7d's config) written by convert_reader_to_recordio_files, read
    back by open_recordio_file -> double_buffer(CUDAPlace) and trained
    captured; the losses bitwise those of a second executor from the same
    startup seed fed the same batches through DataFeeder. Returns the
    launch counts."""
    import random
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import recordio_writer
    random.seed(SEED)
    main, startup, avg_cost, reader, names = build_sentiment()[:5]
    feeder = fluid.DataFeeder(names, fluid.CUDAPlace(0), program=main)
    batches = list(itertools.islice(reader(), RIO_LOD_BATCHES))
    stem = os.path.join(tmp, 'imdb.rec')
    n = recordio_writer.convert_reader_to_recordio_files(
        stem, RIO_LOD_BATCHES, lambda: iter(batches), feeder)
    if n != RIO_LOD_BATCHES:
        raise AssertionError('wrote %d imdb records' % n)
    blk = main.global_block()
    vars_ = [blk.var(nm) for nm in names]
    r_main, r_startup = _program_pair()
    with fluid.unique_name.guard(), fluid.program_guard(r_main, r_startup):
        r = fluid.layers.open_recordio_file(
            os.path.join(tmp, 'imdb-00000.rec'), shapes=[[-1, 1], [-1, 1]],
            lod_levels=[v.lod_level or 0 for v in vars_],
            dtypes=[v.dtype for v in vars_])
        r = fluid.layers.double_buffer(r, place=fluid.CUDAPlace(0))
    runs = {}
    _reset_launch_counts()
    for how in ('chain', 'feeder'):
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(startup, scope=scope)
        runs[how + '_initial'] = scope.to_numpy()
        feeds = ([dict(zip(names, slots)) for slots in r()]
                 if how == 'chain' else [feeder.feed(b) for b in batches])
        runs[how] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[avg_cost], scope=scope)[0])
            .reshape(-1)[0]) for f in feeds]
        runs[how + '_captures'] = exe.cache_stats['captures']
        del exe, scope
    launches = _launch_counts()
    init_a, init_b = runs['chain_initial'], runs['feeder_initial']
    if any(init_a[k].tobytes() != init_b[k].tobytes() for k in init_a):
        raise AssertionError('the two startups from one seed differ')
    rec['sentiment'] = dict(losses=runs['chain'],
                            captures=runs['chain_captures'])
    log('[recordio] understand_sentiment from fluid.recordio_writer (%d '
        'batches of %d, LoD words): losses %s; %d captures'
        % (RIO_LOD_BATCHES, len(batches[0]),
           ', '.join('%.6f' % x for x in runs['chain']),
           runs['chain_captures']))
    if not (len(runs['chain']) == RIO_LOD_BATCHES
            and np.isfinite(runs['chain']).all()
            and np.array_equal(runs['chain'], runs['feeder'])):
        raise AssertionError('sentiment from recordio: losses %r, through '
                             'DataFeeder %r' % (runs['chain'],
                                                runs['feeder']))
    return launches


def _preprocessed_on(place, raw):
    """The (c) block over `raw` (a list of (images, labels)) through a
    Preprocessor on `place`; returns (its outputs, seconds a batch)."""
    from paddle_tpu_torch import fluid
    main, startup = _program_pair()
    scope = fluid.Scope()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup), \
            fluid.scope_guard(scope):
        layers = fluid.layers
        reader = layers.py_reader(capacity=2,
                                  shapes=[[-1, 256, 320, 3], [-1, 1]],
                                  dtypes=['uint8', 'int64'], name='raw')
        reader.decorate_paddle_reader(lambda: iter(raw))
        p = layers.Preprocessor(reader, place=place)
        with p.block():
            img, label = p.inputs()
            x = layers.scale(layers.cast(img, 'float32'), scale=1.0 / 255.0)
            mean = layers.create_parameter(
                shape=[3], dtype='float32', name='rio_mean',
                default_initializer=fluid.initializer.NumpyArrayInitializer(
                    np.asarray(RIO_MEAN, 'float32') / 255.0))
            x = layers.transpose(layers.elementwise_sub(x, mean, axis=-1),
                                 perm=[0, 3, 1, 2])
            p.outputs(x, label)
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        t0 = time.perf_counter()
        out = list(reader())
        return out, (time.perf_counter() - t0) / len(raw)


def _recordio_preprocessor(paths, rec):
    """(c) a cast of the uint8 images to float32, scale, the
    elementwise_sub of a mean parameter and transpose over (a)'s raw
    batches through a Preprocessor on the card against the same block on
    the CPU."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.reader import recordio
    it = recordio.read_samples(paths[1])
    raw = []
    for _ in range(RIO_PREP_BATCHES):
        b = [next(it) for _ in range(RESNET_BATCH)]
        raw.append((np.stack([s[0] for s in b]),
                    np.stack([s[1] for s in b]).reshape(-1, 1)))
    it.close()
    card, card_s = _preprocessed_on(fluid.CUDAPlace(0), raw)
    cpu, cpu_s = _preprocessed_on(fluid.CPUPlace(), raw)
    err = max(float(np.abs(c[0].astype(np.float64) - h[0]).max())
              for c, h in zip(card, cpu))
    same_labels = all(c[1].tobytes() == h[1].tobytes()
                      for c, h in zip(card, cpu))
    rec['preprocessor'] = dict(max_abs_err=err, card_ms=1e3 * card_s,
                               cpu_ms=1e3 * cpu_s,
                               shape=list(card[0][0].shape),
                               dtype=str(card[0][0].dtype))
    log('[recordio] Preprocessor (cast to float32, scale, elementwise_sub '
        'of a mean parameter, transpose) over %d raw batches of %d: '
        'out %s %s, card against CPU max |diff| %.3g (tol %g); %.1f ms a '
        'batch on the card, %.1f on the CPU (host clock, the host copy '
        'of the outputs included); card: %s'
        % (RIO_PREP_BATCHES, RESNET_BATCH, card[0][0].shape,
           card[0][0].dtype, err, RIO_PREP_TOL, 1e3 * card_s, 1e3 * cpu_s,
           nvidia_smi_line()))
    if not (err <= RIO_PREP_TOL and same_labels
            and card[0][0].shape == (RESNET_BATCH, 3, 256, 320)):
        raise AssertionError('Preprocessor on the card: max |diff| %r, '
                             'labels equal %r' % (err, same_labels))


def phase_recordio():
    """Phase 7n: (a) ResNet-50 trained from recordio shards through the
    reader layers and the native transform, fp32 and AMP; (b)
    understand_sentiment from fluid.recordio_writer's LoD records; (c) a
    Preprocessor block on the card against the CPU. Returns {path: launch
    counts} of recordio_resnet and recordio_sentiment (no kernel of the
    port runs on them)."""
    import torch
    t0 = time.perf_counter()
    rec = {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_recordio_') as tmp:
        paths = _recordio_shards(tmp, rec)
        counts = {'recordio_resnet': _recordio_resnet(paths, rec),
                  'recordio_sentiment': _recordio_sentiment(tmp, rec)}
        _recordio_preprocessor(paths, rec)
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log(json.dumps({'recordio': rec}))
    log('[recordio] phase 7n took %.1f s; card: %s'
        % (rec['seconds'], rec['card']))
    return counts


# -- phase 7o: data and expert parallelism -----------------------------------

def _nccl_kernels(counts):
    """{name: count} of the NCCL kernels among a trace's device kernels (a
    one-rank NCCL launches its oneRankReduce for an average)."""
    return {n: c for n, c in counts.items()
            if 'nccl' in n.lower() or 'onerank' in n.lower()}


def _parallel_feeds(names):
    """PARALLEL_STEPS wmt16 batches of TRAIN_BATCH at full length, each
    target's first (pad) id replaced by a live one (_grad_check_feed)."""
    from paddle_tpu_torch.dataset import wmt16
    from paddle_tpu_torch.models.transformer import pad_batch
    cfg = TRANSFORMER_BASE
    rows = list(itertools.islice(wmt16.train(cfg['src_vocab_size'],
                                             cfg['trg_vocab_size'])(),
                                 TRAIN_BATCH * PARALLEL_STEPS))
    feeds = []
    for s in range(PARALLEL_STEPS):
        feed = as_feed(pad_batch(rows[s * TRAIN_BATCH:(s + 1) * TRAIN_BATCH],
                                 cfg['max_length']), names)
        feed['trg_word'][:, 0] = 2
        feeds.append(feed)
    return feeds


def _parallel_way(way, built, initial, feeds, profile):
    """PARALLEL_STEPS captured steps of the dropout-free Transformer-base
    from `initial` one way: 'plain' (Executor), 'parallel_executor'
    (ParallelExecutor(use_cuda=True)), 'set_mesh' (set_mesh({'dp': 1}) and
    the Executor), 'reduce' (ParallelExecutor with BuildStrategy.Reduce:
    ZeRO-3) or 'transpiler' (DistributeTranspiler(shard_parameters=True)).
    Returns (losses, {persistable: numpy after the last step}, host seconds
    per step, kernel launches, device kernel counts of one more replay or
    None)."""
    import gc
    import torch
    from paddle_tpu_torch import fluid, parallel
    t_way = time.perf_counter()
    main, avg_cost = built[0].clone(), built[1]
    scope = fluid.Scope()
    scope.load_numpy(initial, fluid.CUDAPlace(0))
    exe = fluid.Executor()
    if way in ('parallel_executor', 'reduce'):
        bs = fluid.BuildStrategy()
        if way == 'reduce':
            bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        pe = fluid.ParallelExecutor(use_cuda=True, loss_name=avg_cost.name,
                                    main_program=main, scope=scope,
                                    build_strategy=bs)

        def step(feed):
            return pe.run([avg_cost.name], feed=feed)[0]
    else:
        if way == 'set_mesh':
            main.set_mesh({'dp': 1})
        elif way == 'transpiler':
            cfg = fluid.DistributeTranspilerConfig()
            cfg.shard_parameters = True
            fluid.DistributeTranspiler(cfg).transpile(
                trainer_id=0, trainers=1, program=main)

        def step(feed):
            return exe.run(main, feed=feed, fetch_list=[avg_cost],
                           scope=scope)[0]
    _reset_launch_counts()
    losses, secs = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        losses.append(float(np.asarray(step(feed)).reshape(())))
        secs.append(time.perf_counter() - t0)
    launches = _launch_counts()
    state = {n: v.detach().cpu().numpy()
             for n, v in parallel.full_state(main, scope).items()} \
        if way != 'plain' else scope.to_numpy(
            [v.name for v in main.list_vars()
             if v.persistable and v.name in scope.vars])
    kernels = device_kernel_counts(lambda: step(feeds[-1])) \
        if profile else None
    log('[parallel] %s: %.1f s' % (way, time.perf_counter() - t_way))
    del step, exe, scope
    if way in ('parallel_executor', 'reduce'):
        del pe
    gc.collect()
    torch.cuda.synchronize()
    return losses, state, secs, launches, kernels


def _parallel_transformer(rec):
    """(a)-(b): Transformer-base five ways from one startup state and one
    set of feeds, each held to the plain run. Returns the launch counts of
    the ParallelExecutor run (the slice's main path)."""
    from paddle_tpu_torch import fluid
    t0 = time.perf_counter()
    main, startup, avg_cost, names, _ = build_trainer(dropout=False)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    initial = scope.to_numpy()
    del scope
    feeds = _parallel_feeds(names)
    log('[parallel] Transformer-base built and initialized: %.1f s'
        % (time.perf_counter() - t0))
    runs = {}
    for way in ('plain', 'parallel_executor', 'set_mesh', 'reduce',
                'transpiler'):
        # each way runs its own clone (set_mesh and the transpiler
        # annotate the program they are given)
        runs[way] = _parallel_way(way, (main, avg_cost), initial, feeds,
                                  way == 'parallel_executor')
    plain_losses, plain_state = runs['plain'][0], runs['plain'][1]
    out = {}
    for way, (losses, state, secs, launches, kernels) in runs.items():
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, plain_losses))
        missing = sorted(set(plain_state) - set(state))
        errs = sorted((_rel_l2(state[n], plain_state[n]), n)
                      for n in plain_state if n in state)
        bitwise = all(np.array_equal(state[n], plain_state[n])
                      for n in plain_state if n in state) and \
            losses == plain_losses
        row = {'losses': losses, 'loss_rel_err': loss_err,
               'state_rel_l2_max': errs[-1][0], 'state_worst': errs[-1][1],
               'bitwise': bitwise,
               'median_replay_s': float(np.median(secs[2:])),
               'step_s': secs,
               'launches_per_step': {
                   n: c // PARALLEL_STEPS for n, c in launches.items() if c}}
        if kernels is not None:
            row['replay_kernels'] = sum(kernels.values())
            row['replay_nccl_kernels'] = _nccl_kernels(kernels)
            row['replay_flash_kernels'] = sum(
                c for n, c in kernels.items() if 'flash' in n.lower()
                or 'fwd_kernel' in n or 'bwd_' in n)
        out[way] = row
        log('[parallel] %s: losses %s; vs plain: loss %.3g, state rel L2 '
            'max %.3g (%s), bitwise %s; median replay %.4f s'
            % (way, ', '.join('%.5f' % x for x in losses), loss_err,
               errs[-1][0], errs[-1][1], bitwise, row['median_replay_s']))
        if missing or not (loss_err <= PARALLEL_TOL
                           and errs[-1][0] <= PARALLEL_TOL):
            raise AssertionError(
                'Transformer-base %s against the plain run: loss %.3g, state '
                '%.3g (%s) (tol %g), missing %r'
                % (way, loss_err, errs[-1][0], errs[-1][1], PARALLEL_TOL,
                   missing[:4]))
        if not np.isfinite(losses).all():
            raise AssertionError('%s: non-finite losses %r' % (way, losses))
    pe = out['parallel_executor']
    if not pe['replay_nccl_kernels']:
        raise AssertionError('the ParallelExecutor replay ran no NCCL kernel')
    launches = runs['parallel_executor'][3]
    want = ATTENTION_OPS_PER_FORWARD * PARALLEL_STEPS
    for name in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv'):
        if launches[name] != want:
            raise AssertionError(
                '%s launched %d times in %d ParallelExecutor steps, not %d'
                % (name, launches[name], PARALLEL_STEPS, want))
    pe['replay_vs_plain'] = pe['median_replay_s'] / \
        out['plain']['median_replay_s']
    rec['transformer'] = out
    return launches


def build_moe_encoder(capacity_factor=None, batch_major=True):
    """The MoE Transformer encoder of phase 7o in fresh programs: the
    encoder of Transformer-base (MOE_ENCODER: 6 layers, d_model 512, 8
    heads) with every position-wise FFN a moe_mlp (8 experts of hidden
    2048, top 2), predicting each next source token (the token-weighted
    cross entropy of models/transformer.py) plus MOE_AUX_WEIGHT times the
    layers' auxiliary losses; Adam. Returns (main, startup, avg_cost)."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import framework, layers, unique_name
    from paddle_tpu_torch.models import transformer as T
    c = MOE_ENCODER
    cf = c['capacity_factor'] if capacity_factor is None else capacity_factor
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), framework.program_guard(main, startup):
        src = layers.data(name='src_word', shape=[c['max_length']],
                          dtype='int64')
        lbl = layers.data(name='lbl_word', shape=[c['max_length']],
                          dtype='int64')
        key_bias = T._pad_mask_bias(src, 'src')
        x = T._embed(src, c['vocab'], c['d_model'], c['max_length'], 0.0,
                     'src')
        aux_sum = None
        for _ in range(c['n_layer']):
            attn = T.multi_head_attention(x, x, x, key_bias, c['d_model'],
                                          c['n_head'])
            x = T._pre_post_process(x, attn, 0.0, 'dan')
            f, aux = layers.moe_mlp(
                x, num_experts=c['num_experts'], hidden_size=c['hidden'],
                act='relu', capacity_factor=cf, top_k=c['top_k'],
                return_aux_loss=True)
            x = T._pre_post_process(x, f, 0.0, 'dan')
            aux_sum = aux if aux_sum is None else \
                layers.elementwise_add(aux_sum, aux)
        logits = layers.fc(input=x, size=c['vocab'], num_flatten_dims=2)
        logits2d = layers.reshape(logits, shape=[-1, c['vocab']])
        lbl2d = layers.reshape(lbl, shape=[-1, 1])
        cost = layers.softmax_with_cross_entropy(logits=logits2d,
                                                 label=lbl2d)
        weights = layers.reshape(layers.clip(layers.cast(
            lbl, 'float32'), 0.0, 1.0), shape=[-1, 1])
        tokens = layers.reduce_sum(weights)
        loss = layers.elementwise_div(
            layers.reduce_sum(layers.elementwise_mul(cost, weights)), tokens)
        avg_cost = layers.elementwise_add(
            loss, layers.scale(aux_sum, scale=MOE_AUX_WEIGHT))
        fluid.optimizer.Adam(learning_rate=MOE_LR).minimize(avg_cost)
    return main, startup, avg_cost


def _moe_feeds(rows, n):
    """n batches of `rows` wmt16 source sentences padded to max_length,
    labelled with each next token (0 past the sentence: no weight)."""
    from paddle_tpu_torch.dataset import wmt16
    c = MOE_ENCODER
    it = wmt16.train(c['vocab'], c['vocab'])()
    feeds = []
    for _ in range(n):
        src = np.zeros((rows, c['max_length']), 'int64')
        for i in range(rows):
            s = next(it)[0][:c['max_length']]
            src[i, :len(s)] = s
        lbl = np.zeros_like(src)
        lbl[:, :-1] = src[:, 1:]
        feeds.append({'src_word': src, 'lbl_word': lbl})
    return feeds


def _moe_first_step(main, avg_cost, state, feed, place, mesh, gnames):
    """Step 1 (eager: use_program_cache=False) from `state` on `place`,
    under set_mesh({'dp': 1}) when `mesh`; returns [loss] + gradients."""
    from paddle_tpu_torch import fluid
    main.set_mesh({'dp': 1} if mesh else None)
    s = fluid.Scope()
    s.load_numpy(state, place)
    out = fluid.Executor(place).run(main, feed=feed,
                                    fetch_list=[avg_cost] + gnames, scope=s,
                                    use_program_cache=False)
    main.set_mesh(None)
    return [np.asarray(v) for v in out]


def _moe_routed(fn, n_layer):
    """fn()'s result and each of the n_layer moe_mlp layers' routing in
    its first forward, in layer order: [(expert [k, nt], keep [k, nt],
    gate logits [nt, E], tokens [nt, d])] as numpy, from the pack_topk
    calls (the mesh
    path's and the dense path's). On the card the step runs its eager
    warm-up, the forward recorded here, and then its capture: the copies
    stay on the card until the step is done (a copy to the host inside
    the step would synchronize, which the warm-up refuses)."""
    from paddle_tpu_torch.fluid.ops_impl import moe_ops
    from paddle_tpu_torch.parallel import moe as tmoe
    real, routes = tmoe.pack_topk, []

    def recording(xs, logits, n_exp, cap, top_k=1):
        send, route = real(xs, logits, n_exp, cap, top_k)
        if len(routes) < n_layer:
            routes.append(tuple(t.detach().float().clone()
                                for t in (route[0], route[2], logits, xs)))
        return send, route

    tmoe.pack_topk = moe_ops.pack_topk = recording
    try:
        out = fn()
    finally:
        tmoe.pack_topk = moe_ops.pack_topk = real
    if len(routes) != n_layer:
        raise AssertionError('MoE step 1: %d routings recorded, not one a '
                             'layer (%d)' % (len(routes), n_layer))
    return out, [tuple(t.cpu().numpy() for t in r) for r in routes]


def _route_diff(got, want, top_k):
    """Per layer, the card's routes (`got`) against the CPU's (`want`):
    the assignments routed to another expert, the keep masks that differ,
    and the gap between the top_k-th and the next gate logit (the CPU's)
    at the tokens routed differently, which a rounding-sized difference
    can cross."""
    out = []
    for layer, ((e_g, k_g, _, _), (e_w, k_w, logits, _)) in enumerate(
            zip(got, want)):
        moved = np.nonzero((e_g != e_w).any(axis=0))[0]
        top = -np.sort(-logits, axis=1)
        gap = top[:, top_k - 1] - top[:, top_k]
        out.append({'layer': layer, 'assignments': int(e_w.size),
                    'rerouted': int((e_g != e_w).sum()),
                    'keep_differs': int((k_g != k_w).sum()),
                    'gap_at_rerouted': float(gap[moved].min())
                    if moved.size else None,
                    'gap_min': float(gap.min())})
    return out


def _expert_breakdown(outs, gnames, name, routes, a, b, weighted, state):
    """The gradient `name` of an expert-stacked moe_mlp parameter ([E,
    ...]), run `a` against run `b`, expert by expert: the tokens `b` keeps
    for the expert and those of them the loss weighs (`weighted`, a bool
    [nt]), its |a - b| / |b| (L2) and its share of the tensor's norm; for
    W1, the smallest |pre-activation| of a weighted kept token over the
    RMS of them all (`b`'s tokens and the `state` weights, float64): a
    relu that a rounding-sized change flips moves a whole column of the
    gradient when few tokens carry it. None for another parameter."""
    n_exp = MOE_ENCODER['num_experts']
    g_a, g_b = outs[a][1 + gnames.index(name)], outs[b][1 + gnames.index(name)]
    if not name.startswith('moe_mlp_') or g_b.ndim < 2 \
            or g_b.shape[0] != n_exp:
        return None
    prefix = name.split('.')[0]
    expert, keep, _, xs = routes[b][int(prefix[len('moe_mlp_'):])]
    out = []
    for e in range(n_exp):
        kept = ((expert == e) & (keep > 0)).any(axis=0)
        d = {'expert': e, 'tokens': int(kept.sum()),
             'weighted_tokens': int((kept & weighted).sum()),
             'rel_l2': _rel_l2(g_a[e], g_b[e]),
             'norm_share': float(np.linalg.norm(g_b[e]))
             / (float(np.linalg.norm(g_b)) or 1.0), 'relu_margin': None}
        if name.startswith(prefix + '.w_1') and d['weighted_tokens']:
            pre = xs[kept & weighted].astype(np.float64) \
                @ state[prefix + '.w_1'][e].astype(np.float64) \
                + state[prefix + '.b_0'][e].astype(np.float64)
            d['relu_margin'] = float(np.abs(pre).min()
                                     / np.sqrt(np.mean(pre * pre)))
        out.append(d)
    return out


def _moe_overflow(state, feed, rec):
    """(c) overflow: layer 0's moe_mlp rule at capacity_factor
    MOE_OVERFLOW_CF on the card and on the CPU from the same weights and
    tokens: the kept slots and the routes equal, the outputs close."""
    import torch
    from paddle_tpu_torch.fluid.lowering import Ctx
    from paddle_tpu_torch.fluid.ops_impl import moe_ops
    from paddle_tpu_torch.parallel import moe as tmoe
    c = MOE_ENCODER
    rng = np.random.RandomState(SEED)
    x = rng.randn(MOE_BATCH * c['max_length'], c['d_model']).astype(
        'float32')
    names = {'GateW': 'moe_mlp_0.w_0', 'W1': 'moe_mlp_0.w_1',
             'B1': 'moe_mlp_0.b_0', 'W2': 'moe_mlp_0.w_2',
             'B2': 'moe_mlp_0.b_1'}
    attrs = {'num_experts': c['num_experts'], 'top_k': c['top_k'],
             'capacity_factor': MOE_OVERFLOW_CF, 'act': 'relu'}
    cap = int(max(1, MOE_OVERFLOW_CF * c['top_k'] * x.shape[0]
                  / c['num_experts']))
    from paddle_tpu_torch import fluid
    got = {}
    for where, dev in (('card', fluid.CUDAPlace(0).torch_device()),
                       ('cpu', torch.device('cpu'))):
        ins = {'X': [torch.from_numpy(x).to(dev)]}
        ins.update({k: [torch.from_numpy(state[n]).to(dev)]
                    for k, n in names.items()})
        with torch.no_grad():
            out = moe_ops._moe_mlp(ins, attrs, Ctx(dev))['Out']
            logits = (ins['X'][0] @ ins['GateW'][0]).float()
            _, route = tmoe.pack_topk(ins['X'][0], logits, c['num_experts'],
                                      cap, c['top_k'])
        got[where] = (out.cpu().numpy(), [r.cpu().numpy() for r in route])
    keep_card, keep_cpu = got['card'][1][2], got['cpu'][1][2]
    same_route = all(np.array_equal(a, b) for a, b in
                     zip(got['card'][1][:3], got['cpu'][1][:3]))
    err = _rel_l2(got['card'][0], got['cpu'][0])
    rec['overflow'] = {'capacity_factor': MOE_OVERFLOW_CF, 'cap': cap,
                       'kept': int(keep_card.sum()),
                       'assignments': int(keep_card.size),
                       'routes_equal': bool(same_route),
                       'out_rel_l2': err}
    log('[parallel] MoE overflow (capacity factor %g, %d slots an expert): '
        '%d of %d assignments kept on the card, routes equal to the CPU '
        'rule %s, output rel L2 %.3g'
        % (MOE_OVERFLOW_CF, cap, keep_card.sum(), keep_card.size,
           same_route, err))
    if not (same_route and keep_card.sum() < keep_card.size
            and np.array_equal(keep_card, keep_cpu)
            and err <= CROSS_DEVICE_TOL):
        raise AssertionError('MoE overflow on the card against the CPU rule: '
                             'routes equal %r, output %.3g'
                             % (same_route, err))


def _parallel_moe(rec):
    """(c): the MoE encoder trained captured under set_mesh({'dp': 1})
    (the mesh path: two one-rank all_to_alls a layer); step 1 card against
    CPU at MOE_CPU_BATCH rows within MOE_GRAD_SPREAD times the CPU's own
    spread (its weights scaled by 1 + AMP_STATE_NOISE * noise), with each
    layer's routes on the card and the nudged CPU against the CPU's; the
    mesh path against the dense path on the card, bitwise; the overflow
    routes.
    Returns the launch counts of the captured training."""
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.ops_impl import moe_ops
    t0 = time.perf_counter()
    main, startup, avg_cost = build_moe_encoder()
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    initial = scope.to_numpy()
    feeds = _moe_feeds(MOE_BATCH, PARALLEL_STEPS)
    log('[parallel] MoE encoder built and initialized: %.1f s'
        % (time.perf_counter() - t0))
    main.set_mesh({'dp': 1})
    real, calls = moe_ops.moe_apply, [0]

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    moe_ops.moe_apply = counted
    t_train = time.perf_counter()
    try:
        _reset_launch_counts()
        losses, secs = [], []
        for feed in feeds:
            t0 = time.perf_counter()
            loss, = exe.run(main, feed=feed, fetch_list=[avg_cost],
                            scope=scope)
            secs.append(time.perf_counter() - t0)
            losses.append(float(np.asarray(loss).reshape(())))
        launches = _launch_counts()
    finally:
        moe_ops.moe_apply = real
    main.set_mesh(None)
    log('[parallel] MoE encoder trained %d steps: %.1f s'
        % (PARALLEL_STEPS, time.perf_counter() - t_train))
    stats = exe.cache_stats
    layers = MOE_ENCODER['n_layer']
    rec['moe'] = {'losses': losses, 'step_s': secs,
                  'median_replay_s': float(np.median(secs[2:])),
                  'captures': stats['captures'], 'replays': stats['replays'],
                  'mesh_path_calls': calls[0],
                  'launches_per_step': {n: c // PARALLEL_STEPS
                                        for n, c in launches.items() if c}}
    log('[parallel] MoE encoder (%d layers, d_model %d, %d experts of '
        'hidden %d, top %d) under set_mesh({"dp": 1}), batch %d x %d: losses '
        '%s; median replay %.4f s; %d mesh-path calls while capturing'
        % (layers, MOE_ENCODER['d_model'], MOE_ENCODER['num_experts'],
           MOE_ENCODER['hidden'], MOE_ENCODER['top_k'], MOE_BATCH,
           MOE_ENCODER['max_length'], ', '.join('%.4f' % x for x in losses),
           rec['moe']['median_replay_s'], calls[0]))
    if not np.isfinite(losses).all() or stats['captures'] != 1:
        raise AssertionError('MoE encoder: losses %r, cache %r'
                             % (losses, stats))
    # the warm-up and the capture run every layer's mesh path in Python; a
    # replay (the capture's own first one included) runs none
    want = layers * (PARALLEL_STEPS - stats['replays'] + 1)
    if calls[0] != want:
        raise AssertionError('MoE mesh path ran %d times in %d steps (%d '
                             'replays), not %d'
                             % (calls[0], PARALLEL_STEPS, stats['replays'],
                                want))
    del exe, scope
    gnames = grad_names(main)
    # the mesh path against the dense path on the card, bitwise
    t0 = time.perf_counter()
    card = fluid.CUDAPlace(0)
    mesh = _moe_first_step(main, avg_cost, initial, feeds[0], card, True,
                           gnames)
    dense = _moe_first_step(main, avg_cost, initial, feeds[0], card, False,
                            gnames)
    log('[parallel] MoE step 1 twice on the card: %.1f s'
        % (time.perf_counter() - t0))
    bitwise = all(np.array_equal(a, b) for a, b in zip(mesh, dense))
    worst = max(_rel_l2(a, b) for a, b in zip(mesh, dense))
    rec['moe']['mesh_vs_dense_bitwise'] = bitwise
    rec['moe']['mesh_vs_dense_rel_l2_max'] = worst
    log('[parallel] MoE step 1, mesh path against dense path on the card: '
        'bitwise %s (worst rel L2 %.3g)' % (bitwise, worst))
    if not bitwise:
        raise AssertionError('MoE mesh path against the dense path: not '
                             'bitwise (worst %.3g)' % worst)
    # card against CPU at MOE_CPU_BATCH rows
    small = _moe_feeds(MOE_CPU_BATCH, 1)[0]
    noise = np.random.RandomState(SEED)
    nudged = {n: (v * (1 + AMP_STATE_NOISE * noise.randn(*v.shape))).astype(
        v.dtype) if v.dtype == np.float32 and v.ndim >= 2 else v
        for n, v in initial.items()}
    t0 = time.perf_counter()
    outs, routes = {}, {}
    for name, state, place, mesh in (
            ('card', initial, card, True),
            ('cpu', initial, fluid.CPUPlace(), False),
            ('nudged', nudged, fluid.CPUPlace(), False)):
        outs[name], routes[name] = _moe_routed(
            lambda: _moe_first_step(main, avg_cost, state, small, place,
                                    mesh, gnames), MOE_ENCODER['n_layer'])
    cpu_s = time.perf_counter() - t0
    rdiff = _route_diff(routes['card'], routes['cpu'], MOE_ENCODER['top_k'])
    ndiff = _route_diff(routes['nudged'], routes['cpu'],
                        MOE_ENCODER['top_k'])
    log('[parallel] MoE step 1 on the card and twice on the CPU: %.1f s'
        % cpu_s)
    med_g, worst_g = _grad_spread(outs, gnames, 'card', 'cpu')
    med_n, worst_n = _grad_spread(outs, gnames, 'nudged', 'cpu')
    loss_g = abs(float(outs['card'][0]) - float(outs['cpu'][0]))
    loss_n = abs(float(outs['nudged'][0]) - float(outs['cpu'][0]))
    rec['moe']['card_vs_cpu'] = {
        'rows': MOE_CPU_BATCH, 'grad_median': med_g, 'grad_worst': worst_g,
        'cpu_spread_median': med_n, 'cpu_spread_worst': worst_n,
        'loss_diff': loss_g, 'cpu_loss_spread': loss_n, 'seconds': cpu_s,
        'routes_card_vs_cpu': rdiff, 'routes_nudged_vs_cpu': ndiff}
    weighted = small['lbl_word'].reshape(-1) != 0
    split = {w: _expert_breakdown(outs, gnames, worst_g[1], routes, w,
                                  'cpu', weighted, initial)
             for w in ('card', 'nudged')}
    rec['moe']['card_vs_cpu']['worst_by_expert'] = split
    if split['card'] is not None:
        log('[parallel] MoE step 1, the worst gradient %s by expert: tokens '
            'kept %s, of them weighed by the loss %s; share of the tensor\'s '
            'norm %s; |diff| / |cpu| (L2) card %s, the nudged CPU %s; '
            'smallest |pre-activation| of a weighed token over their RMS %s'
            % (worst_g[1], [d['tokens'] for d in split['card']],
               [d['weighted_tokens'] for d in split['card']],
               ['%.3g' % d['norm_share'] for d in split['card']],
               ['%.3g' % d['rel_l2'] for d in split['card']],
               ['%.3g' % d['rel_l2'] for d in split['nudged']],
               ['%.3g' % d['relu_margin'] if d['relu_margin'] is not None
                else '-' for d in split['card']]))
    for what, diff in (('card', rdiff), ('the nudged CPU', ndiff)):
        log('[parallel] MoE step 1 routes, %s against the CPU, layer by '
            'layer: assignments to another expert %s, keep masks differing '
            '%s (of %d); top-%d gate gap at a rerouted token %s, smallest '
            'gap %s' % (what, [d['rerouted'] for d in diff],
                        [d['keep_differs'] for d in diff],
                        diff[0]['assignments'], MOE_ENCODER['top_k'],
                        ['%.3g' % d['gap_at_rerouted']
                         if d['gap_at_rerouted'] is not None else '-'
                         for d in diff],
                        ['%.3g' % d['gap_min'] for d in diff]))
    log('[parallel] MoE step 1 card against CPU at batch %d: loss |diff| '
        '%.3g (the CPU\'s own %.3g); %d gradients, |diff| / |cpu| (L2) '
        'median %.3g, max %.3g (%s); the CPU with its weights scaled by 1 + '
        '%g * noise: median %.3g, max %.3g (%s); tol %g x'
        % (MOE_CPU_BATCH, loss_g, loss_n, len(gnames), med_g, worst_g[0],
           worst_g[1], AMP_STATE_NOISE, med_n, worst_n[0], worst_n[1],
           MOE_GRAD_SPREAD))
    if not (med_g <= MOE_GRAD_SPREAD * med_n
            and loss_g <= MOE_GRAD_SPREAD * max(loss_n, 1e-7)):
        raise AssertionError(
            'MoE step 1 card against CPU: gradients %.3g against the CPU\'s '
            'own %.3g, loss %.3g against %.3g (tol %g x)'
            % (med_g, med_n, loss_g, loss_n, MOE_GRAD_SPREAD))
    t0 = time.perf_counter()
    _moe_overflow(initial, feeds[0], rec['moe'])
    torch.cuda.synchronize()
    log('[parallel] MoE overflow on the card and the CPU: %.1f s'
        % (time.perf_counter() - t0))
    return launches


def phase_parallel():
    """Phase 7o: data and expert parallelism on a one-rank NCCL group: (a)
    Transformer-base trained captured through the Executor,
    ParallelExecutor(use_cuda=True) and set_mesh({'dp': 1}), (b) with
    BuildStrategy.Reduce and DistributeTranspiler(shard_parameters=True),
    each held to the plain run, the ParallelExecutor replay traced for its
    NCCL and attention kernels; (c) the MoE encoder. The group is destroyed
    before the phase returns. Returns {path: launch counts} of parallel (the
    ParallelExecutor run) and moe_encoder."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import parallel
    t0 = time.perf_counter()
    info = parallel.init_distributed()
    rec = {'group': info}
    try:
        counts = {'parallel': _parallel_transformer(rec),
                  'moe_encoder': _parallel_moe(rec)}
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    rec['seconds'] = time.perf_counter() - t0
    rec['card'] = nvidia_smi_line()
    log(json.dumps({'parallel': rec}))
    log('[parallel] phase 7o took %.1f s; card: %s'
        % (rec['seconds'], rec['card']))
    return counts


# -- phase 8 ----------------------------------------------------------------

def _to_host(tensors):
    """Device tensors to numpy through pinned buffers (what Executor.run
    does with its fetches), waiting for the copies."""
    import torch
    outs = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        outs.append(h)
    torch.cuda.current_stream().synchronize()
    # numpy has no bf16: widened, as Executor.run widens its fetches
    return [(h.float() if h.dtype == torch.bfloat16 else h).numpy()
            for h in outs]


def _device_busy(fn, n):
    """(device busy ms per call, idle share of the traced wall, traced wall
    ms per call, kernel records per call) over n calls of fn under
    torch.profiler; a replayed graph's kernels are recorded one by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, records = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            busy_us += e.time_range.elapsed_us()
            records += 1
    return (busy_us / 1e3 / n, 1.0 - busy_us / 1e6 / wall, wall * 1e3 / n,
            records / n)


def _reserved():
    """Memory the caching allocator holds once it has released every cached
    block no tensor uses: what live tensors and the captured graphs' pools
    take."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _measure(path, captured, eager, pool_bytes, steps=CAPTURED_STEPS):
    """The median step of `captured` (the path's entry point: a replay) and of
    `eager` (debug_step's walk), each ending with its fetch on the host,
    in this call; device busy time, idle share and kernel records per step
    (torch.profiler over PROFILED_STEPS more); the peak memory allocated
    over the timed steps and how far it rose above what was allocated
    before them (an eager step's activations; a replay allocates only its
    fetches), beside `pool_bytes`, what the path's capture reserved (its
    graph pool, where a replay's activations live)."""
    import gc
    import torch
    out = {'path': path}
    modes = (('captured', captured), ('eager', eager))
    timed = {}
    gc.collect()
    # both modes timed before either is traced: a traced run leaves the
    # profiler's hooks behind
    for mode, fn in modes:
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        secs = []
        for _ in range(steps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        timed[mode] = (secs, base, torch.cuda.max_memory_allocated())
    for mode, fn in modes:
        secs, base, peak = timed[mode]
        busy, idle, wall, records = _device_busy(fn, PROFILED_STEPS)
        med = float(np.median(secs))
        out[mode] = dict(
            median_step_ms=med * 1e3, step_ms=[s * 1e3 for s in secs],
            device_busy_ms=busy, idle_share_of_traced_wall=idle,
            idle_share_of_median_step=1.0 - busy / 1e3 / med,
            traced_wall_ms=wall, device_records_per_step=records,
            peak_allocated_gb=peak / 1e9,
            step_extra_gb=(peak - base) / 1e9)
    out['captured']['graph_pool_gb'] = pool_bytes / 1e9
    out['speedup'] = out['eager']['median_step_ms'] \
        / out['captured']['median_step_ms']
    c, e = out['captured'], out['eager']
    if not c['device_busy_ms'] > 0:
        raise AssertionError('%s: the profiler saw no device time in the '
                             'replays' % path)
    log('[captured] %s: median step captured %.4f ms, eager %.4f ms '
        '(%.2fx); device busy %.4f / %.4f ms; idle %.3f / %.3f of the '
        'median step; peak allocated %.3f / %.3f GB; the capture reserved '
        '%.3f GB, an eager step allocates %.3f GB more; kernel records per '
        'step %.0f / %.0f'
        % (path, c['median_step_ms'], e['median_step_ms'], out['speedup'],
           c['device_busy_ms'], e['device_busy_ms'],
           c['idle_share_of_median_step'], e['idle_share_of_median_step'],
           c['peak_allocated_gb'], e['peak_allocated_gb'],
           c['graph_pool_gb'], e['step_extra_gb'],
           c['device_records_per_step'], e['device_records_per_step']))
    return out


def _held_to_eager(what, got, eager):
    """The determinism rule: where two eager walks are bitwise equal the
    replay must be too; elsewhere it must lie within twice their largest
    difference (the eager-against-eager spread of this run). `got` and each
    entry of `eager` are {name: tensor}. Returns (n bitwise, n by
    spread)."""
    import torch
    e1, e2 = eager
    exact = spread_n = 0
    for n, a in e1.items():
        r, b = got[n], e2[n]
        if torch.equal(a, b):
            if not torch.equal(r, a):
                raise AssertionError(
                    '%s: %s: the replay differs from two bitwise equal '
                    'eager walks (max abs diff %.3g)' % (
                        what, n, float((r.double() - a.double()).abs()
                                       .max())))
            exact += 1
            continue
        a, b, r = a.double(), b.double(), r.double()
        spread = float((a - b).abs().max())
        d = min(float((r - a).abs().max()), float((r - b).abs().max()))
        if not d <= 2 * spread:
            raise AssertionError(
                '%s: %s: the replay is %.3g from the eager walks, which '
                'differ by %.3g' % (what, n, d, spread))
        spread_n += 1
    return exact, spread_n


def _eager_spread(art, state, feed):
    """How many of a step's written persistables and fetches differ
    between two eager walks from one state."""
    import torch
    g = torch.Generator(device='cuda')
    walks = []
    for _ in range(2):
        fetches, new, _ = art.debug_step(
            {n: t.clone() for n, t in state.items()}, feed, 0,
            generator=g)
        walks.append(list(new.values()) + list(fetches))
    return sum(not torch.equal(a, b) for a, b in zip(*walks))


def _replay_against_eager(what, handle, art, scope, feed, seed):
    """One step from one state three ways: debug_step's eager walk twice
    (on clones of the state) and a replay through `handle`; the fetches
    and the written persistables held to the determinism rule
    (_held_to_eager). The scope's state is restored afterwards."""
    import torch
    from paddle_tpu_torch.fluid.lowering import map_value
    snap = {n: t.clone() for n, t in art.state_dict(scope).items()}
    dev_feed = {n: map_value(lambda t: torch.as_tensor(t).cuda(), v)
                for n, v in feed.items()}
    g = torch.Generator(device='cuda')
    eager = []
    for _ in range(2):
        fetches, new, _ = art.debug_step(
            {n: t.clone() for n, t in snap.items()}, dev_feed, seed,
            generator=g)
        eager.append(dict(new, **{'fetch %d' % i: t
                                  for i, t in enumerate(fetches)}))
    fetches = handle.step(feed or None, seed=seed)
    got = {n: scope._chain_get(n) for n in eager[0] if n in snap}
    got.update(('fetch %d' % i, t) for i, t in enumerate(fetches))
    exact, spread = _held_to_eager(what, got, eager)
    with torch.no_grad():
        for n, t in art.state_dict(scope).items():
            t.copy_(snap[n])
    log('[captured] %s: replay against the eager walk: %d tensors bitwise '
        'equal, %d within the eager spread' % (what, exact, spread))
    return exact, spread


def _launches_under(fn, n):
    """{kernel: launches per call} over n calls of fn."""
    from paddle_tpu_torch import ops
    before = {k: v.launches for k, v in ops.KERNELS.items()}
    for _ in range(n):
        fn()
    return {k: (v.launches - before[k]) / n for k, v in ops.KERNELS.items()
            if v.launches != before[k]}


def _captured_transformer(records, amp=False):
    """Transformer-base training at batch 16 (get_model, dropout 0.1); with
    amp under decorate_program (the bf16 attention kernels)."""
    import torch
    from paddle_tpu_torch import fluid
    main, startup, avg_cost, names, reader = build_trainer()
    tag = 'transformer' + (' AMP' if amp else '')
    if amp:
        fluid.amp.decorate_program(main)
    init = fluid.Scope()
    fluid.Executor().run(startup, scope=init)
    it = reader()
    feeds = [as_feed(next(it), names) for _ in range(4)]
    # captured run j against eager run j, dropout on: bitwise
    runs = []
    for eager in (False, True):
        scope = fluid.Scope()
        scope.vars.update({n: t.clone() for n, t in init.vars.items()})
        exe = fluid.Executor()
        ctx = fluid.debugger.check_nan_inf() if eager \
            else contextlib.nullcontext()
        with ctx:
            losses = []
            for j, f in enumerate(feeds[:3]):
                if j == 1 and not eager:
                    r0 = _reserved()
                losses.append(exe.run(main, feed=f, fetch_list=[avg_cost],
                                      scope=scope)[0])
                if j == 1 and not eager:
                    pool = _reserved() - r0
        runs.append((losses, scope, exe))
    (cl, cs, cexe), (el, es, _) = runs
    if cexe.cache_stats['captures'] != 1 or cexe.cache_stats['replays'] != 2:
        raise AssertionError('3 %s steps: %r' % (tag, cexe.cache_stats))
    for j, (a, b) in enumerate(zip(cl, el)):
        if not np.array_equal(a, b):
            raise AssertionError('%s, dropout 0.1: captured run %d loss %r, '
                                 'eager run %d %r' % (tag, j, a, j, b))
    diff = [n for n in cs.vars if not torch.equal(cs.vars[n], es.vars[n])]
    if diff:
        raise AssertionError('%s, dropout 0.1: after 3 steps captured and '
                             'eager differ in %r' % (tag, diff[:8]))
    log('[captured] %s: 3 steps with dropout 0.1, captured (warm-up, '
        'capture, replay) against eager: losses %s and all %d persistables '
        'bitwise equal' % (
            tag, ', '.join('%.6f' % float(np.asarray(x).reshape(()))
                           for x in cl), len(cs.vars)))
    del runs, es
    _captured_training_step(
        tag, 'transformer training, batch 16' + (', AMP' if amp else ''),
        cexe, main, cs, [avg_cost], feeds[3], pool, records, amp)


def _captured_training_step(tag, path, exe, main, scope, fetch, feed, pool,
                            records, amp=False):
    """A captured Transformer training step: its launches per replay (18 of
    each attention kernel, the bf16 ones under AMP), one replay against
    the eager walk (_replay_against_eager) and the medians of replays and
    eager walks (_measure), appended to records."""
    import torch
    launches = _launches_under(
        lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope), 2)
    want = {k + ('_bf16' if amp else ''): float(ATTENTION_OPS_PER_FORWARD)
            for k in ('flash_attention_fwd', 'flash_attention_bwd_dq',
                      'flash_attention_bwd_dkv')}
    if launches != want:
        raise AssertionError('%s replays launched %r per step, not %r'
                             % (tag, launches, want))
    h = exe.acquire_step(main, feed=feed, fetch_list=fetch, scope=scope)
    art = exe.step_artifact(main, feed=feed, fetch_list=fetch, scope=scope)
    _replay_against_eager(tag, h, art, scope, feed, 77)
    state = {n: t.clone() for n, t in art.state_dict(scope).items()}
    dev = {n: torch.from_numpy(v).cuda() for n, v in feed.items()}
    g = torch.Generator(device='cuda')
    r = _measure(
        path, lambda: exe.run(main, feed=feed, fetch_list=fetch,
                              scope=scope),
        lambda: _to_host(art.debug_step(state, dev, 5, generator=g)[0]),
        pool, steps=CAPTURED_STEPS_8)
    r['launches_per_replay'] = launches
    records.append(r)


def _captured_trainer(records):
    """The Trainer's Transformer-base step (phase 7g's program, dropout
    0.1, batch 16): two train() steps (warm-up, capture), then the checks
    and records of the get_model step on the Trainer's executor and
    scope."""
    tr = transformer_trainer()
    r0 = _reserved()
    tr.train(num_epochs=1, event_handler=lambda ev: None,
             reader=trainer_reader(2), feed_order=TRAINER_FEEDS)
    pool = _reserved() - r0
    if tr.exe.cache_stats['captures'] != 1:
        raise AssertionError('Trainer steps: %r' % (tr.exe.cache_stats,))
    feed = as_feed(list(trainer_reader(3)())[2], TRAINER_FEEDS)
    _captured_training_step(
        'Trainer transformer', 'Trainer transformer training, batch 16',
        tr.exe, tr.train_program, tr.scope,
        [v.name for v in tr.train_func_outputs], feed, pool, records)


def _captured_ctr(records):
    """DeepFM (Adam, both FM tables sparse) at batch 256."""
    import torch
    from paddle_tpu_torch import fluid
    main, startup, avg_cost, auc, _ = build_ctr('adam')
    init = fluid.Scope()
    fluid.Executor().run(startup, scope=init)
    from paddle_tpu_torch.batch import batch
    from paddle_tpu_torch.models import deepfm
    feeds = [ctr_feed(b) for b in batch(
        deepfm.synthetic_ctr_reader(tag='train'), CTR_BATCH)()][:6]
    fetch = [avg_cost, auc]

    def fresh():
        s = fluid.Scope()
        s.vars.update({n: t.clone() for n, t in init.vars.items()})
        return s, fluid.Executor()

    # run_bundle(K=4) against 4 run() calls: bitwise
    s1, e1 = fresh()
    ran = []
    for j, f in enumerate(feeds[:4]):
        if j == 1:
            r0 = _reserved()
        ran.append(e1.run(main, feed=f, fetch_list=fetch, scope=s1))
        if j == 1:
            pool = _reserved() - r0
    s2, e2 = fresh()
    bundled = e2.run_bundle(main, feeds=feeds[:4], fetch_list=fetch,
                            scope=s2)
    for j in range(4):
        for a, b in zip(ran[j], bundled):
            if not np.array_equal(a, b[j]):
                raise AssertionError('run_bundle(K=4) inner step %d fetched '
                                     '%r, run %d %r' % (j, b[j], j, a))
    diff = [n for n in s1.vars if not torch.equal(s1.vars[n], s2.vars[n])]
    if diff or e2.cache_stats['replays'] != 3:
        raise AssertionError('run_bundle(K=4) against 4 runs: state differs '
                             'in %r; %r' % (diff[:8], e2.cache_stats))
    # a held device fetch, unchanged by the next replay
    held = e1.run(main, feed=feeds[4], fetch_list=fetch, scope=s1,
                  return_numpy=False)
    copies = [t.clone() for t in held]
    e1.run(main, feed=feeds[5], fetch_list=fetch, scope=s1)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(held, copies)):
        raise AssertionError('a held device fetch changed under the next '
                             'replay')
    log('[captured] ctr: run_bundle(K=4) against 4 run() calls: fetches and '
        'all %d persistables bitwise equal; a held device fetch unchanged by '
        'the next replay' % len(s1.vars))
    launches = _launches_under(
        lambda: e1.run(main, feed=feeds[5], fetch_list=fetch, scope=s1), 4)
    if launches != {'sparse_adam': 2.0}:
        raise AssertionError('DeepFM replays launched %r per step'
                             % (launches,))
    h = e1.acquire_step(main, feed=feeds[5], fetch_list=fetch, scope=s1)
    art = e1.step_artifact(main, feed=feeds[5], fetch_list=fetch, scope=s1)
    _replay_against_eager('ctr', h, art, s1, feeds[5], 0)
    state = {n: t.clone() for n, t in art.state_dict(s1).items()}
    dev = {n: torch.from_numpy(v).cuda() for n, v in feeds[5].items()}
    g = torch.Generator(device='cuda')
    r = _measure(
        'DeepFM training, batch 256',
        lambda: e1.run(main, feed=feeds[5], fetch_list=fetch, scope=s1),
        lambda: _to_host(art.debug_step(state, dev, 0, generator=g)[0]),
        pool, steps=CAPTURED_STEPS_8)
    r['launches_per_replay'] = launches
    records.append(r)


def _captured_decode(records):
    """One dispatch of the paged DecodeEngine with all 16 slots decoding
    (the loop held off through the engine's handle lock)."""
    import torch
    from paddle_tpu_torch import serving
    cfg = DECODE_CONFIG
    eng = serving.DecodeEngine(mt_decoder_weights(),
                               serving.DecodeConfig(**cfg))
    reqs = decode_requests()[:cfg['slots']]
    try:
        r0 = _reserved()
        eng.warmup()                # the step's warm-up and capture
        pool = _reserved() - r0
        futs = [eng.submit({'enc': e}, max_new_tokens=cfg['max_len'])
                for e, _ in reqs]
        t_end = time.monotonic() + 600
        while eng.stats['joins'] < cfg['slots']:
            if time.monotonic() > t_end:
                raise AssertionError('the decode requests did not join (%r)'
                                     % (eng.stats,))
            time.sleep(0.001)
        with eng._handle_lock:
            if eng.stats['slots_occupied'] != cfg['slots']:
                raise AssertionError('the slots did not fill (%r)'
                                     % (eng.stats,))
            h = eng._acquire()
            art = h._compiled
            scope = eng._scope

            def dispatch(step):
                active, _, _, _, steps = step()
                _to_host([torch.stack([active.to(torch.int32), steps])])

            _replay_against_eager('decode', h, art, scope, {}, 0)
            launches = _launches_under(lambda: dispatch(h.step), 3)
            if launches != {'paged_attention': 1.0}:
                raise AssertionError('decode replays launched %r per '
                                     'dispatch' % (launches,))
            state = {n: t.clone() for n, t in h.state.items()}
            g = torch.Generator(device='cuda')
            r = _measure(
                'decode dispatch, 16 slots full', lambda: dispatch(h.step),
                lambda: dispatch(lambda: art.debug_step(
                    state, {}, 0, generator=g)[0]), pool,
                steps=CAPTURED_STEPS_8)
            r['launches_per_replay'] = launches
            live = int(h.state['cbd_active'].sum())
            if live != cfg['slots']:
                raise AssertionError('%d of %d slots still decoding after '
                                     'the measured dispatches'
                                     % (live, cfg['slots']))
        for f in futs:
            f.result(timeout=600)
    finally:
        eng.shutdown()
    records.append(r)


def _captured_serving(records):
    """Predictor.run on full-width Transformer-base at batch 1 and 16, fp32
    and transpiled to bf16 (Float16Transpiler)."""
    import torch
    from paddle_tpu_torch import fluid, inference
    cfg = TRANSFORMER_BASE
    with tempfile.TemporaryDirectory(prefix='chip_smoke_cap_') as tmp:
        build_artifact(tmp, cfg, fluid.CUDAPlace(0))
        preds = [('', inference.Predictor(tmp)),
                 (', bf16', transpiled_predictor(tmp))]
    rng = np.random.RandomState(SEED)
    req = make_requests(1, 1, cfg['max_length'], cfg['trg_vocab_size'],
                        rng)[0]
    for (tag, pred), b in itertools.product(preds, (1, 16)):
        _captured_serving_at(records, pred, req, b, tag)


def _captured_serving_at(records, pred, req, b, tag):
    """One batch size of _captured_serving; tag ', bf16' for the
    transpiled predictor."""
    import torch
    exe, scope = pred._exe, pred._scope
    fwd = 'flash_attention_fwd' + ('_bf16' if tag else '')
    feed = {n: np.repeat(a, b, axis=0) for n, a in req.items()}
    pred.run(feed)              # the warm-up
    r0 = _reserved()
    pred.run(feed)              # the capture and its first replay
    pool = _reserved() - r0
    fetch = pred._fetch_vars
    h = exe.acquire_step(pred._program, feed=feed, fetch_list=fetch,
                         scope=scope)
    art = exe.step_artifact(pred._program, feed=feed, fetch_list=fetch,
                            scope=scope)
    _replay_against_eager('serving, batch %d%s' % (b, tag), h, art,
                          scope, feed, 0)
    launches = _launches_under(lambda: pred.run(feed), 2)
    if launches != {fwd: float(ATTENTION_OPS_PER_FORWARD)}:
        raise AssertionError('serving replays launched %r per forward'
                             % (launches,))
    state = art.state_dict(scope)
    dev = {n: torch.from_numpy(v).cuda() for n, v in feed.items()}
    g = torch.Generator(device='cuda')
    r = _measure('serving, batch %d%s' % (b, tag),
                 lambda: pred.run(feed),
                 lambda: _to_host(art.debug_step(
                     state, dev, 0, generator=g)[0]),
                 pool, steps=CAPTURED_STEPS_8)
    r['launches_per_replay'] = launches
    records.append(r)


def _captured_image(records):
    """MNIST LeNet (batch 128) and ResNet-50 (batch 32) training; the
    anomaly guard on LeNet fed a NaN."""
    import warnings
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import mnist
    main, startup = _program_pair()
    with unique_name.guard(), fluid.program_guard(main, startup):
        avg_cost, _, train_reader, _, _ = mnist.get_model()
    blk = main.global_block()
    feeder = fluid.DataFeeder([blk.var('pixel'), blk.var('label')],
                              fluid.CUDAPlace(0), program=main)
    lenet_feeds = [feeder.feed(b) for b in itertools.islice(
        train_reader(), 4)]
    main50, startup50, cost50, _, reader50 = build_resnet()
    blk50 = main50.global_block()
    feeder50 = fluid.DataFeeder([blk50.var('data'), blk50.var('label')],
                                fluid.CUDAPlace(0), program=main50)
    # a whole pass: the flowers reader's worker threads would otherwise
    # go on decoding the epoch while the steps are timed
    feed50 = [feeder50.feed(b) for b in reader50()
              if len(b) == RESNET_BATCH][0]
    paths = [('MNIST LeNet training, batch 128', main, startup, avg_cost,
              lenet_feeds[0]),
             ('ResNet-50 training, batch 32', main50, startup50, cost50,
              feed50)]
    amp_feeds = amp_resnet_feeds(1)
    for fmt in ('NHWC', 'NCHW'):
        paths.append(('ResNet-50 training, batch 32, AMP %s' % fmt,)
                     + build_resnet_amp(fmt) + (amp_feeds[fmt][0],))
    for name, prog, start, cost, feed in paths:
        scope = fluid.Scope()
        exe = fluid.Executor()
        exe.run(start, scope=scope)
        # warm-ups until the capture (an AMP tower's bf16-declared weights
        # and velocities come back fp32 from their first updates: two
        # warm-ups more)
        while not exe.cache_stats['captures']:
            r0 = _reserved()
            exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
            pool = _reserved() - r0
        art = exe.step_artifact(prog, feed=feed, fetch_list=[cost],
                                scope=scope)
        state = {n: t.clone() for n, t in art.state_dict(scope).items()}
        dev = {n: torch.as_tensor(v).cuda() for n, v in feed.items()}
        g = torch.Generator(device='cuda')
        differ = _eager_spread(art, state, dev)
        records.append(_measure(
            name, lambda: exe.run(prog, feed=feed, fetch_list=[cost],
                                  scope=scope),
            lambda: _to_host(art.debug_step(
                state, dev, 0, generator=g)[0]), pool,
            steps=CAPTURED_STEPS_8))
        records[-1]['eager_walks_differ_in'] = differ
        del state, exe, scope
        # cuDNN's default convolution algorithms are not deterministic:
        # the replay is held to the eager walk with deterministic ones, in
        # a capture of its own; what they cost is the median replay beside
        # the default one
        torch.backends.cudnn.deterministic = True
        try:
            scope = fluid.Scope()
            exe = fluid.Executor()
            exe.run(start, scope=scope)
            while not exe.cache_stats['captures']:
                exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
            h = exe.acquire_step(prog, feed=feed, fetch_list=[cost],
                                 scope=scope)
            art = exe.step_artifact(prog, feed=feed, fetch_list=[cost],
                                    scope=scope)
            _replay_against_eager(name + ', cuDNN deterministic', h, art,
                                  scope, feed, 0)
            secs = []
            for _ in range(CAPTURED_STEPS_8):
                t0 = time.perf_counter()
                exe.run(prog, feed=feed, fetch_list=[cost], scope=scope)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        finally:
            torch.backends.cudnn.deterministic = False
        det = float(np.median(secs)) * 1e3
        records[-1]['cudnn_deterministic_median_step_ms'] = det
        log('[captured] %s: with cuDNN\'s default algorithms two eager '
            'walks from one state differ in %d tensors; the replay with '
            'cudnn.deterministic %.4f ms against %.4f ms with the default '
            'algorithms (%.3fx)'
            % (name, differ, det, records[-1]['captured']['median_step_ms'],
               det / records[-1]['captured']['median_step_ms']))
        del h, art, exe, scope

    # the guard: one step fed a NaN leaves every persistable bitwise as it
    # was and counts one skip; the next healthy step moves them again
    fluid.anomaly_guard(main)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    for f in lenet_feeds[:2]:
        exe.run(main, feed=f, fetch_list=[avg_cost], scope=scope)
    before = {n: t.clone() for n, t in scope.vars.items()}
    bad = dict(lenet_feeds[2], pixel=lenet_feeds[2]['pixel'].copy())
    bad['pixel'][0, 0, 0, 0] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        loss = exe.run(main, feed=bad, fetch_list=[avg_cost], scope=scope)
    changed = [n for n, t in scope.vars.items()
               if not torch.equal(t, before[n])]
    if changed or exe.skipped_steps != 1 or np.isfinite(loss[0]).all():
        raise AssertionError('the guarded LeNet step fed a NaN: loss %r, '
                             '%d skips, changed %r' % (
                                 loss[0], exe.skipped_steps, changed[:8]))
    exe.run(main, feed=lenet_feeds[3], fetch_list=[avg_cost], scope=scope)
    moved = sum(not torch.equal(t, before[n])
                for n, t in scope.vars.items())
    if exe.skipped_steps != 1 or not moved or \
            exe.cache_stats['replays'] != 3:
        raise AssertionError('after the skip: %d skips, %d persistables '
                             'moved, %r' % (exe.skipped_steps, moved,
                                            exe.cache_stats))
    log('[captured] anomaly guard on LeNet (replayed step fed a NaN): '
        'all %d persistables bitwise unchanged, skipped_steps 1, health %r; '
        'the next healthy replay moved %d of them'
        % (len(before), {k: np.asarray(v).tolist()
                         for k, v in exe.last_step_health.items()}, moved))


def phase_captured():
    """Every path's captured step against debug_step's eager walk in this
    call; returns the records logged."""
    import torch
    records = []
    _captured_transformer(records)
    _captured_trainer(records)
    _captured_transformer(records, amp=True)
    _captured_ctr(records)
    _captured_decode(records)
    _captured_serving(records)
    _captured_image(records)
    torch.cuda.synchronize()
    card = nvidia_smi_line()
    for r in records:
        r['card'] = card
    log(json.dumps({'captured': records}))
    return records


def _between_phases(name):
    """Give the cached memory of the phases before back to the card (a
    capture cannot free cached blocks while it runs, and the graphs of
    earlier phases leave their pools behind) and log what stays."""
    import torch
    reserved = _reserved()
    log('[memory] before %s: %.3f GB allocated, %.3f GB reserved'
        % (name, torch.cuda.memory_allocated() / 1e9, reserved / 1e9))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')
    t_start = time.perf_counter()
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)
    from paddle_tpu_torch import ops
    log('[env] python %s, torch %s, CUDA %s, %d card(s): %s'
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.cuda.device_count(), torch.cuda.get_device_name(0)))
    phase_build()
    cases = phase_kernels()
    by_path = {}
    for name, phase in (('serving', phase_serving),
                        ('training', phase_training),
                        ('ctr_training', phase_ctr_training),
                        ('decode', phase_decode),
                        ('image_training', phase_image_training),
                        ('amp', phase_amp),
                        ('dense_training', phase_dense_training),
                        ('sequences', phase_sequences),
                        ('book_models', phase_book_models),
                        ('control_flow', phase_control_flow),
                        ('trainer', phase_trainer),
                        ('stream', phase_stream),
                        ('serving_stream', phase_serving_stream),
                        ('tier', phase_tier),
                        ('passes', phase_passes),
                        ('detection', phase_detection),
                        ('training_surface', phase_training_surface),
                        ('recordio', phase_recordio),
                        ('parallel', phase_parallel),
                        ('captured', phase_captured)):
        _between_phases(name)
        t0 = time.perf_counter()
        counts = phase()
        log('[time] phase %s took %.1f s' % (name, time.perf_counter() - t0))
        if name in ('serving', 'training', 'ctr_training',
                    'image_training'):
            by_path[name] = counts
        elif name != 'captured':
            by_path.update(counts)
    for path, counts in by_path.items():
        stray = {k: n for k, n in counts.items()
                 if n and path not in KERNEL_PATHS[k]}
        if stray:
            raise AssertionError('the %s path launched kernels of other '
                                 'paths: %r' % (path, stray))
    from paddle_tpu_torch import obs
    if obs.REGISTRY.counter('passes.errors').snapshot()['value']:
        raise AssertionError('a pass failure fell back to the unoptimized '
                             'program in the smoke run')
    if 'jax' in sys.modules or any(
            m == 'paddle_tpu' or m.startswith('paddle_tpu.')
            for m in sys.modules):
        raise AssertionError('the smoke run imported JAX or the JAX package')
    kernels = []
    for name, k in sorted(ops.KERNELS.items()):
        rs = cases[name]
        head = rs[0]
        paths = {p: n[name] for p, n in by_path.items() if n[name]}
        if not paths:
            raise AssertionError('%s was launched on no main path' % name)
        extra = {key: head[key] for key in (
            'eager_ms', 'ops_rate', 'library', 'library_kernels',
            'backward_pair') if key in head}
        checked = [r['deterministic'] for r in rs if 'deterministic' in r]
        if checked:
            extra['deterministic'] = all(checked)
        kernels.append(dict(
            name=name, route='cuda', source='paddle_tpu_torch/' + k.source,
            replaces=k.replaces, launches=sum(paths.values()),
            launches_by_path=paths,
            max_abs_err=max(r['max_abs_err'] for r in rs),
            ms=head['ms'], plain_ms=head['plain_ms'],
            bound_ms=head['bound_ms'], bound_by=head['bound_by'],
            library_ms=head['library_ms'], shape=head['shape'],
            **extra, cases=rs))
    log(json.dumps({'kernels': kernels}))
    log('[time] the whole script took %.1f s' % (time.perf_counter() - t_start))
    log(nvidia_smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
