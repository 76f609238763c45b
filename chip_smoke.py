#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (``src/repro_torch``) on NVIDIA
cards: the quickest proof that the port still builds, is right and trains.
One card is enough; with two or more it also drives the multi-card ring
phases.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:
  1. card     needs CUDA; prints the card's name and power limit
  2. build    compiles every CUDA kernel from the checkout (one nvcc per
              source, all started together; sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the training and serving paths give it (K5 also at
              a GQA, a windowed, an MLA and a peaked-softmax shape, at
              whisper's non-causal encoder and cross shapes, at a rank's
              10 heads of 128 in serve_tp's prefill, at its 8 heads of
              112 in serve_tp_hybrid's, at its 2 heads of 64 in
              serve_tp_audio's encoder and cross and at its 4 on 2 heads
              of 128 in serve_tp_vlm's); times
              the kernel, the plain version and a library yardstick beside
              the bound (K5: SDPA, the backend it picks named by its
              kernel; K5's plain version one request at a time where its
              whole (B·H, S, S) f32 scores would exceed 8 GB)
  4. slice    full-width ResNet-50 (224², 1000 classes, width 64), batch 64,
              6 LARS steps (poly2, label smoothing 0.1, bf16 compute, fp32
              masters, OptConfig(use_kernel=True)) through make_train_step +
              loop.train, comm='xla'; K1 must be launched twice a step
  5. context  one step with the norm kernel and one without, from one state
              and batch: the new params agree to 1e-5
  6. zero1    the same model and recipe as the ZeRO-1 explicit-DP step on a
              one-rank NCCL group (psum schedule, 4 MB buckets: 16, gather
              ahead, in-backward reduce-scatter, fused update): K2 must be
              launched once a step (one call over every bucket's p, g and
              m shards) and K1 once (one call over every bucket's p and g
              shards); an eval through make_params_reader
  7. zero1 context  one ZeRO-1 step (K1 + K2) and one replicated comm='xla'
              step (per-tensor norms, no kernel) from one state and batch:
              the masters agree to 1e-5 of each tensor's max
  8. durability  the zero1 path's step (K1 + K2) through loop.train at
              full width: a checkpoint after 2 steps with its CommPlan
              (verified, sha256, loaded back bit for bit; payload MB, save
              and load ms), reshard_buffers of the masters and momentum 4 MB
              / 1 -> 4 shards -> 1 MB plan -> 1 shard -> 4 MB bit-equal, an
              elastic resume from a 1 MB-plan checkpoint and a step; a
              guarded nan@2 run of 6 steps (one guard_skip) against the
              uninjected run, masters bit for bit under
              torch.use_deterministic_algorithms (or 1e-5 of the max, the
              op named, where one has no deterministic form), spike@3:1e4
              (a guard_rollback, finite losses); 3 traced steps (forward,
              backward, update, rs[b0..15] and ag[b0..15] in each step
              window of a valid Chrome JSON; the overlap gate: in each
              step the rs begins are non-decreasing in the order the
              backward reaches the groups, the reverse of the forward's
              first reads from a meta-device forward: b15 (the head's),
              b1 ... b14, b0 (the stem's), the first before the backward
              span's midpoint); the step ms unguarded,
              guarded and traced, interleaved, and a rollback snapshot's
              ms. K1 and K2 must read one launch a committed step call
              (none on a skipped one)
  9. cli      python -m repro_torch.launch.train --reduced on the card, as
              the replicated step and as ZeRO-1 (--comm ring --sharding
              zero1 --update-kernel); then on the ZeRO-1 run with
              --ckpt-every 1: kill@3 (SIGKILL) and a --resume-elastic rerun
              from step 3, sigterm@3 (drained, step 4 saved once, exit 0),
              stall@2:3 with --step-timeout-s 1 (watchdog_restore), and
              corrupt@2 with --metrics and --trace (the load falls back to
              step 1, every tag line in the JSONL, a valid Chrome trace)
 10. serve    full-width qwen1.5-0.5b (24 layers, d 1024, 16 heads of 64,
              vocab 151,936; bf16 params made leaf by leaf from pinit, as
              the serving CLI holds them) with flash_attention=True:
              serve.decode.generate on 8 prompts of 2048 tokens, 32 greedy
              tokens, cache_len 2088; the flash kernel (K5) must be launched
              24 times (once a layer, in the prefill); prints prefill ms,
              decode ms a token, tokens/s and peak memory
 11. serve context  from the same params and prompts: the K5 prefill's last
              logits against the chunked path's (no kernel), and one decode
              step from the K5 cache against the chunked full forward over
              prompt + that token, both within 3e-2 of the logit max
 12. serve cli  python -m repro_torch.serve.decode --reduced on the card,
              all started together: qwen1.5-0.5b, deepseek-v2-236b (MLA:
              K5 at Dk 48, Dv 32), zamba2-7b, whisper-base and
              internvl2-2b with --flash-attention, xlstm-125m without
 13. serve_moe  full-width, full-depth qwen2-moe-a2.7b (24 layers, d 2048,
              16 heads of 128, 60 routed experts padded to a stack of 64,
              top-4, 4 shared, vocab 151,936: 15.15 B params) served as
              the serve phase serves qwen1.5-0.5b, at its sizes: K5 must be
              launched 24 times (once a layer, in the prefill) and nothing
              else; prints the params, pinit's seconds, prefill ms, decode
              ms a token (median, p25, p75), tokens/s and peak memory
 14. serve_moe context  the serve context checks on it, within 3e-2, with
              the chunked runs on the K5 runs' expert choices (the two
              bf16 paths pick other experts for ~6% of token-layers, whose
              4th and 5th router probabilities lie within their rounding,
              and with capacity drop other tokens: the unpinned figures and
              the differing choices are printed beside); the decode check
              at capacity_factor 16 (prefill and full forward, as
              tests/test_serve.py: the full forward then drops no token
              over capacity, and decode never does)
 15. serve_qk  qwen3-14b at full width and depth (40 layers, d 5120, 40
              heads on 8 kv heads of 128, qk_norm, θ 1e6, vocab 151,936:
              14.77 B params), served at the serve phase's sizes (K5 40
              times, nothing else) and checked as in serve context
 15a. serve_nemo  mistral-nemo-12b at full width and depth (40 layers, d
              5120, 32 heads on 8 kv heads of 128, d_ff 14,336, vocab
              131,072, a sliding window of 131,072 tokens: 12.25 B
              params), served at the serve phase's sizes: K5 40 times (its
              window path, the window wider than the prompt), nothing else
 15b. serve_nemo context  the serve context checks on it within 3e-2
 16. serve_mla  deepseek-v2-236b at full width (MLA: d 5120, 128 heads, q/k
              heads of 128 + 64 rope, v heads of 128, a 512-d latent cache
              and a 64-d shared rope key; 160 routed experts of 1536,
              top-6, 2 shared; vocab 102,400), its depth cut to 4 of its
              60 layers (printed; 17.26 B params), served at the serve
              phase's sizes: K5 4 times (once a layer, at Dk 192 / Dv 128
              on 128 heads), nothing else; prints the serve line and the
              latent cache's bytes beside a GQA cache of the same heads
 17. serve_mla context  the serve context checks on it within 3e-2, the
              routing pinned as in serve_moe context; the decode check (an
              absorbed step from the K5 cache against the chunked,
              non-absorbed full forward) at the least capacity factor at
              which neither its prefill nor its full forward drops a
              choice (from the recorded choices, plus one token a request;
              printed), since 16 would need ~64 GB of expert buffers at
              this width
 18. serve_hybrid  zamba2-7b at full width and full depth (81 Mamba2
              layers: d 3584, 112 SSM heads of 64, state 64, conv 4, chunk
              64; the shared attention + SwiGLU block applied before each
              group of 6 layers, 14 times, 32 heads of 112, d_ff 14,336;
              vocab 32,000: 6.75 B params in the tree, 10.84 B by
              configs.param_count, printed) served at the serve phase's
              sizes: K5 14 times a prefill (once an application, at
              (112, 112)), nothing else; prints the serve line and the
              cache's bytes (the shared block's k and v, the Mamba states
              in f32 and the conv windows)
 19. serve_hybrid context  the serve context checks on it (the decode
              check: the recurrent Mamba step from the SSD prefill's
              states against the parallel full forward over prompt + that
              token) within 0.25 in bf16, where 95 blocks add up the two
              paths' roundings; then the same checks in f32 on 2 requests
              (the params cast up, the embedding kept in f32; K5's f32
              route) within 1e-4
 20. serve_xlstm  xlstm-125m at full width and depth (12 layers: mLSTM
              with sLSTM at layer 6; d 768, vocab 50,304) served at the
              same sizes: no attention, so no kernel (K5 0); prints the
              serve line and its states' bytes
 21. serve_xlstm context  the serve context checks on it within 3e-2 (its
              two prefills run the same path)
 22. serve_audio  whisper-base at full width and depth (6 encoder layers
              over 1,500 stub frames a request, 6 decoder layers with
              cross-attention, 8 heads of 64, vocab 51,865) served to 16
              requests of 1,500 frames and 128 prompt tokens, 64 greedy
              tokens (prompt + new under its 448-token decoder context):
              K5 18 times a prefill (the encoder's 6 non-causal 1,500 x
              1,500 self-attentions, the decoder's 6 causal ones and its 6
              cross-attentions of 128 queries over 1,500 keys), nothing
              else; prints the serve line and the self and cross caches'
              bytes
 23. serve_audio context  the serve context checks on it within 3e-2
 24. serve_vlm  internvl2-2b at full width and depth (24 layers, 16 query
              heads on 8 kv heads of 128, vocab 92,553; 256 stub patch
              embeddings through the stub projector ahead of each prompt)
              served to 8 requests of 256 patches + 1,792 tokens (2,048
              positions), 32 greedy tokens: K5 24 times a prefill, nothing
              else
 25. serve_vlm context  the serve context checks on it within 3e-2 (the
              decode step at position 2,048: the prefix counts)
 26. lm_train_moe  qwen2-moe-a2.7b at full width, its depth cut to 2 layers
              (printed; 1.83 B params), batch 2 x seq 4096 of lcg tokens,
              3 LARS steps with lm_train's recipe through make_train_step
              + loop.train, no eval: K4 once forward and once backward a
              step, K1 twice, finite losses and a positive aux (the
              router's load-balance loss, 0.01 of it in the loss); prints
              step ms, tokens/s, peak memory and the aux
 26a. lm_train_nemo  mistral-nemo-12b at full width, its depth cut to 4 of
              its 40 layers (2.43 B params), lm_train's recipe at batch 2
              x seq 4096, 3 steps with the state donated (the update in
              place), no eval: K4 1 + 1 and K1 2 a step, finite losses
 26b. lm_train_nemo context  lm_train context's checks on it (each step's
              new params moved to the host: four states do not fit)
 27. lm_train_hybrid  zamba2-7b at full width, its depth cut to 12 of its
              81 Mamba layers (2 applications of the shared block;
              printed; 1.37 B params), lm_train_moe's recipe and sizes: K4
              1 + 1 and K1 2 a step, finite losses; each Mamba layer
              recomputed in the backward (remat), the shared block not
 28. lm_train_xlstm  xlstm-125m whole, the same: K4 1 + 1 and K1 2 a step,
              finite losses (the sLSTM's backward through its 4,096-step
              time loop)
 29. lm_train_audio  whisper-base at full width and depth, batch 8 x (1,500
              stub frames + 448 tokens), lm_train_moe's recipe (remat: each
              encoder and decoder layer recomputed in the backward): K4 1 +
              1 (V 51,865) and K1 2 a step, finite losses
 30. lm_train_vlm  internvl2-2b at full width and depth, batch 2 x (256
              patches + 3,840 tokens), the same: K4 1 + 1 (V 92,553, the
              256 prefix rows IGNORE) and K1 2 a step, finite losses
 31. lm_train  full-width qwen1.5-0.5b (params from pinit; remat on, the
              chunked attention: flash_attention stays off in training),
              batch 2 x seq 4096 of lcg tokens, 5 LARS steps (poly2 with
              warm-up, label smoothing 0.1, OptConfig(use_kernel=True))
              through make_train_step + loop.train, then one eval: the
              smoothed cross-entropy kernel (K4) must be launched once
              forward and once backward a step and once for the eval, K1
              twice a step; prints step ms, tokens/s, peak memory, losses
 32. lm_train context  one step with the K4 loss and two with a loss built
              on K4's plain version, from one state and batch: losses to
              1e-5 relative, K4's gradient at the step's logits to rtol
              1e-5 / atol 1e-7, the plain steps bit for bit, new params to
              5e-2 of each tensor's largest update (bf16 gradients: not
              1e-5 of its max, the function says why)
 33. examples  the four twins of examples/*.py
              (repro_torch.examples.train_resnet_imagenet --steps 8,
              quickstart, serve_decode, large_batch_ablation --steps 4),
              each a subprocess on the card (this script with --example
              NAME: the module run as __main__, its counts read at its
              end), all started together: each exits 0 with finite losses
              and its final line; K4 60 + 60 (quickstart's steps), every
              other kernel 0
 34. report   python -m repro_torch.launch.report --section comm,
              autotune and shard (the H100's constants named in each
              heading) and --section trace over the durability phase's
              Chrome trace: every rs[b*] row starts inside its step's
              backward row
 35. ring     on two or more cards (min(count, 4) ranks, one card each,
              over NCCL: this script under torch.distributed.run with
              --ring-rank), full-width ResNet-50, batch 64 a card, the slice's
              recipe, CommConfig(use_kernel=True, update_kernel=True), 3
              steps each through make_train_step + loop.train: ring
              replicated, zero1, zero2 and zero3 (per_group) on (data n,
              model 1), and on four cards ring, hierarchical, 2d_torus and
              dbtree on (pod 2, data 2). The ring-step kernel (K3) must fold
              16 x (ranks - 1) times a step along each ring axis (48 on data
              4; 32 for ring and 2d_torus, 16 for hierarchical on the pod
              mesh, 0 for dbtree), K1 twice a replicated step and once a
              sharded one, K2 once a sharded step; prints step ms
              (median after the first step), images/s over all cards and
              peak memory per rank
 36. ring context  one packed bf16 gradient through the ring all-reduce and
              every schedule's reduce-scatter form, with K3 and with the
              plain fold: bit-equal (counted apart for the forms that fold
              through K3: ring, hierarchical, 2d_torus); with f32 wire, every schedule and rung
              against the replicated psum step from one state and batch:
              masters within 1e-5 of each tensor's max
 37. lm_ring  on four cards (this script under torch.distributed.run with
              --lm-ring-rank, one rank a card, NCCL): the card's link
              (alpha, beta of a ring exchange), HBM and bf16 matmul rates
              measured (launch/hw.measure) and held within 2x of
              launch/hw.py's; full-width qwen1.5-0.5b (remat, the chunked
              attention), batch 2 x seq 4096 a card, lcg tokens, LARS poly2,
              OptConfig(use_kernel=True), 4 MB buckets (224, 222 split
              spans): psum replicated (the anchor), ring replicated with
              K3, ring zero1 with K3 and K2, ring zero3 per_group with K3
              and K2, each one warm-up step on a copy of its state and 2
              timed steps through make_train_step + loop.train; K3 672
              folds a ring step, K1 2 a replicated step and 1 a sharded
              one, K2 1 a sharded step, K4 1 + 1 (2 + 1 under zero3's
              checkpointed loss); every configuration's masters within
              5e-2 of the anchor's largest update; prints step ms,
              tokens/s over the cards and peak memory a rank; ring zero1's
              state saved (every rank's rows gathered, rank 0 writing).
              Then bucket_mb='auto' with backward_profile='measured' on
              ring zero1, for the LM and for ResNet-50 (batch 64 a card):
              the chosen bucket size, the simulated and the measured step
              time, and obs.drift's measured / predicted per span kind
              over 3 traced steps; the profile must be the measured one;
              ResNet-50's must stamp under half of its groups in the
              backward's last tenth, and its rs spans begin inside the
              backward span (the LM's stacked leaves fire late: no gate)
 38. lm_ring resume  the four-card ring zero1 checkpoint resumed on one
              card (elastic.load_resharded, 4 -> 1 shards over the LM's
              split-leaf plan): masters bit-equal to the gathered rows
              (sha256), then one step with a finite loss (K1, K2, K4).
              Phases 35-38 alone: python3 chip_smoke.py --ring
 39. lm_ring_families  on four cards (this script under
              torch.distributed.run with --lm-ring-families-rank, one rank
              a card, NCCL): the families added since qwen1.5-0.5b on the
              explicit ladder at full width, lm_ring's recipe and 4 MB
              buckets, LM_FAMILY_STEPS steps each through make_train_step
              + loop.train from init_state (the first step the warm-up):
              xlstm-125m whole under psum (2 x 4,096 a rank; traced: its
              ar spans must begin in the order the backward reaches their
              groups, the first before the backward's midpoint: its
              per-layer leaves reduce inside the backward), whisper-base
              (8 x (1,500 frames + 448 tokens)) and internvl2-2b (2 x (256
              + 3,840)) whole under psum and ring zero1, zamba2-7b at
              HYBRID_TRAIN_LAYERS layers under psum and ring zero3
              (per_group), then at all 81 under ring zero3 at
              HYBRID_RING_BATCH a rank (its state made leaf by leaf, no
              full tree on a card). Each run: finite losses, K1-K4 against
              _lm_ring_want's counts for its buckets, every rank's masters
              sha256 equal, step ms, tokens/s over the cards, peak memory
              a rank; a second configuration's masters within 5e-2 of its
              psum anchor's largest update. Then the CLI on four ranks:
              python -m torch.distributed.run --nproc-per-node 4 -m
              repro_torch.launch.train --arch whisper-base --comm ring
              --sharding zero1 --steps 3 must exit 0 with its run_stop
              line. Every run is traced: its last step's forward,
              backward and update spans and its collectives' spans by
              kind are printed, with the allocator's peak reserved bytes
              and retries. Alone: python3 chip_smoke.py
              --lm-ring-families [ARCH ...] (only those archs' runs, no
              CLI)
 40. serve_tp, lm_train_tp  the model axis (ROADMAP §1 item 6.2) on four
              cards (this script under torch.distributed.run with
              --tp-rank, one rank a card, NCCL). serve_tp: qwen1.5-32b at
              full width and depth (64 layers, d 5,120, 40 heads of 128,
              d_ff 27,392, vocab 152,064, QKV bias: 35.2 B params, no one
              card holds them) over the (data 1, model 4) mesh, each
              rank's bf16 shards made by pinit (each split leaf drawn once,
              on its owner's host, and scattered), flash_attention=True,
              generate(mesh=) on 8 prompts of 2,048 tokens, 32 greedy
              tokens: K5 64 times a rank (once a layer, on its 10 heads),
              nothing else; 2 all-reduces a layer a prefill; finite
              logits, every rank's tokens equal; prints pinit s, prefill
              ms, decode ms a token, tokens/s, peak memory a rank; then at
              4 of its 64 layers, model 4 against model 1 on rank 0's card
              (the shards gathered): prefill logits within 3e-2 of their
              max and 8 greedy tokens within the tests' greedy rule at that
              margin. lm_train_tp: qwen1.5-0.5b at full width and depth
              over the (data 2, model 2) mesh (its tied embedding splits
              the vocabulary), comm='xla', remat, LARS with K1, 1 x 4,096
              tokens a data rank, 3 steps: K4 1 + 1 and K1 2 a step;
              against the one-card comm='xla' step at the global batch of
              2 x 4,096 from the same values: losses within 4e-4
              relative, masters within 5e-2 of each tensor's largest
              update.
 41. serve_tp_hybrid, lm_train_tp_xlstm, resnet_xla  ROADMAP §1 item
              6.2b on the same four ranks. serve_tp_hybrid: zamba2-7b at
              full width and depth (81 Mamba2 layers, the shared block 14
              times: 6.75 B params) at model 4 (a rank: 28 of 112 SSM
              heads, 8 of 32 attention heads of 112), bf16, flash, 8
              prompts of 2,048 tokens, 32 new: K5 14 times a rank, 190
              all-reduces and 2 all-gathers a prefill, every rank's tokens
              equal; then model 4 against model 1 on rank 0's card: in f32
              at 12 layers (2 applications) on 2 requests within 1e-4 of
              the logit max (the gate; K5's f32 route 2 launches) and at
              full depth in bf16 within 0.25 (a sanity bound), prefill and
              one decode step. lm_train_tp_xlstm: xlstm-125m whole at
              (data 2, model 2), wholly in f32, LARS with K1, 1 x 1,024
              tokens a data rank, 2 steps: K4 1 + 1 and K1 2 a step;
              each step against the one-card step from the same input
              state on the same global batch: losses within 1e-5
              relative, masters within 5e-4 of each tensor's largest
              update (the one card's own trajectory printed beside).
              resnet_xla: ResNet-50 at full width under comm='xla' on
              (data 4, model 1), LARS with K1, 64 images a rank, 3 steps,
              in each sync_bn form, its residual branches damped (the last
              BN scale 0.1): every rank's masters, momentum and BN state
              the same bits; step 1 against the one-card step on the same
              256 images: loss within 1e-3 relative, new BN statistics
              within 2e-3 of their max, the median tensor's update within
              0.5 relative L2 (a sanity bound: chaotic bf16); one step
              from pinit's undamped state and the four ranks on the same
              64 images printed beside; the median step time beside the
              ring's. Then the CLI's
              main() in each rank's process: --model-parallel 2 --comm
              xla with qwen1.5-0.5b and with zamba2-7b --reduced, and
              --arch resnet50 --comm xla: run_stop on every rank.
 42. ckpt_tp, serve_tp_audio, serve_tp_vlm, lm_train_tp_frames  ROADMAP
              §1 item 6.2c (and fault 3.7's repair) on the same four ranks.
              ckpt_tp: lm_train_tp's model and recipe at (data 2, model 2),
              2 steps through loop.train with a checkpoint a step: every
              leaf of the committed file whole, its per-key sha256 the
              state's gathered whole on rank 0; a resume at (2, 2) for
              step 3 bit-equal to an uninterrupted run under
              torch.use_deterministic_algorithms (1e-5 of the max where an
              op has no deterministic form, named); the file loaded at (1,
              4) and (4, 1), gathered bit-equal to it, and a finite step on
              each; payload MB, save and load ms. serve_tp_audio:
              whisper-base at full width and depth, its vocabulary alone
              cut to 51,864 (an odd V cannot be split over model > 1, in
              either package; printed), model 4, 16 x (1,500 frames + 128
              tokens), 64 new: K5 18 a rank, 30 all-reduces and 2
              all-gathers a prefill, 18 and 2 a decode step, every rank's
              tokens equal; then model 4 against model 1 on rank 0's card:
              prefill logits within 3e-2 of their max and 8 greedy tokens
              by the tests' rule at that margin. serve_tp_vlm: internvl2-2b
              (V cut to 92,552), 8 x (256 + 1,792), 32 new: K5 24 a rank,
              48 and 2 a prefill and a decode step, the same checks (the
              decode at position 2,048). lm_train_tp_frames: whisper-base
              (4 x (1,500 + 448) a data rank) and internvl2-2b (1 x (256 +
              3,840)), each cut as above, at (data 2, model 2) as
              lm_train_tp (K4 3 + 3, K1 6 a run; against the one-card
              step: losses 4e-4, masters 5e-2). The cli phase then also
              runs --model-parallel 2 --ckpt-dir --ckpt-every 1 with
              qwen1.5-0.5b, its --resume-elastic at --model-parallel 4
              (restored step 2, run_stop on every rank) and whisper-base
              --reduced at --model-parallel 2. Alone: python3 chip_smoke.py
              --tp [PHASE ...] (with K5 at TP_K5_SHAPES; the phases of
              TP_PHASES named, all by default; its last lines the card's
              and the ok line)
 43. serve_tp_moe, lm_train_tp_moe  ROADMAP §1 item 6.3's experts on the
              same four ranks (the constants above TP_MOE_DEEP_LAYERS say
              what each runs)
 44. serve_tp_mla, lm_train_tp_mla  item 6.3's MLA part on the same four
              ranks. serve_tp_mla: deepseek-v2-236b at full width, its
              depth cut to 8 of 60 layers (33.39 B params, 8.41 B a rank:
              32 of its 128 MLA heads, 40 of its 160 experts; the latent
              cache whole on every rank), model 4, flash, 8 prompts of
              2,048 tokens, 32 new: K5 8 times a rank (once a layer, on
              its 32 heads at Dk 192 / Dv 128), nothing else; 24
              all-reduces, 10 all-gathers and 16 all_to_alls a prefill,
              24 all-reduces and 2 all-gathers a decode step; every rank's
              tokens equal; then its context at 4 layers as serve_tp_moe's
              (one card chunked alike, on the ranks' expert choices).
              lm_train_tp_mla: one layer at full width (5.09 B params),
              fsdp off, (data 2, model 2), 1 x 1,024 tokens a data rank,
              remat, 3 steps, the state donated: K4 1 + 1 and K1 2 a
              step; against the one-card step (donated too) at the global
              batch with the MoE layer chunked alike: losses 4e-4,
              masters 5e-2 of the update, the replicated masters the same
              bits on every rank. Alone: python3 chip_smoke.py --tp
              serve_tp_mla lm_train_tp_mla
On one card the ring phases print that they need two or more cards and
were not run, and K3's launches_by_path has "ring": null; with fewer than
four, lm_ring, its resume, lm_ring_families and the model-axis phases
are not run and every kernel's launches_by_path has "lm_ring",
"lm_resume", "lm_ring_families", "serve_tp", "lm_train_tp",
"serve_tp_hybrid", "lm_train_tp_xlstm", "resnet_xla", "ckpt_tp",
"serve_tp_audio", "serve_tp_vlm", "lm_train_tp_frames", "serve_tp_moe",
"lm_train_tp_moe", "serve_tp_mla" and "lm_train_tp_mla" null. The kernels
phase also holds K1's multi-buffer form (the sharded step's one call)
against its plain version at the 4 MB and 0.25 MB plans' shards, K2's
(the sharded step's one update call) against its plain version and, bit
for bit, against its per-bucket launches at the 4 MB plan on 1 and 4
shards and the 0.25 MB plan on 3 (every rank), timing it at 1 and 4
shards beside the per-bucket launches and one launch over the shards
concatenated, K1's and K2's one call at the four-card LM step's shard
site (qwen1.5-0.5b's 224 buckets on 4 shards, rank 0: two launches
inside each call), K1 at both sharded sites beside torch._foreach_norm
over the same per-tensor views, K4, forward and backward, against its plain version (at the path's shape in
f32 and bf16, at T 16 x V 333, and with IGNORE labels), beside
F.cross_entropy, and K3, bit for bit, at the ring's chunk rows (the
path's largest and smallest on 4 and 2 ranks, bf16 and f32, every k, by
the wrapper and by the fold the ring binds once a bucket), the
reference's shapes, ragged rows, misaligned views and in place, beside
torch.add; the cli phase also trains the reduced LM. Every
kernel's launch count is set to 0 just before each path (slice, zero1,
durability, serve, serve_moe, serve_qk, serve_nemo, serve_mla,
serve_hybrid, serve_xlstm, serve_audio, serve_vlm, lm_train_moe,
lm_train_nemo, lm_train_hybrid, lm_train_xlstm, lm_train_audio,
lm_train_vlm, lm_train,
each ring
and lm_ring configuration and autotune run, the lm_ring resume) and read
just after: a kernel the path
runs must show its count, every other kernel 0, and the JSON
line's launches_by_path holds these readings (examples: the four twins'
subprocesses, summed).
Then each phase's seconds, one JSON line with every kernel's numbers, the
card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``.
"""
import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

# cuBLAS is deterministic only with a fixed workspace, which must be set
# before it first runs: the durability phase replays runs bit for bit under
# torch.use_deterministic_algorithms
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s, f32
#: operations/s outside the tensor cores (K1 and K2 square and add in f32;
#: K5 on f32 inputs), and the bf16 dense tensor-core rate (K5 on bf16
#: inputs: the least time any kernel could take for that work)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

BATCH, STEPS = 64, 6

#: K5 shapes: (name, B, S, H, K, Dk, Dv, window, dtype, q scale[, causal
#: (default True)[, Sk (default S)]]). "path" is the serving prefill's
#: (qwen1.5-0.5b, 8 x 2048 tokens);
#: "serve_moe", "serve_qk", "serve_mla" and "serve_hybrid" the prefills of
#: qwen2-moe-a2.7b (16 heads of 128), qwen3-14b (40 query heads on 8 kv
#: heads of 128), deepseek-v2-236b (128 heads, q/k 128 + 64 rope, v 128)
#: and zamba2-7b's shared block (32 heads of 112) at the same sizes; then the path in f32, qwen3-14b's GQA heads without and with a
#: window, MLA's dims, and the path's heads with q x 8 (a peaked softmax:
#: large corrections of the running max, P near 0 or 1); then whisper-base's
#: prefill (serve_audio: the encoder's non-causal 1,500 x 1,500 and the
#: cross-attention's 128 queries over 1,500 keys, 8 heads of 64) and
#: internvl2-2b's (serve_vlm: 16 heads on 8 kv heads of 128 over 2,048
#: positions); then a rank's launch in qwen1.5-32b's prefill at model 4
#: (serve_tp: 10 of its 40 heads of 128), in zamba2-7b's at model 4
#: (serve_tp_hybrid: 8 of its 32 heads of 112), in whisper-base's at model
#: 4 (serve_tp_audio: 2 of its 8 heads of 64, encoder and cross), in
#: internvl2-2b's (serve_tp_vlm: 4 query heads on 2 kv heads of 128) and
#: in qwen2-moe-a2.7b's (serve_tp_moe: 4 of its 16 heads of 128); then
#: mistral-nemo-12b's prefill (serve_nemo: 32 query heads on 8 kv heads of
#: 128, its 131,072-token window wider than the prompt) and a rank's launch
#: in deepseek-v2-236b's at model 4 (serve_tp_mla: 32 of its 128 heads, q/k
#: 192, v 128)
FLASH_SHAPES = (("path", 8, 2048, 16, 16, 64, 64, 0, "bfloat16", 1),
                ("serve_moe", 8, 2048, 16, 16, 128, 128, 0, "bfloat16", 1),
                ("serve_qk", 8, 2048, 40, 8, 128, 128, 0, "bfloat16", 1),
                ("serve_mla", 8, 2048, 128, 128, 192, 128, 0, "bfloat16", 1),
                ("serve_hybrid", 8, 2048, 32, 32, 112, 112, 0, "bfloat16",
                 1),
                ("path_f32", 8, 2048, 16, 16, 64, 64, 0, "float32", 1),
                ("gqa", 2, 1024, 40, 8, 128, 128, 0, "bfloat16", 1),
                ("gqa_window", 2, 1024, 40, 8, 128, 128, 256, "bfloat16", 1),
                ("mla", 2, 1024, 16, 16, 192, 128, 0, "bfloat16", 1),
                ("peaked", 2, 2048, 16, 16, 64, 64, 0, "bfloat16", 8),
                ("serve_audio_enc", 16, 1500, 8, 8, 64, 64, 0, "bfloat16",
                 1, False),
                ("serve_audio_cross", 16, 128, 8, 8, 64, 64, 0, "bfloat16",
                 1, False, 1500),
                ("serve_vlm", 8, 2048, 16, 8, 128, 128, 0, "bfloat16", 1),
                ("serve_tp", 8, 2048, 10, 10, 128, 128, 0, "bfloat16", 1),
                ("serve_tp_hybrid", 8, 2048, 8, 8, 112, 112, 0, "bfloat16",
                 1),
                ("serve_tp_audio_enc", 16, 1500, 2, 2, 64, 64, 0,
                 "bfloat16", 1, False),
                ("serve_tp_audio_cross", 16, 128, 2, 2, 64, 64, 0,
                 "bfloat16", 1, False, 1500),
                ("serve_tp_vlm", 8, 2048, 4, 2, 128, 128, 0, "bfloat16", 1),
                ("serve_tp_moe", 8, 2048, 4, 4, 128, 128, 0, "bfloat16", 1),
                ("serve_nemo", 8, 2048, 32, 8, 128, 128, 131_072,
                 "bfloat16", 1),
                ("serve_tp_mla", 8, 2048, 32, 32, 192, 128, 0, "bfloat16",
                 1))
#: K5's route for each input dtype
FLASH_ROUTES = {"bfloat16": "tensor cores: mma.sync m16n8k16 bf16, P split "
                            "into bf16 hi + mid + lo, the scale after the "
                            "row max, cp.async K/V tiles",
                "float32": "CUDA cores: f32 FMA"}
#: (rtol, atol) of K5 against its plain version: f32 sums in another order;
#: in bf16 that may flip the output's rounding by one ulp (2^-7 relative)
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-5)}
#: K5's plain version materialises (B·H, S, S) f32 scores and about three
#: more of their size: past this many bytes of scores (serve_mla's 17.2
#: GB) it runs one request at a time, its B·H rows cut into B slices
FLASH_PLAIN_WHOLE_BYTES = 8e9
#: SDPA's backends, by a substring of the kernel it launches (first match)
SDPA_BACKENDS = (("cudnn", "cudnn"), ("flash", "flash"),
                 ("fmha", "efficient"), ("efficient", "efficient"))

#: the ring phases: steps a configuration, and their time limit
RING_STEPS = 3
RING_TIMEOUT_S = 420

#: K3's ragged (n, length) pairs: the reference's own ring-kernel test
#: (tests/test_comm.py), through the ring's zero-padded chunk view
RING_RAGGED = ((2, 1000), (3, 5000), (4, 4096), (8, 33000))

#: the serving path: 8 requests, 2048-token prompts, 32 new tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
SERVE_CACHE = SERVE_PROMPT + SERVE_NEW + 8
#: K4 shapes: (name, T, V, dtype, IGNORE labels). "path" is the LM
#: training step's loss (2 x 4096 tokens of qwen1.5-0.5b's vocabulary, f32
#: logits); then the same in bf16, the reference test's ragged (16, 333),
#: and 1,024 path-width rows with every third label IGNORE
XENT_SHAPES = (("path", 8192, 151_936, "float32", False),
               ("path_bf16", 8192, 151_936, "bfloat16", False),
               ("ragged", 16, 333, "float32", False),
               ("ignore", 1024, 151_936, "float32", True))
#: (rtol, atol) of K4 against its plain version: the forward at the
#: reference's own tolerances (test_kernels.py); the backward against
#: autograd of the plain version, and one bf16 ulp where dx is bf16. The
#: backward's atol is per unit of the row's upstream gradient g (see
#: ``_dx_close``)
XENT_FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
XENT_BWD_TOL = {"float32": (1e-5, 1e-7), "bfloat16": (1e-2, 1e-7)}
#: f32 operations a logit: max, subtract, exp, add to the sum-exp, add to
#: the plain sum (forward); subtract, exp, two subtractions, multiply
#: (backward)
XENT_OPS = 5

#: the LM training path: the assigned train_4k sequence, its 256-sequence
#: global batch cut to one card's share
LM_BATCH, LM_SEQ, LM_STEPS = 2, 4096, 5
LM_LR = 4.0
#: K4 loss vs the plain version's, as the ResNet context checks hold
#: theirs; the new params against the update (check_lm_train_in_context
#: says why not against the tensor's max): about four times the 1.3e-2
#: measured on the H100
LM_CONTEXT_TOL = 1e-5
LM_UPDATE_TOL = 5e-2

#: the durability phase: steps of each run, the interleaved timing rounds,
#: snapshot timings, and the spike's magnitude (a grad-norm far past the
#: detector's 10x EMA)
DUR_STEPS, DUR_ROUNDS, DUR_SNAPSHOTS = 6, 8, 5
DUR_SPIKE = "spike@3:1e4"
#: the determinism rule's fallback: where an op of the path has no
#: deterministic form, a replayed run is held to 1e-5 of a tensor's max,
#: the gate check_zero1_in_context uses
DUR_TOL = 1e-5


#: the four-card LM phase (lm_ring): full-width qwen1.5-0.5b, batch
#: LM_BATCH x LM_SEQ a card, 4 MB bf16 buckets (224 of them, 222 split
#: spans), each configuration (schedule, sharding, gather) one warm-up
#: step on a copy of its state, then LM_RING_STEPS timed steps; psum
#: replicated is the anchor the others' masters are held against
LM_RING_CONFIGS = (("psum", "replicated", None),
                   ("ring", "replicated", None),
                   ("ring", "zero1", None),
                   ("ring", "zero3", "per_group"))
LM_RING_STEPS = 2
LM_RING_BUCKETS = 224
LM_RING_TIMEOUT_S = 600
LM_CKPT_TAG = "lm_zero1"
#: the card's constants measured in the phase against launch/hw.py's: a
#: figure more than this factor off fails
HW_TOL = 2.0

#: K5 prefill vs chunked prefill, and decode vs the full forward: two bf16
#: paths that round in different places, held to the reference's own bound
#: for decode against the full forward (tests/test_serve.py)
SERVE_TOL = 3e-2
#: serve_hybrid context: zamba2-7b's 81 Mamba layers and 14 shared-block
#: applications add up the two bf16 paths' rounding differences block by
#: block, about as the square root of the depth
#: (tools/hybrid_depth_rounding.py shows it on the CPU at the reduced
#: width), so its bf16 figures are held only to this sanity bound; the
#: correctness gate is the same checks in f32, where the paths differ by
#: the order of f32 sums at any depth, within SERVE_F32_TOL
#: (check_serve_f32)
HYBRID_SERVE_TOL = 0.25
#: check_serve_f32: its bound and the requests it takes
SERVE_F32_TOL, SERVE_F32_REQUESTS = 1e-4, 2
#: a MoE model's decode check runs at this capacity factor, as
#: tests/test_serve.py does: the full forward then drops no token
SERVE_MOE_CF = 16.0
#: serve_qk: qwen3-14b at full width and all of its 40 layers (14.77 B
#: params, 29.5 GB in bf16: one card holds it whole)
QK_LAYERS = 40
#: lm_train_nemo: mistral-nemo-12b at full width, its 40 layers cut to
#: these (2.43 B params: fp32 masters and momentum 19.5 GB, the bf16 copy
#: and gradients 9.7 GB; PERF.md §4 reckons the rest), trained for these
#: steps with the state donated, its first state kept on the host for the
#: context check
NEMO_TRAIN_LAYERS, NEMO_TRAIN_STEPS = 4, 3
#: serve_mla: deepseek-v2-236b at full width, its 60 layers cut to these
#: (17.26 B params, 34.5 GB in bf16: one card, and pinit ~1 min)
MLA_LAYERS = 4
#: lm_train_moe: qwen2-moe-a2.7b at full width, its 24 layers cut to these
#: (1.83 B params: fp32 masters, momentum, bf16 copy and gradients ~26 GB),
#: trained for these steps
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
#: lm_train_hybrid: zamba2-7b at full width, its 81 Mamba layers cut to
#: these (2 groups of the shared block; 1.37 B params, ~19 GB of f32
#: masters, momentum and gradients), and lm_train_xlstm: xlstm-125m whole;
#: both trained for these steps
HYBRID_TRAIN_LAYERS, RECURRENT_TRAIN_STEPS = 12, 3
#: the serve CLI's runs: (arch, extra flags), each --reduced
SERVE_CLI = (("qwen1.5-0.5b", ("--flash-attention",)),
             ("deepseek-v2-236b", ("--flash-attention",)),
             ("zamba2-7b", ("--flash-attention",)),
             ("xlstm-125m", ()),
             ("whisper-base", ("--flash-attention",)),
             ("internvl2-2b", ("--flash-attention",)))
#: serve_audio: whisper-base's requests (1,500 stub frames each), prompt
#: and new tokens (prompt + new stay under its 448-token decoder context);
#: serve_vlm: internvl2-2b's, their 256-patch prefix ahead of the prompt
#: (2,048 positions)
AUDIO_SERVE = (16, 128, 64)
VLM_SERVE = (8, 1792, 32)
#: lm_train_audio and lm_train_vlm: (batch, tokens) a step; whisper's 448
#: tokens its decoder context, the VLM's 3,840 + its 256-patch prefix the
#: train_4k sequence
AUDIO_TRAIN = (8, 448)
VLM_TRAIN = (2, 3840)

#: the four-card LM families phase (lm_ring_families), in order: (arch,
#: layers or None for the whole depth, (batch, tokens) a rank, its
#: configurations, the first of two the psum anchor); each run
#: LM_FAMILY_STEPS steps, the first the warm-up. zamba2-7b at its full
#: depth takes HYBRID_RING_BATCH sequences of 4,096 tokens a rank, the
#: larger of 2 and 1 that fits: a rank of four holds 13.5 GB of master and
#: momentum shards, and at the backward's end the 13.5 GB bf16 tree it
#: gathered again, ~13 GB of the stacked leaves' bf16 gradients, 6.75 GB
#: of fp32 gradient shards and ~6 GB of the activations the model's remat
#: keeps at 2 sequences: ~55-65 GB (the reckoning in PERF.md §6)
HYBRID_RING_BATCH = 2
LM_FAMILY_RUNS = (
    ("xlstm-125m", None, (LM_BATCH, LM_SEQ), (("psum", "replicated", None),)),
    ("whisper-base", None, AUDIO_TRAIN, (("psum", "replicated", None),
                                         ("ring", "zero1", None))),
    ("internvl2-2b", None, VLM_TRAIN, (("psum", "replicated", None),
                                       ("ring", "zero1", None))),
    ("zamba2-7b", HYBRID_TRAIN_LAYERS, (HYBRID_RING_BATCH, LM_SEQ),
     (("psum", "replicated", None), ("ring", "zero3", "per_group"))),
    ("zamba2-7b", None, (HYBRID_RING_BATCH, LM_SEQ),
     (("ring", "zero3", "per_group"),)))
LM_FAMILY_STEPS = 3
LM_FAMILY_TIMEOUT_S = 900
#: the phase's CLI run on four ranks, after the configurations
LM_FAMILY_CLI = ("--arch", "whisper-base", "--comm", "ring", "--sharding",
                 "zero1", "--steps", "3")


#: what one phase leaves for a later one: the durability phase's trace,
#: for the report phase
_RESULTS = {}


#: each phase's seconds, in the order run (``phase`` closes the previous
#: one's)
_PHASE_S = {}
_PHASE = [None, 0.0]


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str = None):
    """Start phase ``name`` (None: end the last one), recording the
    previous phase's seconds."""
    now = time.perf_counter()
    if _PHASE[0] is not None:
        _PHASE_S[_PHASE[0]] = round(now - _PHASE[1], 1)
    _PHASE[:] = [name, now]
    if name is not None:
        print(f"== {name}", flush=True)


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Device time per call from CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50):
    """Device time per call with the host's cost hidden: a sleep kernel
    holds the stream while the host queues ``iters`` calls, then CUDA
    events time them back to back on the device. None where the device
    caught up with the host before the last call was queued (the time
    would hold host gaps)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000 * iters)      # ~1 ms a call at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    hidden = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if hidden else None


def host_us(fn, iters: int = 20000) -> float:
    """Host time per call in microseconds, for calls that do no device
    work."""
    for _ in range(100):
        fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) / iters * 1e6


def bound_ms(bytes_moved: int, ops: int, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _zero(*wrappers):
    for w in wrappers:
        w.launches = 0


def _counters():
    """Every kernel's wrapper, under the key of its entry in the kernels
    line; each adds one to its own ``launches`` where it launches."""
    from repro_torch.comm import ring_kernel
    from repro_torch.kernels import batched_norm, lars_update
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import smoothed_xent as sx
    return {"k1": batched_norm.batched_sumsq,
            "k2": lars_update.lars_packed_update,
            "k3": ring_kernel.ring_add_step,
            "k4": sx.smoothed_xent_rows_forward,
            "k4_bwd": sx.smoothed_xent_rows_backward,
            "k5": fa.flash_attention}


def _read_path(path: str, want: dict) -> dict:
    """Every kernel's launches, read just after a path's run (its counts
    were set to 0 just before it); fails unless each equals ``want``, where
    a kernel it does not name must not have launched."""
    return _check_counts(path, {key: w.launches for key, w in
                                _counters().items()}, want)


def _check_counts(path: str, got: dict, want: dict) -> dict:
    """``got`` (every kernel's launches on a path) against ``want``, where
    a kernel it does not name must read 0."""
    want = {key: want.get(key, 0) for key in got}
    if got != want:
        fail(f"{path}: launches {got}; the path must launch {want}")
    return got


def _segment_views(bufs, segs) -> list:
    """Each shard's per-tensor views: the runs of one id in its CHUNK
    segment map (padding repeats a bucket's last id, so the views cover
    every element K1 reads), for ``torch._foreach_norm`` over the same
    segments as K1's one call."""
    from repro_torch.core.bucketing import CHUNK
    views = []
    for x, seg in zip(bufs, segs):
        ids = seg.tolist()
        start = 0
        for i in range(1, len(ids) + 1):
            if i == len(ids) or ids[i] != ids[start]:
                views.append(x[start * CHUNK:i * CHUNK])
                start = i
    return views


def _one_rank():
    """A one-rank shard axis with no process group, for the kernel
    checks."""
    from repro_torch.launch.mesh import Axis
    return Axis("data", 1, 0, (0,), None)


def _shard_case(plan, n_shards, k, dev, gen):
    """Rank-k bucket shards of p, g, m at ``plan``'s shapes, the shard
    segment maps of each bucket and of all (the call site's), and the
    trust ratios from K1 (as the ZeRO-1 path makes them)."""
    import torch
    from repro_torch.core import bucketing, lars
    sizes = bucketing.shard_sizes(plan, n_shards)
    draw = lambda s: [s * torch.randn(c, generator=gen, device=dev)
                      for c in sizes]
    p, g, m = draw(1.0), draw(0.01), draw(0.001)
    segs, seg_all = lars._shard_maps(plan, n_shards, k, dev)
    trust = lars.shard_trust_ratios(p, g, seg_all, plan, lars.OptConfig(),
                                    shard_axis=_one_rank())
    return p, g, m, segs, seg_all, trust


#: K2's call site, (name, bucket_mb, shards): (a) the main path's, the
#: full-width 4 MB plan on one shard; (b) the 0.25 MB plan on 3 shards
#: (tensors split across buckets, padding chunks, 211 buckets: two
#: launches in the one call); (c) the 4 MB plan on 4 shards, a four-card
#: rank's shards, measured on one card. Every rank k of each
K2_SITES = (("a", 4.0, 1), ("b", 0.25, 3), ("c", 4.0, 4))
#: rounds of K2's timings, the variants in turns within each round
K2_ROUNDS = 3


def check_lars_update(dev):
    """K2 at the sharded step's call site, at K2_SITES' shapes with real
    segment maps and trust values from K1: the one call over every
    bucket's shards (``lars_packed_update_multi``, in place) against its
    plain version (rtol 1e-5, atol 1e-6), bit for bit against the
    per-bucket launches it replaces, in place, and equal across two calls;
    each per-bucket launch also against its plain version, in place and
    twice. Times, in turns at (a) and (c): the one launch, the 16
    per-bucket launches, the single-buffer launch over the shards
    concatenated, and the plain version; the three launch forms again on
    the device alone (``device_ms``); and K1 at its call site on (a)'s
    shards both ways: the one call of the step (``batched_sumsq_multi``)
    and the 32 per-bucket calls it replaced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.kernels import batched_norm, lars_update, ref
    from repro_torch.models import resnet

    pd = resnet.resnet_pd(get_config("resnet50"))[0]
    plan = bucketing.make_plan(pd)
    if plan.n_buckets != 16:
        fail(f"the full-width plan has {plan.n_buckets} buckets, not 16")
    gen = torch.Generator(device=dev).manual_seed(1)
    lr = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, wd=5e-5)
    worst_abs, worst_rel = 0.0, 0.0

    def close(got, want, what):
        nonlocal worst_abs, worst_rel
        for x, y in zip(got, want):
            if not torch.allclose(x, y, rtol=1e-5, atol=1e-6):
                fail(f"{what} disagrees with its plain version (rtol 1e-5, "
                     f"atol 1e-6)")
            d = (x - y).abs()
            worst_abs = max(worst_abs, d.max().item())
            worst_rel = max(worst_rel, (d / y.abs().clamp_min(1e-30))
                            .max().item())

    def check(p, g, m, trust, seg, what):
        what = f"lars_packed_update {what}"
        got = lars_update.lars_packed_update(p, g, m, trust, seg, **kw)
        want = ref.lars_packed_update(p, g, m, trust, seg, **kw)
        again = lars_update.lars_packed_update(p, g, m, trust, seg, **kw)
        pin, min_ = p.clone(), m.clone()
        lars_update.lars_packed_update(pin, g, min_, trust, seg,
                                       inplace=True, **kw)
        torch.cuda.synchronize()
        close(got, want, what)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{what}: two calls differ")
        if not (torch.equal(pin, got[0]) and torch.equal(min_, got[1])):
            fail(f"{what}: in place differs")
        return got

    def check_multi(p, g, m, segs, seg_all, trust, what):
        what = f"lars_packed_update_multi {what}"
        per = [check(p[b], g[b], m[b], trust, segs[b], f"{what} bucket {b}")
               for b in range(len(p))]
        clone = lambda xs: [x.clone() for x in xs]
        runs = []
        for _ in range(2):
            pc, mc = clone(p), clone(m)
            out = lars_update.lars_packed_update_multi(pc, g, mc, trust,
                                                       seg_all, **kw)
            if not (all(x is y for x, y in zip(out[0], pc))
                    and all(x is y for x, y in zip(out[1], mc))):
                fail(f"{what}: not in place")
            runs.append(out)
        want = ref.lars_packed_update_multi(clone(p), g, clone(m), trust,
                                            seg_all, **kw)
        torch.cuda.synchronize()
        for b, (p2, m2) in enumerate(per):
            got = (runs[0][0][b], runs[0][1][b])
            if not (torch.equal(got[0], p2) and torch.equal(got[1], m2)):
                fail(f"{what}: bucket {b} differs from its own launch")
            if not (torch.equal(got[0], runs[1][0][b])
                    and torch.equal(got[1], runs[1][1][b])):
                fail(f"{what}: two calls differ")
            close(got, (want[0][b], want[1][b]), f"{what} bucket {b}")

    timed = {}
    n_checked = 0
    for name, mb, n in K2_SITES:
        splan = plan if mb == 4.0 else bucketing.make_plan(pd, bucket_mb=mb)
        if mb != 4.0 and not any(s.elem_offset for s in splan.slots):
            fail(f"the {mb} MB plan splits no tensor")
        for k in range(n):
            p, g, m, segs, seg_all, trust = _shard_case(splan, n, k, dev, gen)
            check_multi(p, g, m, segs, seg_all, trust,
                        f"({name}) {mb} MB plan, rank {k} of {n}")
            n_checked += 1
            if name != "b" and k == 0:
                timed[name] = (p, g, m, segs, seg_all, trust)
    print(f"lars_packed_update_multi: {n_checked} calls at (a) 4 MB on 1 "
          f"shard, (b) 0.25 MB on 3 and (c) 4 MB on 4 (every rank): bit-"
          f"equal to the per-bucket launches, in place and repeat calls "
          f"equal; with every per-bucket launch, max abs err "
          f"{worst_abs:.3e}, max rel err {worst_rel:.3e} (rtol 1e-5, atol "
          f"1e-6)", flush=True)

    def variants(p, g, m, segs, seg_all, trust):
        flat = [torch.cat(x) for x in (p, g, m)]

        def per_bucket():
            for b in range(len(p)):
                lars_update.lars_packed_update(p[b], g[b], m[b], trust,
                                               segs[b], inplace=True, **kw)
        return {"one_launch": (lambda: lars_update.lars_packed_update_multi(
                    p, g, m, trust, seg_all, **kw), 50),
                "per_bucket_16_launches": (per_bucket, 50),
                "single_buffer_one_launch": (
                    lambda: lars_update.lars_packed_update(
                        *flat, trust, seg_all, inplace=True, **kw), 50),
                "plain": (lambda: ref.lars_packed_update_multi(
                    p, g, m, trust, seg_all, **kw), 10)}

    def bounds(p, seg_all, trust):
        elems, chunks = sum(x.numel() for x in p), seg_all.numel()
        one = bound_ms(5 * 4 * elems + 4 * chunks + 4 * trust.numel() + 4,
                       6 * elems)
        per = bound_ms(5 * 4 * elems + 4 * chunks
                       + len(p) * (4 * trust.numel() + 4), 6 * elems)
        return elems, one, per

    sites = {}
    for name, case in timed.items():
        fns = variants(*case)
        rounds = {key: [] for key in fns}
        for _ in range(K2_ROUNDS):
            for key, (fn, iters) in fns.items():
                rounds[key].append(time_ms(fn, iters=iters))
        elems, (b_ms, b_by), (b16, _) = bounds(case[0], case[4], case[5])
        dev_only = {key: device_ms(fns[key][0]) for key in
                    ("one_launch", "per_bucket_16_launches",
                     "single_buffer_one_launch")}
        med = {key: statistics.median(v) for key, v in rounds.items()}
        sites[name] = dict(med, rounds=rounds, device_ms=dev_only,
                           bound_ms=b_ms, bound_by=b_by,
                           per_bucket_bound_ms=b16, elements=elems)
        us = lambda key: "/".join(f"{t * 1e3:.1f}" for t in rounds[key])
        dus = lambda key: ("host-paced" if dev_only[key] is None
                           else f"{dev_only[key] * 1e3:.1f}")
        print(f"lars_packed_update at call site ({name}), {elems} elements "
              f"in {len(case[0])} shards, us in {K2_ROUNDS} rounds in "
              f"turns: one launch {us('one_launch')}, the 16 per-bucket "
              f"launches {us('per_bucket_16_launches')}, single-buffer "
              f"launch {us('single_buffer_one_launch')}, plain "
              f"{us('plain')}; device alone (host hidden): one launch "
              f"{dus('one_launch')}, the 16 launches "
              f"{dus('per_bucket_16_launches')}, single-buffer "
              f"{dus('single_buffer_one_launch')}; bound {b_ms * 1e3:.1f} "
              f"us ({b_by}), the 16 launches' {b16 * 1e3:.1f}; no single "
              f"PyTorch call computes it (no library time)", flush=True)

    p, g, _, segs, seg_all, _ = timed["a"]

    def k1_per_bucket():
        # the call site before: two calls a bucket and an add each
        sq = torch.zeros(2, plan.n_tensors, device=dev)
        for b in range(plan.n_buckets):
            sq[0] += batched_norm.batched_sumsq(p[b], segs[b], plan.n_tensors)
            sq[1] += batched_norm.batched_sumsq(g[b], segs[b], plan.n_tensors)

    k1_ms = time_ms(lambda: batched_norm.batched_sumsq_multi(
        (p, g), seg_all, plan.n_tensors), iters=50)
    k1_32 = time_ms(k1_per_bucket, iters=50)
    views = _segment_views(p, segs) + _segment_views(g, segs)
    k1_lib = time_ms(lambda: torch._foreach_norm(views), iters=50)
    k1_plain = time_ms(lambda: ref.batched_sumsq_multi(
        (p, g), seg_all, plan.n_tensors), iters=20)
    elems, chunks = plan.n_chunks * bucketing.CHUNK, plan.n_chunks
    k1_b, _ = bound_ms(2 * 4 * elems + 4 * chunks + 2 * 4 * plan.n_tensors,
                       2 * 2 * elems)
    k1_32_b, _ = bound_ms(2 * (4 * elems + 4 * chunks) + 2 * plan.n_buckets
                          * 4 * plan.n_tensors, 2 * 2 * elems)
    print(f"batched_sumsq at the ZeRO-1 call site, one step (the 16 p and g "
          f"shards): one launch (batched_sumsq_multi) {k1_ms * 1e3:.1f} us, "
          f"bound {k1_b * 1e3:.1f} us; the 32 per-bucket launches it "
          f"replaced {k1_32 * 1e3:.1f} us, bound {k1_32_b * 1e3:.1f} us; "
          f"plain {k1_plain * 1e3:.1f} us; torch._foreach_norm over the "
          f"same {len(views)} per-tensor views {k1_lib * 1e3:.1f} us",
          flush=True)
    a, c = sites["a"], sites["c"]
    entry = {"name": "lars_packed_update", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/lars_update.cu",
             "replaces": "src/repro/kernels/lars_update.py:32",
             "launches": None, "max_abs_err": worst_abs,
             "max_rel_err": worst_rel, "ms": a["one_launch"],
             "plain_ms": a["plain"], "bound_ms": a["bound_ms"],
             "bound_by": a["bound_by"], "library_ms": None,
             "library": "none: no single PyTorch call computes it",
             "timed": "the sharded step's call site, full-width 4 MB plan "
                      "on one shard: one launch (lars_packed_update_multi) "
                      "over the 16 bucket shards, in place; median of "
                      f"{K2_ROUNDS} rounds in turns",
             "per_bucket_16_launches_ms": a["per_bucket_16_launches"],
             "per_bucket_bound_ms": a["per_bucket_bound_ms"],
             "single_buffer_one_launch_ms": a["single_buffer_one_launch"],
             "rounds_ms": a["rounds"], "device_ms": a["device_ms"],
             "four_card_rank": {
                 "shape": "4 MB plan, rank 0 of 4 shards",
                 "elements": c["elements"], "ms": c["one_launch"],
                 "per_bucket_16_launches_ms": c["per_bucket_16_launches"],
                 "single_buffer_one_launch_ms":
                     c["single_buffer_one_launch"],
                 "plain_ms": c["plain"], "bound_ms": c["bound_ms"],
                 "per_bucket_bound_ms": c["per_bucket_bound_ms"],
                 "rounds_ms": c["rounds"], "device_ms": c["device_ms"]},
             "shape": [a["elements"]], "segments": plan.n_tensors,
             "dtype": "float32"}
    k1_site = {"zero1_site": {
        "ms": k1_ms, "per_bucket_32_launches_ms": k1_32,
        "plain_ms": k1_plain, "bound_ms": k1_b,
        "per_bucket_bound_ms": k1_32_b, "library_ms": k1_lib,
        "library": f"torch._foreach_norm over the {len(views)} per-tensor "
                   f"views of the 2 x {plan.n_buckets} shards (norms a "
                   f"view, not summed across a tensor's spans)"}}
    return entry, k1_site


def check_batched_sumsq(dev):
    """K1 at the training path's shape (ResNet-50's plan) in f32 and bf16,
    at the MoE LM training path's (lm_train_moe: qwen2-moe-a2.7b's 2-layer
    tree, packed in f32 as ``ops.tree_norms`` packs it), plus a ragged case
    with empty segments; timings at ResNet-50's f32 shape. Its
    multi-buffer form at the sharded step's call site: every bucket's p
    and g shards at rank k, every k, of the 4 MB plan on one shard and of
    the 0.25 MB plan (2 x 211 buffers: two pass-1 launches in one call)
    on one and three, f32 and bf16, and bit-equal across two calls."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, lars
    from repro_torch.kernels import batched_norm, ref
    from repro_torch.models import resnet, transformer
    from repro_torch.tree import tree_leaves

    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0])
    seg = torch.from_numpy(bucketing.segment_ids(plan)).to(dev)
    n_chunks, n_tensors = seg.numel(), plan.n_tensors
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n_chunks * bucketing.CHUNK, generator=gen,
                        device=dev).to(dtype)
        cases[str(dtype).split(".")[1]] = (x, seg, n_tensors)
    rag = torch.sort(torch.tensor([0, 2, 3, 9], device=dev)[torch.randint(
        0, 4, (3000,), generator=gen, device=dev)]).values.int()
    cases["ragged_f32"] = (torch.randn(3000 * bucketing.CHUNK, generator=gen,
                                       device=dev), rag, 11)
    moe_plan = bucketing.make_plan(transformer.lm_pd(dataclasses.replace(
        get_config("qwen2-moe-a2.7b"), n_layers=MOE_TRAIN_LAYERS)))
    moe_seg = torch.from_numpy(bucketing.segment_ids(moe_plan)).to(dev)
    cases["lm_train_moe_f32"] = (torch.randn(
        moe_seg.numel() * bucketing.CHUNK, generator=gen, device=dev),
        moe_seg, moe_plan.n_tensors)
    errs = {}
    for name, (x, s, n) in cases.items():
        got = batched_norm.batched_sumsq(x, s, n)
        want = ref.batched_sumsq(x, s, n)
        torch.cuda.synchronize()
        abs_err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        print(f"batched_sumsq {name}: {x.numel() // bucketing.CHUNK} chunks "
              f"x {n} segments, max abs err {abs_err:.3e}, max rel err "
              f"{rel:.3e} (rtol 2e-3)", flush=True)
        if not rel <= 2e-3:
            fail(f"batched_sumsq {name} disagrees with its plain version")
        errs[name] = (abs_err, rel)
    del cases["lm_train_moe_f32"], x, got, want

    pd = resnet.resnet_pd(get_config("resnet50"))[0]
    multi_abs, multi_rel, n_multi = 0.0, 0.0, 0
    for mb, n_shards in ((4.0, 1), (0.25, 1), (0.25, 3)):
        mplan = bucketing.make_plan(pd, bucket_mb=mb)
        sizes = bucketing.shard_sizes(mplan, n_shards)
        for k in range(n_shards):
            _, seg_all = lars._shard_maps(mplan, n_shards, k, dev)
            for dtype in (torch.float32, torch.bfloat16):
                rows = [[(sc * torch.randn(c, generator=gen, device=dev))
                         .to(dtype) for c in sizes] for sc in (1.0, 0.01)]
                got = batched_norm.batched_sumsq_multi(rows, seg_all,
                                                       n_tensors)
                again = batched_norm.batched_sumsq_multi(rows, seg_all,
                                                         n_tensors)
                want = ref.batched_sumsq_multi(rows, seg_all, n_tensors)
                torch.cuda.synchronize()
                d = (got - want).abs()
                rel = (d / want.abs().clamp_min(1e-30)).max().item()
                what = (f"batched_sumsq_multi {mb} MB plan, {n_shards} "
                        f"shards, rank {k}, {dtype}")
                if not rel <= 2e-3:
                    fail(f"{what} disagrees with its plain version (max "
                         f"rel err {rel:.3e}, rtol 2e-3)")
                if not torch.equal(got, again):
                    fail(f"{what}: two calls differ")
                multi_abs = max(multi_abs, d.max().item())
                multi_rel, n_multi = max(multi_rel, rel), n_multi + 1
                del rows
    print(f"batched_sumsq_multi: {n_multi} calls (p and g shards of every "
          f"bucket; 4 MB plan on 1 shard, 0.25 MB plan on 1 and 3, every "
          f"rank, f32 and bf16): max abs err {multi_abs:.3e}, max rel err "
          f"{multi_rel:.3e} (rtol 2e-3); two calls bit-equal", flush=True)

    x, s, n = cases["float32"]
    # the yardstick computes the same norms from the unpacked tensors
    leaves = tree_leaves(bucketing.unpack(list(x.split(plan.bucket_sizes)),
                                          plan))
    ms = time_ms(lambda: batched_norm.batched_sumsq(x, s, n))
    plain = time_ms(lambda: ref.batched_sumsq(x, s, n))
    library = time_ms(lambda: torch._foreach_norm(leaves))
    bf16_ms = time_ms(lambda: batched_norm.batched_sumsq(
        *cases["bfloat16"][:2], n))
    b_ms, b_by = bound_ms(x.numel() * 4 + s.numel() * 4 + n * 4,
                          2 * x.numel())
    b16_ms, _ = bound_ms(x.numel() * 2 + s.numel() * 4 + n * 4,
                         2 * x.numel())
    print(f"batched_sumsq f32 {n_chunks} chunks: kernel {ms * 1e3:.1f} us, "
          f"plain {plain * 1e3:.1f} us, torch._foreach_norm "
          f"{library * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}); "
          f"bf16: kernel {bf16_ms * 1e3:.1f} us, bound {b16_ms * 1e3:.1f} us",
          flush=True)
    return {"name": "batched_sumsq", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/batched_norm.cu",
            "replaces": "src/repro/kernels/batched_norm.py:44",
            "launches": None, "max_abs_err": errs["float32"][0],
            "max_rel_err": max(e[1] for e in errs.values()),
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library, "library": "torch._foreach_norm",
            "shape": [n_chunks * bucketing.CHUNK], "segments": n,
            "dtype": "float32", "bf16_ms": bf16_ms, "bf16_bound_ms": b16_ms,
            "multi_max_abs_err": multi_abs, "multi_max_rel_err": multi_rel}


def run_slice(dev):
    """Full-width ResNet-50 through the port's entry points, as
    examples/train_resnet_imagenet.py drives the JAX package."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn, prototype_imagenet
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_eval_step, make_train_step

    cfg = get_config("resnet50")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH) / 4, warmup_steps=STEPS // 8,
        total_steps=STEPS, decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    train_step = make_train_step(model, opt, sched, smoothing=0.1)
    batch_fn = make_batch_fn(cfg, InputShape("in", "train", 0, BATCH),
                             device=dev)
    state0 = init_state(model, seed=100000, device=dev)

    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=STEPS, log_every=1, seed=100000)
    # K1 twice a step (params, grads); no other kernel
    counts = _read_path("slice", {"k1": 2 * STEPS})
    launches = counts["k1"]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history]
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail("loop.train did not reach run_stop")
    ev = make_eval_step(model)(state.params, prototype_imagenet(
        cfg, batch=BATCH, step=10 ** 6, seed=100000, device=dev),
        state.bn_state)
    if not (math.isfinite(float(ev["loss"])) and 0 <= float(ev["acc"]) <= 1):
        fail(f"eval step gave {ev}")
    med = statistics.median(times)
    print(f"slice: losses {[round(v, 4) for v in losses]}", flush=True)
    print(f"slice: step times ms {[round(t * 1e3, 2) for t in times]}; "
          f"median {med * 1e3:.2f} ms, {BATCH / med:.1f} images/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; batched_sumsq launches "
          f"{launches}", flush=True)
    return state0, batch_fn, counts


def check_in_context(dev, state0, batch_fn):
    """One step from one state and batch with the norm kernel and one with
    the per-tensor norms: LARS must give the same params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    model = build_model(get_config("resnet50"))
    sched = make_schedule(ScheduleConfig(base_lr=1.0, total_steps=STEPS))
    batch = batch_fn(0)
    torch.backends.cudnn.deterministic = True
    try:
        out = {k: make_train_step(model, lars.OptConfig(use_kernel=k),
                                  sched)(state0, batch)[0].params
               for k in (True, False)}
    finally:
        torch.backends.cudnn.deterministic = False
    worst, moved = 0.0, 0.0
    for (_, a), (_, b) in zip(tree_flatten(out[True]),
                              tree_flatten(out[False])):
        scale = b.abs().max().item()
        worst = max(worst, (a - b).abs().max().item() / max(scale, 1e-30))
    for (_, a), (_, b) in zip(tree_flatten(out[True]),
                              tree_flatten(state0.params)):
        moved = max(moved, (a - b).abs().max().item())
    print(f"context: kernel vs per-tensor norms, worst param difference "
          f"{worst:.3e} of the tensor's max (limit 1e-5); largest update "
          f"{moved:.3e}", flush=True)
    if not worst <= 1e-5 or moved == 0.0:
        fail("the step with the norm kernel disagrees with the plain step")


def _zero1_step(model, sched, mesh, **kw):
    """The ZeRO-1 step of the zero1 path; ``kw``: ``make_train_step``'s
    ``guard`` and ``tracer``."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.train.step import make_train_step
    comm = CommConfig(strategy="psum", sharding="zero1", gather="ahead",
                      overlap=True, update_kernel=True, bucket_mb=4)
    return make_train_step(model, lars.OptConfig(kind="lars",
                                                 weight_decay=5e-5,
                                                 use_kernel=True),
                           sched, smoothing=0.1, mesh=mesh, comm=comm, **kw)


def run_zero1(dev, mesh):
    """The ZeRO-1 explicit-DP step at full width on a one-rank NCCL group,
    through make_train_step + loop.train, as the CLI drives it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn, prototype_imagenet
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_eval_step

    cfg = get_config("resnet50")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH) / 4, warmup_steps=STEPS // 8,
        total_steps=STEPS, decay="poly2"))
    step = _zero1_step(model, sched, mesh)
    plan = step.bucket_plan
    if (plan.n_buckets, step.n_shards, step.gather) != (16, 1, "ahead"):
        fail(f"unexpected ZeRO-1 plan: {plan.n_buckets} buckets, "
             f"{step.n_shards} shards, gather {step.gather!r}")
    batch_fn = make_batch_fn(cfg, InputShape("in", "train", 0, BATCH),
                             device=dev, mesh=mesh)
    state0 = init_state(model, seed=100000, device=dev, sharded_plan=plan,
                        n_shards=step.n_shards, mesh=mesh)
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=STEPS, log_every=1, seed=100000)
    # K2 and K1 once a step; no other kernel (one rank: no fold)
    counts = _read_path("zero1", {"k1": STEPS, "k2": STEPS})
    k1, k2 = counts["k1"], counts["k2"]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history]
    if len(losses) != STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"zero1 losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail("zero1: loop.train did not reach run_stop")
    ev = make_eval_step(model)(
        loop.make_params_reader(step)(state),
        prototype_imagenet(cfg, batch=BATCH, step=10 ** 6, seed=100000,
                           device=dev), state.bn_state)
    if not (math.isfinite(float(ev["loss"])) and 0 <= float(ev["acc"]) <= 1):
        fail(f"zero1 eval step gave {ev}")
    med = statistics.median(times)
    print(f"zero1: losses {[round(v, 4) for v in losses]}; eval loss "
          f"{float(ev['loss']):.4f}", flush=True)
    print(f"zero1: step times ms {[round(t * 1e3, 2) for t in times]}; "
          f"median {med * 1e3:.2f} ms, {BATCH / med:.1f} images/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches lars_packed_update "
          f"{k2}, batched_sumsq {k1}", flush=True)
    return counts


def check_zero1_in_context(dev, mesh, batch_fn):
    """One ZeRO-1 step (K1 + K2) and one replicated comm='xla' step
    (per-tensor norms, no kernel) from one state and batch: the masters
    read back from the shards must agree with the replicated params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.train import state as st
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    model = build_model(get_config("resnet50"))
    sched = make_schedule(ScheduleConfig(base_lr=1.0, total_steps=STEPS))
    zero = _zero1_step(model, sched, mesh)
    plan = zero.bucket_plan
    s0 = st.init_state(model, seed=7, device=dev)
    packed = lambda tree: st.local_shards(st.init_packed_shards(tree, plan),
                                          1, 0)
    z0 = st.TrainState(0, s0.params, packed(s0.mom), s0.bn_state,
                       packed(s0.params))
    batch = batch_fn(0)
    torch.backends.cudnn.deterministic = True
    try:
        want = make_train_step(model, lars.OptConfig(use_kernel=False),
                               sched)(s0, batch)[0].params
        z1 = zero(z0, batch)[0]
    finally:
        torch.backends.cudnn.deterministic = False
    got = st.full_params_from_shards(z1.shards, plan)
    worst, moved = 0.0, 0.0
    for (_, a), (_, b), (_, c) in zip(tree_flatten(got), tree_flatten(want),
                                      tree_flatten(s0.params)):
        worst = max(worst, (a - b).abs().max().item()
                    / max(b.abs().max().item(), 1e-30))
        moved = max(moved, (a - c).abs().max().item())
    print(f"zero1 context: ZeRO-1 masters vs the replicated step's params, "
          f"worst difference {worst:.3e} of the tensor's max (limit 1e-5); "
          f"largest update {moved:.3e}", flush=True)
    if not worst <= 1e-5 or moved == 0.0:
        fail("the ZeRO-1 step disagrees with the replicated step")


def _counting(step, tally):
    """``step`` that adds one to ``tally[0]`` for every call the guard let
    commit (every call of an unguarded step): K1 and K2 launch once in
    each such call of the zero1 step and in no other."""
    def call(*args):
        out = step(*args)
        if float(out[1].get("skipped", 0.0)) == 0.0:
            tally[0] += 1
        return out
    call.__dict__.update(step.__dict__)
    return call


def _tensors(tree) -> list:
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree) if isinstance(tree, dict) else list(tree)


def _bit_equal(a, b) -> bool:
    """Every tensor of two trees (or sequences) equal, bit for bit."""
    import torch
    la, lb = _tensors(a), _tensors(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool(torch.equal(x, y))
        for x, y in zip(la, lb))


def _worst_rel(a, b) -> float:
    """Largest difference over buffers, relative to each buffer's max."""
    return max((x - y).abs().max().item() / max(y.abs().max().item(), 1e-30)
               for x, y in zip(a, b))


def _state_bit_equal(a, b) -> bool:
    return a.step == b.step and all(
        _bit_equal(x, y) for x, y in ((a.params, b.params), (a.mom, b.mom),
                                      (a.bn_state, b.bn_state),
                                      (a.shards, b.shards)))


def run_durability(dev, mesh, batch_fn, tmp):
    """Durability and observability on the full-width ZeRO-1 step (K1, K2)
    through loop.train: a checkpoint round trip, the n→m relayout and an
    elastic resume, a guarded nan@2 run against its oracle and a spike
    rollback, a traced run, and the guard's, the tracer's and a snapshot's
    cost. Returns every kernel's launches (K1 and K2 once a committed step
    call, 0 on a skipped one)."""
    import hashlib

    import torch
    from repro_torch import comm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import bucketing
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, guard, loop
    from repro_torch.train import state as st

    model = build_model(get_config("resnet50"))
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH) / 4, warmup_steps=STEPS // 8,
        total_steps=STEPS, decay="poly2"))
    committed = [0]
    step = _counting(_zero1_step(model, sched, mesh), committed)
    plan = step.bucket_plan
    fresh = lambda: st.init_state(   # noqa: E731
        model, seed=100000, device=dev, **st.sharded_state_kwargs(step))
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    reg = obs_metrics.default_registry()

    # 1. checkpoint round trip after 2 steps, with the CommPlan
    d1 = os.path.join(tmp, "ckpt")
    with reg.use_sink(sink):
        s2, _ = loop.train(fresh(), step, batch_fn, steps=2, log_every=0,
                           ckpt_dir=d1, ckpt_every=2,
                           comm_plan=step.comm_plan, seed=100000)
    tag = ckpt.step_tag(2)
    ent = ckpt.verify(d1, tag)
    with open(os.path.join(d1, ent["file"]), "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != ent["sha256"]:
            fail("durability: the manifest's sha256 is not the payload's")
    torch.cuda.synchronize()
    t = time.perf_counter()
    ckpt.save(s2, d1, tag="timed", comm_plan=step.comm_plan, mesh=mesh)
    save_ms = (time.perf_counter() - t) * 1e3
    template = fresh()
    t = time.perf_counter()
    back = ckpt.load(template, d1, tag=tag, mesh=mesh)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    if not _state_bit_equal(back, s2):
        fail("durability: the checkpoint did not load back bit for bit")
    if ckpt.load_comm_plan(d1, tag=tag) != step.comm_plan:
        fail("durability: the CommPlan did not load back equal")
    mib = ckpt.read_manifest(d1)["entries"][tag]["bytes"] / 2 ** 20
    print(f"durability: checkpoint after 2 steps: {mib:.1f} MiB payload, save "
          f"{save_ms:.1f} ms, load {load_ms:.1f} ms; every tensor of "
          f"params, momentum, BN and shards bit-equal; sha256 and CommPlan "
          f"match", flush=True)

    # 2. n→m relayout of the full-width masters and momentum, then an
    # elastic resume from a 1 MB-plan checkpoint into the 4 MB step
    plan1 = bucketing.make_plan(model.param_pd, bucket_mb=1.0)
    chain = ((plan, 1), (plan, 4), (plan1, 4), (plan1, 1), (plan, 1))
    times = []
    for name in ("shards", "mom"):
        bufs = list(getattr(s2, name))
        for (pa, na), (pb, nb) in zip(chain, chain[1:]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bufs = elastic.reshard_buffers(bufs, pa, na, pb, nb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        if not _bit_equal(bufs, getattr(s2, name)):
            fail(f"durability: {name} 4 MB/1 -> 4 MB/4 -> 1 MB/4 -> 1 MB/1 "
                 f"-> 4 MB/1 is not bit-equal")
    relay = lambda b: elastic.reshard_buffers(b, plan, 1, plan1, 1)  # noqa
    s1mb = st.TrainState(s2.step, s2.params, tuple(relay(list(s2.mom))),
                         s2.bn_state, tuple(relay(list(s2.shards))))
    d2 = os.path.join(tmp, "ckpt_1mb")
    cp1 = comm.plan_for(CommConfig(strategy="psum", bucket_mb=1.0,
                                   sharding="zero1", update_kernel=True),
                        mesh, model.param_pd)
    ckpt.save(s1mb, d2, tag=tag, comm_plan=cp1, mesh=mesh)
    template = fresh()
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = elastic.load_resharded(d2, template, plan, 1, mesh=mesh)
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t) * 1e3
    if not (_bit_equal(r.shards, s2.shards) and _bit_equal(r.mom, s2.mom)):
        fail("durability: load_resharded from the 1 MB plan is not bit-equal")
    r, m = step(r, batch_fn(r.step))
    if r.step != 3 or not math.isfinite(float(m["loss"])):
        fail(f"durability: the resumed step gave step {r.step}, loss "
             f"{float(m['loss'])}")
    print(f"durability: reshard_buffers at full width (16 buckets <-> "
          f"{plan1.n_buckets}, 1 <-> 4 shards) {min(times):.1f}-"
          f"{max(times):.1f} ms a relayout, bit-equal; load_resharded from "
          f"the 1 MB plan {resume_ms:.1f} ms, then a step: loss "
          f"{float(m['loss']):.4f}", flush=True)
    del s1mb, r, back, template

    # 3. guarded nan@2 against the uninjected run, bit for bit under the
    # determinism rule; then a spike and its rollback
    gstep = _counting(_zero1_step(model, sched, mesh, guard=True),
                      committed)

    def guarded(faults):
        mem = obs_metrics.MemorySink()
        with reg.use_sink(mem):
            s, hist = loop.train(fresh(), gstep, batch_fn, steps=DUR_STEPS,
                                 log_every=1, faults=faults, seed=100000,
                                 guard=guard.GuardConfig())
        return s, hist, mem

    det_op, before = None, torch.are_deterministic_algorithms_enabled()
    try:
        torch.use_deterministic_algorithms(True)
        a, _, mem_a = guarded("nan@2")
        o, _, mem_o = guarded(None)
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        det_op = str(e).splitlines()[0]
        torch.use_deterministic_algorithms(before)
        a, _, mem_a = guarded("nan@2")
        o, _, mem_o = guarded(None)
    finally:
        torch.use_deterministic_algorithms(before)
    skips = len(mem_a.find("guard_skip"))
    if skips != 1 or mem_o.find("guard_skip") or not (a.step == o.step
                                                      == DUR_STEPS):
        fail(f"durability: nan@2 gave {skips} guard_skip, steps {a.step} / "
             f"{o.step}")
    if det_op is None:
        if not _bit_equal(a.shards, o.shards):
            fail("durability: the guarded nan@2 run's masters are not the "
                 "oracle's bit for bit (deterministic algorithms on)")
        how = "bit for bit (torch.use_deterministic_algorithms)"
    else:
        worst = _worst_rel(a.shards, o.shards)
        if not worst <= DUR_TOL:
            fail(f"durability: nan@2 masters {worst:.3e} of the max from "
                 f"the oracle's (limit {DUR_TOL}; {det_op})")
        how = (f"{worst:.3e} of the max (limit {DUR_TOL}): no deterministic "
               f"form for: {det_op}")
    with reg.use_sink(obs_metrics.MemorySink()) as mem_s:
        s, hist = loop.train(fresh(), gstep, batch_fn, steps=DUR_STEPS,
                             log_every=1, faults=DUR_SPIKE, seed=100000,
                             guard=guard.GuardConfig())
    losses = [h["loss"] for h in hist if "loss" in h]
    if not (mem_s.find("guard_rollback") and mem_s.find("run_stop")
            and all(math.isfinite(v) for v in losses)):
        fail(f"durability: {DUR_SPIKE}: rollbacks "
             f"{len(mem_s.find('guard_rollback'))}, losses {losses}")
    print(f"durability: guarded nan@2, {DUR_STEPS} steps: 1 guard_skip, "
          f"masters equal to the uninjected run {how}; {DUR_SPIKE}: "
          f"{len(mem_s.find('guard_rollback'))} guard_rollback, finite "
          f"losses, run_stop", flush=True)
    del a, o, s

    # 4. the tracer: 3 traced steps through the loop, the Chrome JSON
    tracer = obs_trace.Tracer()
    tstep = _counting(_zero1_step(model, sched, mesh, tracer=tracer), committed)
    loop.train(fresh(), tstep, batch_fn, steps=3, log_every=0,
               tracer=tracer, seed=100000)
    path = obs_trace.export_chrome(tracer, os.path.join(tmp, "trace.json"))
    spans = obs_trace.spans_from_chrome(obs_trace.load_chrome(path))
    want = {"forward", "backward", "update"} | {
        f"{k}[b{i}]" for k in ("rs", "ag") for i in range(plan.n_buckets)}
    for i in range(3):
        mine = [sp for sp in spans if sp.step == i]
        win = [sp for sp in mine if sp.name == "step"]
        names = {sp.name for sp in mine} - {"step"}
        if len(win) != 1 or names != want or not all(
                win[0].t0 <= sp.t0 <= sp.t1 <= win[0].t1 for sp in mine):
            fail(f"durability: traced step {i}: spans {sorted(names)}, "
                 f"want {sorted(want)}, each inside its window")

    # the overlap gate: each group's reduce-scatter starts once its
    # gradients exist, in the order the backward reaches the groups
    order = _overlap_order(model, plan, batch_fn(0))
    overlap = [_overlap_gate([sp for sp in spans if sp.step == i], order,
                             f"durability: traced step {i}")
               for i in range(3)]
    for i, row in enumerate(overlap):
        print(f"durability: traced step {i}: rs spans begin "
              f"{row['first_ms']:.1f} / {row['median_ms']:.1f} / "
              f"{row['last_ms']:.1f} ms (first / median / last) into a "
              f"{row['backward_ms']:.1f} ms backward span; in the order "
              f"{row['order']}, non-decreasing; the first before the "
              f"span's midpoint", flush=True)
    # kept past the phase's temporary directory, for the report phase
    _RESULTS["durability_trace"] = shutil.copyfile(
        path, ROOT / "build" / "chip_smoke_trace.json")

    # 5. the guard's and the tracer's cost, interleaved; a snapshot's cost
    variants = {"unguarded": (step, None), "guarded": (gstep, None),
                "traced": (tstep, tracer)}
    states = {k: fresh() for k in variants}
    ms = {k: [] for k in variants}
    for r_i in range(DUR_ROUNDS):
        for k, (fn, tr) in variants.items():
            batch = batch_fn(r_i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            if tr is not None:
                tr.begin_step()
            args = (guard.neutral_inputs(),) if k == "guarded" else ()
            states[k], _ = fn(states[k], batch, *args)
            if tr is not None:
                tr.end_step(100 + r_i)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t) * 1e3)
    snaps = []
    for _ in range(DUR_SNAPSHOTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        snap = st.host_snapshot(states["unguarded"])
        torch.cuda.synchronize()
        snaps.append((time.perf_counter() - t) * 1e3)
    nbytes = sum(x.numel() * x.element_size() for x in
                 _tensors(snap.shards) + _tensors(snap.mom)
                 + _tensors(snap.params) + _tensors(snap.bn_state))
    del snap, states
    med = {k: statistics.median(v[1:]) for k, v in ms.items()}
    print(f"durability: step ms, {DUR_ROUNDS} interleaved rounds (median "
          f"after the first): unguarded {med['unguarded']:.2f}, guarded "
          f"{med['guarded']:.2f}, traced {med['traced']:.2f}; all "
          + "; ".join(f"{k} {[round(x, 2) for x in v]}"
                      for k, v in ms.items()), flush=True)
    print(f"durability: a rollback snapshot (device copy, "
          f"{nbytes / 2 ** 20:.1f} MiB) {statistics.median(snaps):.3f} ms "
          f"(median of {DUR_SNAPSHOTS})", flush=True)
    counts = _read_path("durability", {"k1": committed[0],
                                       "k2": committed[0]})
    print(f"durability: {committed[0]} committed step calls: launches "
          f"batched_sumsq {counts['k1']}, lars_packed_update {counts['k2']}",
          flush=True)
    return counts


def _overlap_order(model, plan, batch):
    """The order in which the backward reaches ``plan``'s groups. Each
    group's identity is made where the forward first reads one of its
    leaves (with every group sharing a split leaf with it: a unit), and
    autograd runs the ready node made last first, so the units run in the
    reverse order of their first reads, each unit's groups in group order.
    The read order is taken from one forward on the meta device (shapes
    only) over a tree that records each leaf's first read. For ResNet the
    plan packs in reverse flatten order, where ``stem`` is the last key:
    group 0 holds the stem's leaves (read first, reached last)."""
    import torch
    from repro_torch.core import ddp
    from repro_torch.tree import LazyTree, tree_leaves, tree_map

    meta = lambda x: torch.empty(x.shape, dtype=getattr(  # noqa: E731
        x, "dtype", torch.float32), device="meta")
    shapes = tree_leaves(model.param_pd)
    read = []
    tree = LazyTree(plan.paths, lambda i: (read.append(i),
                                           meta(shapes[i]))[1])
    bn = (tree_map(meta, model.bn_state_pd) if model.bn_state_pd is not None
          else None)
    with torch.no_grad():
        model.forward_train(tree, {k: meta(v) for k, v in batch.items()},
                            bn)
    n = plan.n_tensors
    leaf = {id(s): n - 1 - t for t, s in zip(plan.slot_tensor_ids,
                                              plan.slots)}
    group_leaves = [[leaf[id(s)] for s in g] for g in plan.groups]
    unit_of = ddp._units(group_leaves, n)
    first = {}
    for pos, j in enumerate(read):
        first.setdefault(unit_of[j], pos)
    return [gi for u in sorted(first, key=first.get, reverse=True)
            for gi in u]


def _overlap_gate(spans, order, what: str, kind: str = "rs") -> dict:
    """Where one traced step's in-backward collectives begin: fails
    unless the ``{kind}[b<i>]`` begins (``rs``: the reduce-scatters,
    ``ar``: the all-reduces) are non-decreasing in the order the
    backward reaches the groups (``order``, from ``_overlap_order``) and
    the first of them begins before the backward span's midpoint. Returns
    the begins (ms after the backward span's begin) and the span's
    length."""
    bwd = next(sp for sp in spans if sp.name == "backward")
    begin = {int(sp.name[4:-1]): (sp.t0 - bwd.t0) * 1e3 for sp in spans
             if sp.name.startswith(f"{kind}[b")}
    if sorted(begin) != sorted(order):
        fail(f"{what}: {kind} spans of groups {sorted(begin)}, want "
             f"{sorted(order)}")
    seq = [begin[gi] for gi in order]
    bwd_ms = (bwd.t1 - bwd.t0) * 1e3
    if any(b < a for a, b in zip(seq, seq[1:])) or not seq[0] < bwd_ms / 2:
        fail(f"{what}: {kind} begins {[round(x, 2) for x in seq]} ms in the "
             f"order {order} into a {bwd_ms:.2f} ms backward span; they "
             f"must be non-decreasing, the first before the midpoint")
    starts = sorted(seq)
    return {"order": order, "begin_ms": seq, "backward_ms": bwd_ms,
            "first_ms": starts[0], "median_ms": statistics.median(starts),
            "last_ms": starts[-1]}


def _ring_rows(dev, gen, L, n, dtype):
    """A bucket of ``L`` elements as the ring cuts it for ``n`` ranks
    (``_as_chunks(pad_to=CHUNK)``) and a received partial of one row."""
    import torch
    from repro_torch.comm import primitives as prim
    from repro_torch.core.bucketing import CHUNK
    x = torch.randn(L, generator=gen, device=dev).to(dtype)
    chunks = prim._as_chunks(x, n, pad_to=CHUNK)
    recv = torch.randn(chunks.shape[1], generator=gen, device=dev).to(dtype)
    return recv, chunks


def check_ring_add(dev):
    """K3 against its plain version, bit for bit, through the wrapper and
    through the fold ``kernel_step_fn`` binds once a chunks, at the ring's
    shapes: the ResNet-50 path's chunk rows (the largest and the smallest
    of its 16 buckets on 4 and 2 ranks, bf16 and f32, every k), the reference
    test's shapes ((4, 2·1024) f32 at k 0 and 3; bf16 ones + 0.5), its
    ragged (n, length) pairs through ``_as_chunks(pad_to=CHUNK)``, views
    off the 16-byte grid and the fold in place. Times one fold at the
    largest row (through ``kernel_step_fn`` bound to its chunks, as the
    ring folds, and through the public wrapper) and the 48 folds of a
    four-rank ring step (the same two ways), beside the plain version,
    ``torch.add(..., out=)`` and the bound; then splits a bound fold's
    host time: the bare C call (c = 0: no launch), ``data_ptr()``, and
    the C call with its launch from precomputed arguments."""
    import torch
    from repro_torch.comm import ring_kernel as rk
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.core.bucketing import CHUNK
    from repro_torch.kernels import ref
    from repro_torch.models import resnet

    plan = bucketing.make_plan(resnet.resnet_pd(get_config("resnet50"))[0])
    if plan.n_buckets != 16:
        fail(f"the full-width plan has {plan.n_buckets} buckets, not 16")
    gen = torch.Generator(device=dev).manual_seed(4)
    n_checked, worst = 0, 0.0
    # the chunks the last kernel_step_fn was bound to, and that adapter:
    # the k of one chunks fold through one adapter, as in the ring
    bound = [None, None]

    def check(recv, chunks, k, what, out=None):
        nonlocal n_checked, worst
        want = ref.ring_add_step(recv, chunks, k)    # before any in place
        buf = recv.clone()
        snap = chunks.clone()
        got = rk.ring_add_step(recv, chunks, k, out=out)
        if bound[0] is not chunks:
            bound[:] = [chunks, rk.kernel_step_fn()]
        before = rk.ring_add_step.launches
        bound[1](buf, chunks, k)
        if rk.ring_add_step.launches != before + 1:
            fail(f"ring_add_step {what}: the bound fold did not launch once")
        torch.cuda.synchronize()
        for name, x in (("the wrapper", got), ("the bound fold", buf)):
            if x.dtype != want.dtype:
                fail(f"ring_add_step {what}, {name}: dtype {x.dtype}")
            worst = max(worst, (x.float() - want.float()).abs().max().item())
            if not torch.equal(x, want):
                fail(f"ring_add_step {what} k={k}, {name}, is not bit-equal "
                     f"to its plain version")
        if not torch.equal(chunks, snap):
            fail(f"ring_add_step {what}: chunks were written")
        n_checked += 1

    f32, bf16 = torch.float32, torch.bfloat16
    sizes = {"largest": max(plan.bucket_sizes),
             "smallest": min(plan.bucket_sizes)}
    for name, L in sizes.items():
        for n in (4, 2):
            for dtype in (bf16, f32):
                recv, chunks = _ring_rows(dev, gen, L, n, dtype)
                for k in range(n):
                    check(recv, chunks, k, f"{name} bucket, n {n}, {dtype}")
    recv, chunks = _ring_rows(dev, gen, 4 * 2 * CHUNK, 4, f32)
    for k in (0, 3):
        check(recv, chunks, k, "reference (4, 2048) f32")
    ones = torch.ones((2, CHUNK), dtype=bf16, device=dev)
    half = torch.full((CHUNK,), 0.5, dtype=bf16, device=dev)
    check(half, ones, 1, "reference bf16")
    if not bool((rk.ring_add_step(half, ones, 1) == 1.5).all()):
        fail("ring_add_step: 0.5 + 1 is not 1.5 in bf16")
    for n, length in RING_RAGGED:
        recv, chunks = _ring_rows(dev, gen, length, n, f32)
        for k in range(n):
            check(recv, chunks, k, f"ragged ({n}, {length})")
    c = 3 * CHUNK
    for dtype in (bf16, f32):
        chunks = torch.randn(2 * c + 1, generator=gen,
                             device=dev).to(dtype)[1:].view(2, c)
        for shift in (1, 2):       # offset like the rows, then apart
            recv = torch.randn(c + shift, generator=gen,
                               device=dev).to(dtype)[shift:]
            out = torch.empty(c + 1, dtype=dtype, device=dev)[1:]
            check(recv, chunks, 1, f"misaligned by {shift}, {dtype}",
                  out=out)
        held = torch.randn(c, generator=gen, device=dev).to(dtype)
        check(held, chunks, 0, f"in place, {dtype}", out=held)
    print(f"ring_add_step: {n_checked} folds, each through the wrapper and "
          f"the bound fold, bit-equal to the plain version "
          f"(max abs err {worst:.1e}): the path's largest and smallest chunk "
          f"rows on 4 and 2 ranks in bf16 and f32 at every k, the reference "
          f"shapes, ragged {list(RING_RAGGED)}, misaligned views, in place",
          flush=True)
    if worst != 0.0:
        fail("ring_add_step is not bit-equal to its plain version")

    # one fold at the largest row of a four-rank ring, in the wire dtype
    recv, chunks = _ring_rows(dev, gen, sizes["largest"], 4, bf16)
    out = recv.clone()
    bound_fold = rk.kernel_step_fn()
    ms = time_ms(lambda: bound_fold(out, chunks, 1), iters=200, warmup=20)
    # a bucket's first fold: a new adapter checks in full and binds
    first_ms = time_ms(lambda: rk.kernel_step_fn()(out, chunks, 1),
                       iters=200, warmup=20)
    wrapper = time_ms(lambda: rk.ring_add_step(recv, chunks, 1, out=out),
                      iters=200, warmup=20)
    plain = time_ms(lambda: ref.ring_add_step(recv, chunks, 1), iters=200,
                    warmup=20)
    library = time_ms(lambda: torch.add(recv, chunks[1], out=out),
                      iters=200, warmup=20)
    cr = recv.numel()
    b_ms, b_by = bound_ms(3 * cr * 2, cr)
    r32, c32 = _ring_rows(dev, gen, sizes["largest"], 4, f32)
    f32_fold = rk.kernel_step_fn()
    f32_ms = time_ms(lambda: f32_fold(r32, c32, 1), iters=200, warmup=20)
    f32_b, _ = bound_ms(3 * cr * 4, cr)
    del r32, c32, f32_fold
    # where a bound fold's host time goes, at the same row: the typed
    # entry called bare (c = 0 returns before any launch), data_ptr(),
    # and the call with its launch from arguments computed beforehand
    fn = rk._inplace_entry(bf16)
    o_ptr, row_ptr = out.data_ptr(), chunks[1].data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    bare_us = host_us(lambda: fn(o_ptr, row_ptr, 0, stream))
    ptr_us = host_us(out.data_ptr)
    raw = time_ms(lambda: fn(o_ptr, row_ptr, cr, stream), iters=200,
                  warmup=20)
    # the 48 folds of one four-rank ring step: 16 buckets x k 0, 1, 2, in
    # place into fresh receives as the ring does (115 MB: past the L2)
    rows = [_ring_rows(dev, gen, L, 4, bf16) for L in plan.bucket_sizes]
    outs = [torch.empty_like(r) for r, _ in rows]

    def step(fold):
        for (r, ch), o in zip(rows, outs):
            for k in range(3):
                fold(r, ch, k, o)

    def ring_step():
        # the ring's own path: one kernel_step_fn a bucket, bound on its
        # first fold, in place into the receive buffer
        for (_, ch), o in zip(rows, outs):
            fold = rk.kernel_step_fn()
            for k in range(3):
                fold(o, ch, k)

    s_ms = time_ms(ring_step, iters=20, warmup=3)
    s_wrapper = time_ms(lambda: step(lambda r, ch, k, o: rk.ring_add_step(
        r, ch, k, out=o)), iters=20, warmup=3)
    s_plain = time_ms(lambda: step(lambda r, ch, k, o: ref.ring_add_step(
        r, ch, k)), iters=20, warmup=3)
    s_lib = time_ms(lambda: step(lambda r, ch, k, o: torch.add(
        r, ch[k], out=o)), iters=20, warmup=3)
    s_elems = 3 * sum(r.numel() for r, _ in rows)
    s_b, _ = bound_ms(3 * s_elems * 2, s_elems)
    print(f"ring_add_step bf16 at the largest row (4 ranks, {cr} elements): "
          f"kernel_step_fn's bound fold {ms * 1e3:.2f} us (a bucket's first "
          f"fold, checked and bound, {first_ms * 1e3:.2f} us), the wrapper "
          f"{wrapper * 1e3:.2f} us, plain {plain * 1e3:.2f} us, torch.add "
          f"{library * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}); f32 "
          f"bound fold {f32_ms * 1e3:.2f} us, bound {f32_b * 1e3:.2f} us; a "
          f"four-rank step's 48 folds: through kernel_step_fn "
          f"{s_ms * 1e3:.1f} us, the wrapper {s_wrapper * 1e3:.1f} us, plain "
          f"{s_plain * 1e3:.1f} us, torch.add {s_lib * 1e3:.1f} us, bound "
          f"{s_b * 1e3:.1f} us", flush=True)
    print(f"ring_add_step, a bound fold's host time: bare C call (no "
          f"launch) {bare_us:.2f} us, data_ptr() {ptr_us:.2f} us, C call "
          f"with its launch {raw * 1e3:.2f} us; the fold's Python checks "
          f"the rest of {ms * 1e3:.2f} us", flush=True)
    return {"name": "ring_add_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ring_add.cu",
            "replaces": "src/repro/comm/ring_kernel.py:38",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "timed": "kernel_step_fn's fold, bound to its chunks",
            "first_fold_ms": first_ms, "wrapper_ms": wrapper,
            "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library,
            "library": "torch.add(recv, chunks[k], out=out)",
            "shape": [4, cr], "dtype": "bfloat16", "f32_ms": f32_ms,
            "f32_bound_ms": f32_b, "folds_checked": n_checked,
            "host_split_us": {"bare_call": bare_us, "data_ptr": ptr_us,
                              "call_and_launch": raw * 1e3},
            "step_48_folds": {"step_fn_ms": s_ms, "wrapper_ms": s_wrapper,
                              "plain_ms": s_plain, "library_ms": s_lib,
                              "bound_ms": s_b}}


def _visible_pairs(S: int, window: int, causal: bool = True,
                   Sk: int = None) -> int:
    """(query, key) pairs an attention of S queries computes: causal
    (windowed) over S tokens, sum over q of min(q + 1, window); non-causal
    without a window, every query with each of Sk (default S) keys."""
    if not causal and not window:
        return S * (Sk or S)
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_case(dev, gen, name, B, S, H, K, Dk, Dv, window, dt, q_scale,
                causal=True, Sk=None):
    """K5 at one shape (S queries over Sk keys, default S), q multiplied by
    ``q_scale``: checked against its plain version, then timed beside the
    plain version, SDPA on the same inputs and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dtype = getattr(torch, dt)
    Sk = Sk or S
    q, k, v = (torch.randn((B * n, L, d), generator=gen, device=dev)
               .to(dtype) for n, L, d in ((H, S, Dk), (K, Sk, Dk),
                                          (K, Sk, Dv)))
    q = (q.float() * q_scale).to(dtype)
    kw = dict(causal=causal, window=window, n_q_heads=H, n_kv_heads=K)
    sliced = B * H * S * Sk * 4 > FLASH_PLAIN_WHOLE_BYTES

    def plain():
        if not sliced:
            return ref.flash_attention(q, k, v, **kw)
        return torch.cat([ref.flash_attention(
            q[b * H:(b + 1) * H], k[b * K:(b + 1) * K], v[b * K:(b + 1) * K],
            **kw) for b in range(B)])

    got = fa.flash_attention(q, k, v, **kw)
    want = plain()
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[dt]
    err = (got.float() - want.float()).abs()
    max_err = err.max().item()
    if not bool((err <= atol + rtol * want.float().abs()).all()):
        fail(f"flash_attention {name} disagrees with its plain version "
             f"(rtol {rtol}, atol {atol}): max abs err {max_err:.3e}")
    del want, err
    if not torch.equal(fa.flash_attention(q, k, v, **kw), got):
        fail(f"flash_attention {name}: two calls differ")
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters=20,
                 warmup=3)
    plain_ms = time_ms(plain, iters=5, warmup=1)
    qs, ks, vs = (x.view(B, -1, x.shape[1], x.shape[-1]) for x in (q, k, v))
    sdpa = dict(enable_gqa=K != H)
    if window:
        i = torch.arange(S, device=dev)
        sdpa["attn_mask"] = (i[None] <= i[:, None]) & (
            i[None] > i[:, None] - window)
    else:
        sdpa["is_causal"] = causal
    sdpa_call = lambda: F.scaled_dot_product_attention(qs, ks, vs, **sdpa)
    library = time_ms(sdpa_call, iters=20, warmup=3)
    kernels = _kernel_names(sdpa_call)
    backend = next((b for sub, b in SDPA_BACKENDS
                    if kernels and sub in kernels[0].lower()),
                   "math" if kernels else "not measured")
    ops = 2 * B * H * _visible_pairs(S, window, causal, Sk) * (Dk + Dv)
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + got.numel())
    b_ms, b_by = bound_ms(nbytes, ops, BF16_OPS_PER_S
                          if dtype == torch.bfloat16 else F32_OPS_PER_S)
    keys = f", Sk {Sk}" if Sk != S else ""
    print(f"flash_attention {name} (B {B}, S {S}{keys}, H {H}, K {K}, Dk "
          f"{Dk}, Dv {Dv}, {'causal' if causal else 'non-causal'}, window "
          f"{window}, {dt}, q x {q_scale}): max abs err "
          f"{max_err:.3e} (rtol {rtol}, atol {atol}); kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us"
          f"{' (one request at a time)' if sliced else ''}, sdpa "
          f"{library * 1e3:.1f} us ({backend}: "
          f"{kernels[0][:60] if kernels else 'no kernel recorded'}), bound "
          f"{b_ms * 1e3:.1f} us ({b_by}: {ops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return {"shape": [B, S, H, K, Dk, Dv], "Sk": Sk, "causal": causal,
            "window": window, "dtype": dt,
            "q_scale": q_scale, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "plain_per_request": sliced,
            "library_ms": library, "library_backend": backend,
            "library_kernel": kernels[0][:90] if kernels else None,
            "bound_ms": b_ms, "bound_by": b_by}


def _kernel_names(fn) -> list:
    """The device kernels one call of ``fn`` launches, by name, the
    longest first (``torch.profiler``); empty where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    took = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            took[e.name] = (took.get(e.name, 0.0) + e.time_range.end
                            - e.time_range.start)
    return sorted(took, key=lambda n: -took[n])


def check_flash_attention(dev):
    """K5 against its plain version at ``FLASH_SHAPES`` (the serving
    prefill's shape first), each timed beside its plain version,
    ``scaled_dot_product_attention`` and the bound."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {case[0]: _flash_case(dev, gen, *case) for case in FLASH_SHAPES}
    path = rows["path"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:87",
            "launches": None, "max_abs_err": path["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"],
            "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
            "library_ms": path["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "shape": path["shape"], "dtype": path["dtype"],
            "routes": FLASH_ROUTES, "shapes": rows}


def _dx_close(got, want, g, rtol, atol):
    """K4's gradient against autograd of the plain version, with the atol
    in dx's own scale: ``dx = g·(p - (1-ε)·[v = y] - ε/V)``, so a row's
    limit is ``atol·g[t] + rtol·|want|``. The step hands the kernel
    g = 1/n_valid (1.2e-4 at 8,192 tokens), where a typical element is
    about 1e-10: a fixed atol of 1e-7 would hold nothing but the target
    column. Returns (ok, max abs err, max err per unit of g)."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol * g[:, None] + rtol * want.float().abs()).all())
    err_max = err.max().item()
    err.div_(g.clamp(min=1e-30)[:, None])
    return ok, err_max, err[g > 0].max().item()


def _xent_case(dev, gen, name, T, V, dt, ignore):
    """K4 at one shape, forward and backward: checked against the plain
    version (the backward against its autograd), then each timed beside
    the plain version, F.cross_entropy on the same inputs and the bound.
    The loss's gradient is what the LM step hands the kernel: 1/n_valid
    on valid rows, 0 on IGNORE rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import smoothed_xent as sx

    dtype = getattr(torch, dt)
    x = (4.0 * torch.randn((T, V), generator=gen, device=dev)).to(dtype)
    labels = torch.randint(0, V, (T,), generator=gen, device=dev,
                           dtype=torch.int32)
    if ignore:
        labels[::3] = -1
    valid = labels >= 0
    g = valid.float() / valid.sum().clamp(min=1)
    eps = 0.1

    nll, lse = sx.smoothed_xent_rows_forward(x, labels, eps)
    dx = sx.smoothed_xent_rows_backward(x, labels, lse, g, eps)
    xp = x.detach().requires_grad_()
    want = ref.smoothed_xent_rows(xp, labels, smoothing=eps)
    (want_dx,) = torch.autograd.grad(want, xp, g, retain_graph=True)
    torch.cuda.synchronize()
    rtol, atol = XENT_FWD_TOL[dt]
    err = (nll - want.detach()).abs()
    errs = {"forward": err.max().item()}
    if not bool((err <= atol + rtol * want.detach().abs()).all()):
        fail(f"smoothed_xent_rows {name} forward disagrees with its plain "
             f"version (rtol {rtol}, atol {atol}): max abs err "
             f"{errs['forward']:.3e}")
    rtol, atol = XENT_BWD_TOL[dt]
    ok, errs["backward"], per_g = _dx_close(dx, want_dx, g, rtol, atol)
    if not ok:
        fail(f"smoothed_xent_rows {name} backward disagrees with autograd of "
             f"its plain version (rtol {rtol}, atol {atol}·g): max abs err "
             f"{errs['backward']:.3e}, {per_g:.3e} per unit of g")
    del want_dx
    if bool(dx[~valid].any()):
        fail(f"smoothed_xent_rows {name}: a masked row's gradient is not 0")
    if not torch.equal(sx.smoothed_xent_rows_forward(x, labels, eps)[0],
                       nll):
        fail(f"smoothed_xent_rows {name}: two calls differ")
    del dx

    it = dict(iters=20, warmup=3) if T * V > 10 ** 8 else {}
    few = dict(iters=5, warmup=1) if T * V > 10 ** 8 else {}
    fwd_ms = time_ms(lambda: ops.smoothed_xent_rows(x, labels, eps), **it)
    bwd_ms = time_ms(lambda: sx.smoothed_xent_rows_backward(
        x, labels, lse, g, eps), **it)
    plain_fwd = time_ms(lambda: ref.smoothed_xent_rows(
        x, labels, smoothing=eps), **few)
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        want, xp, g, retain_graph=True), **few)
    del want, xp
    xl = x.detach().requires_grad_()
    lib = F.cross_entropy(xl, labels.long(), reduction="none",
                          label_smoothing=eps, ignore_index=-1)
    lib_err = (lib.detach().float() - nll)[valid].abs().max().item()
    lib_fwd = time_ms(lambda: F.cross_entropy(
        x, labels.long(), reduction="none", label_smoothing=eps,
        ignore_index=-1), **it)
    gl = g.to(lib.dtype)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib, xl, gl, retain_graph=True), **few)
    del lib, xl
    es = x.element_size()
    n_read = int(g.count_nonzero())       # masked rows: x is not read
    f_ms, f_by = bound_ms(T * V * es + 3 * T * 4, XENT_OPS * T * V)
    b_ms, b_by = bound_ms((T + n_read) * V * es + 3 * T * 4,
                          XENT_OPS * n_read * V)
    print(f"smoothed_xent_rows {name} (T {T}, V {V}, {dt}, "
          f"{T - int(valid.sum())} IGNORE): max abs err forward "
          f"{errs['forward']:.3e}, backward {errs['backward']:.3e} "
          f"({per_g:.3e} per unit of g); "
          f"forward: kernel {fwd_ms * 1e3:.1f} us, plain {plain_fwd * 1e3:.1f}"
          f" us, F.cross_entropy {lib_fwd * 1e3:.1f} us, bound "
          f"{f_ms * 1e3:.1f} us ({f_by}); backward: kernel "
          f"{bwd_ms * 1e3:.1f} us, plain {plain_bwd * 1e3:.1f} us, "
          f"F.cross_entropy {lib_bwd * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us"
          f" ({b_by}); F.cross_entropy rows differ from the kernel's by "
          f"{lib_err:.3e}", flush=True)
    row = {"shape": [T, V], "dtype": dt, "ignore": int(T - valid.sum())}
    return ({**row, "max_abs_err": errs["forward"], "ms": fwd_ms,
             "plain_ms": plain_fwd, "library_ms": lib_fwd, "bound_ms": f_ms,
             "bound_by": f_by, "library_max_abs_diff": lib_err},
            {**row, "max_abs_err": errs["backward"],
             "max_err_per_unit_g": per_g, "ms": bwd_ms,
             "plain_ms": plain_bwd, "library_ms": lib_bwd, "bound_ms": b_ms,
             "bound_by": b_by})


def check_smoothed_xent(dev):
    """K4, forward and backward, at ``XENT_SHAPES`` (the LM training
    path's first): two entries of the kernels line."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    fwd, bwd = {}, {}
    for case in XENT_SHAPES:
        fwd[case[0]], bwd[case[0]] = _xent_case(dev, gen, *case)
        torch.cuda.empty_cache()
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/smoothed_xent.cu",
              "replaces": "src/repro/kernels/smoothed_xent.py:56",
              "launches": None}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "dtype")
    return ({"name": "smoothed_xent_rows", **common,
             **{k: fwd["path"][k] for k in keys},
             "library": "torch.nn.functional.cross_entropy(reduction="
                        "'none', label_smoothing=0.1)", "shapes": fwd},
            {"name": "smoothed_xent_rows_backward", **common,
             **{k: bwd["path"][k] for k in keys},
             "library": "the autograd backward of the same "
                        "F.cross_entropy call",
             "note": "the gradient of K4's function; the reference has no "
                     "backward kernel (XLA differentiates its jnp loss)",
             "shapes": bwd})


def run_lm_train(dev, name="lm_train", cfg=None, steps=LM_STEPS,
                 evals=1, batch=LM_BATCH, seq=LM_SEQ, donate=False):
    """A full-width LM (qwen1.5-0.5b unless ``cfg``) trained through the
    port's entry points, as ``python -m repro.launch.train --arch ...``
    drives the JAX package (here at full width, by default batch 2 x seq
    4096; whisper's and the VLM's batches carry their stub frames):
    ``steps`` steps, then ``evals`` evals (0 or 1) at the end. ``donate``:
    the step writes the masters and momentum in place, as the CLI's does,
    and the first state returned is a copy on the host."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_eval_step, make_train_step

    cfg = cfg or get_config("qwen1.5-0.5b")
    if not cfg.remat or cfg.flash_attention:
        fail(f"{name}: the config must train with remat and without the "
             f"flash kernel")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                         total_steps=steps,
                                         decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    train_step = make_train_step(model, opt, sched, smoothing=0.1,
                                 donate=donate)
    batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", seq,
                                             batch), device=dev)
    torch.cuda.empty_cache()
    state0 = init_state(model, seed=0, device=dev)
    kept = _on(state0, "cpu") if donate else state0
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(
            state0, timed_step, batch_fn, steps=steps,
            eval_step=make_eval_step(model) if evals else None,
            eval_batch_fn=batch_fn if evals else None,
            eval_every=steps if evals else 0, log_every=1, seed=0)
    # K4 once forward and once backward a step and once forward an eval,
    # K1 twice a step; no other kernel
    counts = _read_path(name, {"k4": steps + evals, "k4_bwd": steps,
                               "k1": 2 * steps})
    fwd, bwd, k1 = counts["k4"], counts["k4_bwd"], counts["k1"]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in history if "loss" in h]
    aux = [h["aux"] for h in history if "aux" in h]
    evs = [h["eval_loss"] for h in history if "eval_loss" in h]
    if len(losses) != steps or not all(math.isfinite(v)
                                       for v in losses + aux):
        fail(f"{name}: losses or aux not all finite: {losses}, {aux}")
    if cfg.moe is not None and not all(v > 0 for v in aux):
        fail(f"{name}: the MoE's aux is not positive: {aux}")
    if len(evs) != evals or not all(math.isfinite(v) for v in evs):
        fail(f"{name}: eval gave {evs}")
    if not sink.find("run_stop"):
        fail(f"{name}: loop.train did not reach run_stop")
    q1, med, q3 = statistics.quantiles(times, n=4)
    print(f"{name}: {cfg.arch_id}, {cfg.n_layers} layers; losses "
          f"{[round(v, 4) for v in losses]}; aux {[round(v, 4) for v in aux]}"
          f"{f'; eval loss {evs[0]:.4f}' if evs else ''}", flush=True)
    print(f"{name}: step times ms {[round(t * 1e3, 2) for t in times]}; "
          f"median {med * 1e3:.2f} ms (p25 {q1 * 1e3:.2f}, p75 "
          f"{q3 * 1e3:.2f}), {batch * seq / med:.0f} tokens/s, peak "
          f"memory {peak / 2 ** 30:.2f} GiB; launches K4 forward {fwd}, "
          f"backward {bwd}, K1 {k1}", flush=True)
    result = {"arch": cfg.arch_id, "layers": cfg.n_layers,
              "step_ms": {"p25": q1 * 1e3, "median": med * 1e3,
                          "p75": q3 * 1e3},
              "tokens_per_s": batch * seq / med, "batch": [batch, seq],
              "peak_gib": peak / 2 ** 30, "losses": losses, "aux": aux}
    return model, kept, batch_fn(0), counts, result


def _on(state, dev):
    """A copy of a replicated LM state's params and momentum on ``dev``."""
    from repro_torch.tree import tree_map
    move = lambda x: x.to(dev, copy=True)
    return state._replace(params=tree_map(move, state.params),
                          mom=tree_map(move, state.mom))


def run_lm_train_nemo(dev):
    """mistral-nemo-12b at full width, its depth cut to
    ``NEMO_TRAIN_LAYERS`` layers (its 131,072-token window: the chunked
    attention's window path), trained with lm_train's recipe for
    ``NEMO_TRAIN_STEPS`` steps, no eval, the state donated; then checked
    in context from its first state as lm_train is."""
    import torch
    cfg, depth = _cut_depth("lm_train_nemo", "mistral-nemo-12b",
                            NEMO_TRAIN_LAYERS)
    model, kept, batch, counts, result = run_lm_train(
        dev, "lm_train_nemo", cfg, steps=NEMO_TRAIN_STEPS, evals=0,
        donate=True)
    result["depth_cut"] = [NEMO_TRAIN_LAYERS, depth]
    gc.collect()
    torch.cuda.empty_cache()
    phase("lm_train_nemo context")
    result["context"] = check_lm_train_in_context(
        dev, model, _on(kept, dev), batch, name="lm_train_nemo")
    return counts, result


def run_lm_train_moe(dev):
    """qwen2-moe-a2.7b at full width, its depth cut to ``MOE_TRAIN_LAYERS``
    layers, trained with lm_train's recipe for ``MOE_TRAIN_STEPS`` steps
    (no eval): the router's aux loss in the loss, K4 and K1 on the path."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config("qwen2-moe-a2.7b")
    print(f"lm_train_moe: {cfg.arch_id}'s depth cut to {MOE_TRAIN_LAYERS} "
          f"of its {cfg.n_layers} layers (full width)", flush=True)
    *_, counts, result = run_lm_train(
        dev, "lm_train_moe", dataclasses.replace(cfg,
                                                 n_layers=MOE_TRAIN_LAYERS),
        steps=MOE_TRAIN_STEPS, evals=0)
    result["depth_cut"] = [MOE_TRAIN_LAYERS, cfg.n_layers]
    return counts, result


def run_lm_train_recurrent(dev, name, arch, layers=None):
    """``arch`` at full width (its depth cut to ``layers``, printed, where
    given) trained with lm_train's recipe for ``RECURRENT_TRAIN_STEPS``
    steps, no eval: K4 and K1 on the path, as in lm_train."""
    from repro_torch.configs import get_config
    cfg, depth = get_config(arch), None
    if layers is not None:
        cfg, depth = _cut_depth(name, arch, layers)
    *_, counts, result = run_lm_train(dev, name, cfg,
                                      steps=RECURRENT_TRAIN_STEPS, evals=0)
    if depth is not None:
        result["depth_cut"] = [layers, depth]
    return counts, result


def run_lm_train_frames(dev, name, arch, batch, seq):
    """``arch`` (whisper-base or internvl2-2b) at full width and depth,
    batch x seq tokens with their stub frames, trained with lm_train's
    recipe (remat) for ``RECURRENT_TRAIN_STEPS`` steps, no eval: K4 and K1
    on the path, as in lm_train; the VLM's loss takes no label over its
    image prefix."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    print(f"{name}: {arch} at full width and depth, {batch} x ({seq} "
          f"tokens + {cfg.encoder.n_frames} stub frames)", flush=True)
    *_, counts, result = run_lm_train(dev, name, cfg,
                                      steps=RECURRENT_TRAIN_STEPS, evals=0,
                                      batch=batch, seq=seq)
    return counts, result


def check_lm_train_in_context(dev, model, state0, batch,
                              name="lm_train"):
    """One step with the K4 loss and two with the loss built on K4's plain
    version, from one state and batch; and K4's gradient against autograd
    of the plain version on that step's own logits. Each step's new params
    are moved to the host as it ends, its momentum dropped (three new
    states beside the first would not fit mistral-nemo-12b's on the card).

    The new params cannot agree to 1e-5 of each tensor's max, the bound of
    the ResNet context checks (which compare steps with one loss and so
    one set of gradients). The LM step differentiates the bf16 compute
    copy: K4's dlogits, which differ from autograd's in the last f32 bits,
    round to bf16 differently here and there, and the flipped roundings
    spread through 24 layers of bf16 backward until the weight gradients
    differ by about one bf16 rounding in most elements. The two plain steps
    are bit-identical, so the spread is rounding, not nondeterminism. Held
    instead: the loss to 1e-5 relative, the gradient at the logits to the
    kernel's own bound, the plain steps bit for bit, and each tensor's new
    params to ``LM_UPDATE_TOL`` of its largest update element; the figure
    against the tensor's max is printed beside them."""
    import torch
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import smoothed_xent as sx
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten, tree_map

    sched = make_schedule(ScheduleConfig(base_lr=LM_LR,
                                         total_steps=LM_STEPS))
    step = make_train_step(model, lars.OptConfig(use_kernel=True), sched,
                           smoothing=0.1)
    fwd, bwd = _counters()["k4"], _counters()["k4_bwd"]
    _zero(fwd, bwd)

    def new_params(state, batch):
        out, metrics = step(state, batch)
        params = tree_map(lambda x: x.cpu(), out.params)
        del out
        return params, metrics
    got, m = new_params(state0, batch)
    kernel = ops.smoothed_xent_rows
    ops.smoothed_xent_rows = lambda x, y, s: ref.smoothed_xent_rows(
        x, y, smoothing=s)
    try:
        want, wm = new_params(state0, batch)
        again, _ = new_params(state0, batch)
    finally:
        ops.smoothed_xent_rows = kernel
    torch.cuda.synchronize()
    if (fwd.launches, bwd.launches) != (1, 1):
        fail(f"{name} context: K4 launched {fwd.launches} / "
             f"{bwd.launches} times for one kernel step and two plain steps")
    d_loss = abs(float(m["loss"]) - float(wm["loss"])) / abs(
        float(wm["loss"]))

    # the gradient at the step's own logits, as the loss hands it to K4
    with torch.no_grad():
        (logits, _), _ = model.forward_train(state0.params, batch)
    logits = logits.reshape(-1, logits.shape[-1])
    labels = batch["labels"].reshape(-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    g = valid.float() / valid.sum()
    _, lse = sx.smoothed_xent_rows_forward(logits, safe, 0.1)
    dx = sx.smoothed_xent_rows_backward(logits, safe, lse, g, 0.1)
    xp = logits.requires_grad_()
    (want_dx,) = torch.autograd.grad(
        ref.smoothed_xent_rows(xp, safe, smoothing=0.1), xp, g)
    rtol, atol = XENT_BWD_TOL["float32"]
    dx_ok, dx_err, dx_per_g = _dx_close(dx, want_dx, g, rtol, atol)
    del logits, xp, dx, want_dx

    rows = []
    for (n, a), (_, b), (_, c), (_, p0) in zip(
            tree_flatten(got), tree_flatten(want), tree_flatten(again),
            tree_flatten(state0.params)):
        a, b, c = (x.to(p0.device) for x in (a, b, c))
        d = (a - b).abs().max().item()
        upd = (b - p0).abs().max().item()
        rows.append((n, d / max(b.abs().max().item(), 1e-30),
                     d / max(upd, 1e-30), upd, torch.equal(b, c)))
    of_max = max(rows, key=lambda r: r[1])
    of_upd = max(rows, key=lambda r: r[2])
    print(f"{name} context: K4 loss vs plain loss differ by {d_loss:.3e} "
          f"relative (limit {LM_CONTEXT_TOL}); dlogits by {dx_err:.3e} at "
          f"most, {dx_per_g:.3e} per unit of g (rtol {rtol}, atol "
          f"{atol}·g); two plain steps "
          f"{'bit-identical' if all(r[4] for r in rows) else 'DIFFER'}; new "
          f"params differ by {of_upd[2]:.3e} of the largest update "
          f"({of_upd[0]}; limit {LM_UPDATE_TOL}), by {of_max[1]:.3e} of the "
          f"tensor's max ({of_max[0]}; not held, see the docstring); "
          f"smallest largest-update {min(r[3] for r in rows):.3e}",
          flush=True)
    if not (d_loss <= LM_CONTEXT_TOL and dx_ok and all(r[4] for r in rows)
            and of_upd[2] <= LM_UPDATE_TOL
            and min(r[3] for r in rows) > 0.0):
        fail(f"{name}: the step with the K4 loss disagrees with the "
             f"plain step")
    return {"loss_rel_diff": d_loss, "dlogits_max_abs_err": dx_err,
            "dlogits_max_err_per_unit_g": dx_per_g,
            "param_diff_of_update": [of_upd[0], of_upd[2]],
            "param_diff_of_max": [of_max[0], of_max[1]]}


def _ring_configs(n: int):
    """(mesh, schedule, sharding, gather) of the ring phase on ``n``
    cards: every rung over the data axis, and on four cards the ring
    family and dbtree on the (pod 2, data 2) mesh."""
    out = [("data", "ring", "replicated", None), ("data", "ring", "zero1",
                                                  None),
           ("data", "ring", "zero2", None), ("data", "ring", "zero3",
                                             "per_group")]
    if n == 4:
        out += [("pod", comm, "replicated", None)
                for comm in ("ring", "hierarchical", "2d_torus", "dbtree")]
    return out


def _folds_a_step(mesh, comm: str, n_buckets: int) -> int:
    """K3 launches a step: a ring reduce-scatter along an axis of m ranks
    folds m - 1 times a bucket. ring and 2d_torus reduce-scatter along
    every axis (the shard axis, then the shard's ring across the others);
    hierarchical only along the shard axis (a fused all-reduce across
    pods); psum and dbtree never fold through K3."""
    from repro_torch.comm.schedules import shard_axis
    if comm in ("ring", "2d_torus"):
        return n_buckets * sum(a.size - 1 for a in mesh.axes)
    if comm == "hierarchical":
        return n_buckets * (shard_axis(mesh.axes).size - 1)
    return 0


def _ring_run(model, mesh, comm, sharding, gather, say):
    """One configuration of the ring phase: ``RING_STEPS`` steps of
    full-width ResNet-50 (batch ``BATCH`` a card, the slice's recipe)
    through make_train_step + loop.train, K3 and K2 on; checks the
    launches of K3, K1 and K2 and the losses. Returns its row."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import loop
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step

    dev, n = mesh.device, mesh.size
    sched = make_schedule(ScheduleConfig(
        base_lr=linear_scaled_lr(16.0, BATCH * n) / 4, warmup_steps=1,
        total_steps=RING_STEPS, decay="poly2"))
    step = make_train_step(
        model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                              use_kernel=True),
        sched, smoothing=0.1, mesh=mesh,
        comm=CommConfig(strategy=comm, sharding=sharding, gather=gather,
                        use_kernel=True, update_kernel=True, bucket_mb=4))
    plan = step.bucket_plan
    what = (f"{comm} {sharding}{'/' + gather if gather else ''} on "
            f"{dict(zip(mesh.axis_names, [a.size for a in mesh.axes]))}")
    if plan.n_buckets != 16 or step.sharding != sharding:
        fail(f"ring {what}: {plan.n_buckets} buckets, sharding "
             f"{step.sharding!r}")
    batch_fn = make_batch_fn(model.cfg, InputShape("in", "train", 0,
                                                   BATCH * n),
                             device=dev, mesh=mesh)
    state0 = init_state(model, seed=100000, device=dev,
                        **sharded_state_kwargs(step))
    times = []

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state0, timed_step, batch_fn,
                                    steps=RING_STEPS, log_every=1,
                                    seed=100000)
    nb = plan.n_buckets
    sharded = sharding != "replicated"
    counts = _read_path(f"ring {what}", {
        "k3": _folds_a_step(mesh, comm, nb) * RING_STEPS,
        "k1": (1 if sharded else 2) * RING_STEPS,
        "k2": (1 if sharded else 0) * RING_STEPS})
    a_step = {key: v / RING_STEPS for key, v in counts.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * n
    dist.all_gather_object(peaks, peak)
    del state, state0
    losses = [h["loss"] for h in history]
    if len(losses) != RING_STEPS or not all(math.isfinite(v)
                                            for v in losses):
        fail(f"ring {what}: losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail(f"ring {what}: loop.train did not reach run_stop")
    med = statistics.median(times[1:])      # the first step warms up
    say(f"ring: {what}: losses {[round(v, 4) for v in losses]}; step times "
        f"ms {[round(t * 1e3, 2) for t in times]}, median after the first "
        f"{med * 1e3:.2f} ms, {BATCH * n / med:.1f} images/s on {n} cards; "
        f"peak memory a "
        f"rank GiB {[round(p / 2 ** 30, 2) for p in peaks]}; launches a "
        f"step K3 {a_step['k3']:g}, K1 {a_step['k1']:g}, K2 "
        f"{a_step['k2']:g}")
    return {"mesh": dict(zip(mesh.axis_names, [a.size for a in mesh.axes])),
            "comm": comm, "sharding": sharding, "gather": gather,
            "step_ms": [t * 1e3 for t in times], "median_ms": med * 1e3,
            "images_per_s": BATCH * n / med,
            "peak_gib": [p / 2 ** 30 for p in peaks], "launches": counts,
            "k3_a_step": a_step["k3"], "losses": losses}


def _ring_bits(model, meshes, batch, say):
    """One packed bf16 gradient (this rank's, from one backward) through
    the ring all-reduce and every schedule's reduce-scatter form, with K3
    and with the plain fold: the outputs must be equal bit for bit. Only
    the ring all-reduce and the ring, hierarchical and 2d_torus forms fold
    through K3 (psum and dbtree ignore ``use_kernel``), so those are
    counted apart: returns (compared, of them through K3). The
    ring all-reduce pads its rows to CHUNK only with the kernel (and
    beyond two ranks the chunk cut sets the order of the sums), so its
    plain side is the same ring at ``pad_to=CHUNK``."""
    import torch
    from repro_torch.comm import get_reduce_scatter, get_schedule
    from repro_torch.comm import primitives as prim
    from repro_torch.comm import ring_kernel
    from repro_torch.core import bucketing
    from repro_torch.core.bucketing import CHUNK
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_flatten, tree_unflatten

    dev = next(iter(meshes.values())).device
    s0 = init_state(model, seed=7, device=dev)
    flat = tree_flatten(s0.params)
    leaves = [x.detach().requires_grad_() for _, x in flat]
    total, _ = make_loss_fn(model)(tree_unflatten([p for p, _ in flat],
                                                  leaves), batch,
                                   s0.bn_state)
    grads = tree_unflatten([p for p, _ in flat],
                           torch.autograd.grad(total, leaves))
    plan = bucketing.make_plan(model.param_pd)
    bufs = bucketing.pack(grads, plan, dtype=torch.bfloat16)
    del grads, leaves, total
    names = ("psum", "ring", "hierarchical", "2d_torus", "dbtree")
    compared = folded = 0
    for mname, mesh in meshes.items():
        axes = mesh.axes
        before = ring_kernel.ring_add_step.launches
        for b, buf in enumerate(bufs):
            got = get_schedule("ring")(buf.clone(), axes, use_kernel=True)
            want = buf.clone()
            for axis in reversed(axes):
                want = prim.ring_all_reduce(want, axis,
                                            step_fn=prim.default_step_fn,
                                            pad_to=CHUNK)
            pairs = [("ring", got, want)]
            for name in names:
                rs = get_reduce_scatter(name)
                pairs.append((f"{name} reduce-scatter",
                              rs(buf.clone(), axes, use_kernel=True),
                              rs(buf.clone(), axes, use_kernel=False)))
            for what, x, y in pairs:
                if x.dtype != torch.bfloat16 or not torch.equal(x, y):
                    fail(f"ring context: {what} on {mname}, bucket {b}: "
                         f"K3 and the plain fold differ")
                compared += 1
                folded += not what.startswith(("psum", "dbtree"))
        if ring_kernel.ring_add_step.launches == before:
            fail(f"ring context: K3 was not launched on {mname}")
    say(f"ring context: a packed bf16 gradient ({plan.n_buckets} buckets) "
        f"through the ring all-reduce and the reduce-scatter forms of "
        f"{list(names)} on {list(meshes)}: {compared} outputs bit-equal with "
        f"K3 and with the plain fold, {folded} of them folded through K3 "
        f"(psum and dbtree ignore use_kernel)")
    return compared, folded


def _ring_masters(model, meshes, batch, say):
    """With f32 wire, every schedule and rung (K1, K2 and K3 on) against
    the replicated psum step (per-tensor norms, no kernel) from one state
    and batch: the masters must agree to 1e-5 of each tensor's max, the
    bar of ``check_zero1_in_context``."""
    import torch
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.train import state as st
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    dev = next(iter(meshes.values())).device
    sched = make_schedule(ScheduleConfig(base_lr=1.0, total_steps=STEPS))
    s0 = st.init_state(model, seed=7, device=dev)
    worst_all, rows = 0.0, {}
    torch.backends.cudnn.deterministic = True
    try:
        for mname, mesh in meshes.items():
            comm = lambda **kw: CommConfig(wire_dtype="f32", bucket_mb=4,
                                           **kw)
            want = make_train_step(
                model, lars.OptConfig(use_kernel=False), sched, mesh=mesh,
                comm=comm(strategy="psum"))(s0, batch)[0].params
            for name in ("naive", "psum", "bucketed", "ring",
                         "hierarchical", "2d_torus", "dbtree"):
                rungs = (("replicated",) if name == "naive" else
                         ("replicated", "zero1", "zero2", "zero3"))
                for sharding in rungs:
                    step = make_train_step(
                        model, lars.OptConfig(use_kernel=True), sched,
                        mesh=mesh, comm=comm(strategy=name,
                                             sharding=sharding,
                                             use_kernel=True,
                                             update_kernel=True))
                    state = s0
                    if sharding != "replicated":
                        plan, n = step.bucket_plan, step.n_shards
                        i = mesh.axis(step.shard_axis).index
                        packed = lambda tree: st.local_shards(
                            st.init_packed_shards(tree, plan, n), n, i)
                        state = st.TrainState(
                            0, None if sharding == "zero3" else s0.params,
                            packed(s0.mom), s0.bn_state,
                            None if sharding == "zero2"
                            else packed(s0.params))
                    got = make_params_reader(step)(step(state, batch)[0])
                    worst = 0.0
                    for (_, a), (_, b) in zip(tree_flatten(got),
                                              tree_flatten(want)):
                        worst = max(worst, (a - b).abs().max().item()
                                    / max(b.abs().max().item(), 1e-30))
                    rows[f"{mname}/{name}/{sharding}"] = worst
                    worst_all = max(worst_all, worst)
                    if not worst <= 1e-5:
                        fail(f"ring context: {name} {sharding} on {mname}: "
                             f"masters {worst:.3e} of a tensor's max from "
                             f"the replicated psum step (limit 1e-5)")
                    del got, state
    finally:
        torch.backends.cudnn.deterministic = False
    say(f"ring context: f32 wire, {len(rows)} schedule x rung steps on "
        f"{list(meshes)} against the replicated psum step: masters within "
        f"{worst_all:.3e} of each tensor's max (limit 1e-5)")
    return worst_all, rows


def ring_rank():
    """One rank of the ring phases (``chip_smoke.py --ring-rank`` under
    torch.distributed.run, one card each): the ring phase's
    configurations, then the ring context. Rank 0 prints the lines and,
    last, ``ring-json: {...}``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.models.registry import build_model

    base = make_local_mesh()
    n, rank = base.size, base.rank
    say = (lambda msg: print(msg, flush=True)) if rank == 0 else \
        (lambda msg: None)
    meshes = {"data": base}
    if n == 4:
        meshes["pod"] = make_mesh((2, 2), ("pod", "data"))
    model = build_model(get_config("resnet50"))
    rows = [_ring_run(model, meshes[m], comm, sharding, gather, say)
            for m, comm, sharding, gather in _ring_configs(n)]
    torch.cuda.empty_cache()
    batch = make_batch_fn(model.cfg, InputShape("in", "train", 0, BATCH * n),
                          device=base.device, mesh=base)(0)
    compared, folded = _ring_bits(model, meshes, batch, say)
    worst, masters = _ring_masters(model, meshes, batch, say)
    say("ring-json: " + json.dumps({"cards": n, "runs": rows,
                                    "bit_equal_outputs": compared,
                                    "bit_equal_through_k3": folded,
                                    "masters_worst": worst,
                                    "masters": masters}))
    base.destroy()


#: the four-card model-axis phases (ROADMAP §1 item 6.2), one rank a card
#: over NCCL. serve_tp: qwen1.5-32b at full width and depth (35.2 B
#: params, ~70.4 GB in bf16: no one card holds it) at model 4, K5 on a
#: rank's 10 of its 40 heads once a layer, TP_SERVE (requests, prompt
#: tokens, new tokens); its context check at TP_CONTEXT_LAYERS of the 64
#: layers, model 4 against model 1 on rank 0's card, TP_CONTEXT_NEW
#: greedy tokens. lm_train_tp: qwen1.5-0.5b at full width and depth on the
#: (data 2, model 2) mesh (its tied embedding splits the vocabulary),
#: TP_TRAIN (sequences, tokens) a data rank, TP_TRAIN_STEPS comm='xla'
#: steps, held against the one-card step at the same global batch: the
#: masters within LM_UPDATE_TOL of each tensor's largest update, the
#: losses within TP_LOSS_TOL relative (the bf16 step's loss bound of
#: tests/test_torch_tp.py). TP_TIMEOUT_S bounds the ranks' launch: the
#: MoE and MLA phases together take ~700 s (PERF.md §6)
TP_SERVE = (8, 2048, 32)
TP_CONTEXT_LAYERS, TP_CONTEXT_NEW = 4, 8
TP_TRAIN, TP_TRAIN_STEPS = (1, 4096), 3
TP_LOSS_TOL = 4e-4
TP_TIMEOUT_S = 1400
#: the phase's CLI runs on four ranks, each main() called in the ranks'
#: own processes: --model-parallel 2 --comm xla with the dense decoder and
#: with the hybrid (reduced), ResNet-50 under --comm xla; since item 6.2c
#: the dense decoder's checkpoints at --model-parallel 2 ({ckpt}: a
#: directory the ranks share) resumed by --resume-elastic at
#: --model-parallel 4 (it must report step TP_CLI_RESUMED_AT restored),
#: and whisper (reduced) at --model-parallel 2; since item 6.3's experts
#: the reduced qwen2-moe-a2.7b at --model-parallel 2 and at model 1 over
#: the four ranks
TP_CLI = ("--arch", "qwen1.5-0.5b", "--model-parallel", "2", "--comm",
          "xla", "--steps", "3", "--batch", "4", "--seq", "1024")
TP_CLI_CKPT = ("--arch", "qwen1.5-0.5b", "--comm", "xla", "--batch", "4",
               "--seq", "1024", "--ckpt-dir", "{ckpt}")
TP_CLI_RESUMED_AT = 2
TP_CLI_RUNS = (TP_CLI,
               ("--arch", "resnet50", "--comm", "xla", "--steps", "3",
                "--batch", "256"),
               ("--arch", "zamba2-7b", "--reduced", "--model-parallel", "2",
                "--comm", "xla", "--steps", "3", "--batch", "4", "--seq",
                "256"),
               (*TP_CLI_CKPT, "--model-parallel", "2", "--steps",
                str(TP_CLI_RESUMED_AT), "--ckpt-every", "1",
                "--keep-last-k", "1"),
               (*TP_CLI_CKPT, "--model-parallel", "4", "--steps",
                str(TP_CLI_RESUMED_AT + 1), "--resume-elastic"),
               ("--arch", "whisper-base", "--reduced", "--model-parallel",
                "2", "--comm", "xla", "--steps", "3", "--batch", "4",
                "--seq", "64"),
               ("--arch", "qwen2-moe-a2.7b", "--reduced", "--model-parallel",
                "2", "--comm", "xla", "--steps", "3"),
               ("--arch", "qwen2-moe-a2.7b", "--reduced", "--comm", "xla",
                "--steps", "3"))
#: the slice-18 four-card phases (ROADMAP §1 item 6.2b). serve_tp_hybrid:
#: zamba2-7b at full width and depth at model 4 (a rank: 28 of its 112 SSM
#: heads, 8 of its 32 attention heads of 112, 3,584 of its 14,336 FFN
#: columns, 8,000 of its 32,000 vocabulary rows), flash_attention, at
#: serve_hybrid's sizes; its context on rank 0's card, model 4 against
#: model 1: in f32 at TP_HYBRID_F32_LAYERS layers (two shared-block
#: applications) on SERVE_F32_REQUESTS requests within SERVE_F32_TOL (the
#: gate), and at full depth in bf16 within HYBRID_SERVE_TOL (a sanity
#: bound: 95 blocks add the two bf16 paths' roundings up)
TP_HYBRID_F32_LAYERS = 12
#: lm_train_tp_xlstm: xlstm-125m whole at (data 2, model 2), wholly in f32,
#: TP_XLSTM_TRAIN (sequences, tokens) a data rank, TP_XLSTM_STEPS LARS
#: steps against the one-card step on the same global batch: losses
#: within TP_XLSTM_LOSS_TOL relative, masters within TP_XLSTM_UPDATE_TOL
#: of each tensor's largest update (the sLSTM's input-gate biases, whose
#: gradient vanishes, of the tree's largest update)
TP_XLSTM_TRAIN, TP_XLSTM_STEPS = (1, 1024), 2
TP_XLSTM_LOSS_TOL, TP_XLSTM_UPDATE_TOL = 1e-5, 5e-4
#: resnet_xla: ResNet-50 at full width under comm='xla' on (data 4, model
#: 1), LARS with K1, bf16 compute, RESNET_XLA_BATCH images a rank,
#: RESNET_XLA_STEPS steps in each sync_bn form. The gates: every rank's
#: masters, momentum and BN state the same bits (the statistics are
#: global: per-process ones would part the ranks), and step 1 against the
#: one-card step on the same global batch from the same state, (loss
#: relative, every new BN running statistic relative to its tensor's max,
#: the median tensor's update relative L2) within RESNET_XLA_TOL; the
#: later steps printed, and the four ranks on the same RESNET_XLA_BATCH
#: images against the one card's step on them over a one-rank mesh (the
#: data axis's sums then 4 x the rank's). The one-card comparison is a
#: sanity bound: bf16 ResNet-50 at random init is chaotic at full width
#: as at reduced size (ROADMAP §3). The statistics' last-bit differences
#: (f32 sums in another order, cuDNN's algorithms at 64 images and at
#: 256) flip bf16 roundings that grow through the blocks: from pinit's
#: state a median tensor's update parts from the one card's by 1.0
#: relative L2, the loss within 1e-4; with each residual branch's last BN
#: scale damped to RESNET_XLA_BN3_SCALE (as the CPU parity tests damp it,
#: tests/torch_reference.py BN3_SCALE) by 0.15, the statistics within
#: 1.9e-4 (my chip runs, PR 29). So the gated runs start damped, and one
#: step from pinit's state is printed beside them
RESNET_XLA_BATCH, RESNET_XLA_STEPS = 64, 3
RESNET_XLA_TOL = (1e-3, 2e-3, 0.5)
RESNET_XLA_BN3_SCALE = 0.1
#: ResNet-50's ring replicated step on four cards (PR 27's run r1), printed
#: beside resnet_xla's median
RING_REPLICATED_MS = 143.59
#: the slice-19 four-card phases (ROADMAP §1 item 6.2c). whisper-base's
#: and internvl2-2b's published vocabularies (51,865 and 92,553) are odd:
#: the untied lm_head splits by vocabulary columns over the model axis, and
#: neither package can place an odd V over model > 1
#: (models/common.py uneven_split), so over the axis they run with only
#: the vocabulary cut, to the multiple of TP_VOCAB_MULTIPLE below it
#: (printed), their model-1 yardsticks on the same cut config
TP_VOCAB_MULTIPLE = 4
#: ckpt_tp: lm_train_tp's model and recipe at (data 2, model 2),
#: TP_CKPT_STEPS steps through loop.train with a checkpoint a step, then a
#: resume for one more
TP_CKPT_STEPS = 2
#: lm_train_tp_frames: (arch, (sequences, tokens) a data rank), each
#: sequence with its stub frames, TP_TRAIN_STEPS steps at (data 2, model
#: 2) against the one-card step at the global batch (lm_train_tp's bounds)
TP_FRAMES_TRAIN = (("whisper-base", (4, 448)), ("internvl2-2b", (1, 3840)))
#: the slice-20 four-card phases (ROADMAP §1 item 6.3's experts).
#: serve_tp_moe: qwen2-moe-a2.7b whole at model 4 (a rank: 16 of the 64
#: experts its 60 pad to, 4 of 16 heads of 128, 1,408 of the shared
#: experts' 5,632 columns, 37,984 of 151,936 vocabulary columns),
#: flash_attention, at TP_SERVE; its context at TP_CONTEXT_LAYERS layers
#: against one card's run of the same params with the MoE layer chunked as
#: model 4 chunks it (``_moe_chunked(1, 4)``: each 512-token chunk routed
#: with its own capacity), then at SERVE_MOE_CF against one card's
#: unchunked layer (no choice dropped on either side: the capacity passes
#: a chunk's tokens, so the chunking changes nothing there)
#: lm_train_tp_moe: (a) lm_train_tp's recipe at its MOE_TRAIN_LAYERS at
#: (data 2, model 2) against one card at the global batch with the layer
#: chunked as (2, 2) chunks it; (b) TP_MOE_DEEP_LAYERS layers at (data 1,
#: model 4), TP_TRAIN a rank, TP_TRAIN_STEPS steps, remat: finite losses,
#: the replicated masters the same bits on every rank, the step's time,
#: tokens/s and peak memory (PERF.md §6 reckons its memory)
TP_MOE_DEEP_LAYERS = 24
#: serve_moe's prefill on one H100 (ms; PERF.md §5), printed beside
#: serve_tp_moe's
SERVE_MOE_ONE_CARD_MS = 345.46
#: the model-axis MoE phases' one-card yardsticks replay the ranks' expert
#: choices (``_RoutingPin.hold``): the card's own top-k may part from them
#: only at near-ties, by at most ROUTE_GAP_TOL in probability (1.7 times
#: the largest reading on H100s, 2.948e-3) and in at most ROUTE_FLIP_SHARE
#: of the token-layers (read: 3.6% and 5.5%; PERF.md §6)
ROUTE_GAP_TOL = 5e-3
ROUTE_FLIP_SHARE = 0.1
#: the slice-21 four-card phases (ROADMAP §1 item 6.3's MLA part).
#: serve_tp_mla: deepseek-v2-236b at full width, its 60 layers cut to
#: TP_MLA_LAYERS (33.39 B params; a rank: 32 of 128 heads, 40 of 160
#: experts, 8.41 B params, 16.8 GB in bf16), model 4, flash_attention, at
#: TP_SERVE; its context at TP_CONTEXT_LAYERS (serve_mla's MLA_LAYERS)
#: against one card's run of the same params with the MoE layer chunked as
#: model 4 chunks it, on the ranks' expert choices (serve_tp_moe's gates).
#: lm_train_tp_mla: lm_train_tp's recipe at full width, TP_MLA_TRAIN_LAYERS
#: layers (5.09 B params), (data 2, model 2), TP_MLA_TRAIN a data rank,
#: the state donated, against one card at the global batch with the MoE
#: layer chunked alike (one card holds 5.09 B x (4 + 4) bytes of masters
#: and momentum, the bf16 copy and gradients, the expert stacks' gradients
#: twice over in the backward and the chunked attention's f32 scores: at
#: 1 x 2,048 a data rank it ran out of memory, so the sequence is cut to
#: 1,024; and K1's f32 pack of the whole masters found no room in its
#: fragmented pool, so the one card takes LARS's per-tensor norms; PERF.md
#: §6). The
#: published config's ``fsdp`` (the masters split over data) is item 6.3's
#: fsdp part, refused over data ranks: the phase trains with it off
TP_MLA_LAYERS = 8
TP_MLA_TRAIN_LAYERS, TP_MLA_TRAIN = 1, (1, 1024)
#: the phases of ``--tp``, in order
TP_PHASES = ("serve_tp", "lm_train_tp", "serve_tp_hybrid",
             "lm_train_tp_xlstm", "resnet_xla", "ckpt_tp", "serve_tp_audio",
             "serve_tp_vlm", "lm_train_tp_frames", "serve_tp_moe",
             "lm_train_tp_moe", "serve_tp_mla", "lm_train_tp_mla", "cli")


def _collectives():
    """A context that counts ``torch.distributed``'s all_reduce,
    all_gather and all_to_all_single calls (``{'all_reduce': n, ...}``:
    ``launch.profile_serve.counting_collectives``)."""
    from repro_torch.launch.profile_serve import counting_collectives
    return counting_collectives()


def _greedy_rule(model, params, batch, want, got, cache_len, margin,
                 name="serve_tp"):
    """``tests/torch_reference.py``'s greedy-token rule on one card:
    along the tokens ``want`` (teacher-forced through ``model``'s prefill
    and decode), each is within ``margin`` of the step's largest |logit|
    of ``model``'s largest logit, and each request's ``got`` equals
    ``want`` up to its first step whose two largest logits lie within that
    margin of each other. Returns the tied steps a request, or fails
    (naming the phase ``name``)."""
    import torch
    logits, cache = model.forward_prefill(params, batch, cache_len)
    pos = _prompt_pos(model.cfg, batch)
    n = want.shape[1]
    tied = torch.zeros(want.shape, dtype=torch.bool)
    for i in range(n):
        lg = logits[:, -1].float()
        top = torch.topk(lg, 2).values
        m = margin * lg.abs().amax(dim=-1)
        picked = lg.gather(1, want[:, i:i + 1].long())[:, 0]
        if not bool((top[:, 0] - picked <= m).all()):
            fail(f"{name} context: step {i}'s model-4 token is not within "
                 f"{margin} of the one-card model's largest logit")
        tied[:, i] = (top[:, 0] - top[:, 1] <= m).cpu()
        if i + 1 < n:
            logits, cache = model.forward_decode(params, cache,
                                                 want[:, i:i + 1], pos + i)
    for b in range(want.shape[0]):
        first = int(tied[b].int().argmax()) if tied[b].any() else n
        if not torch.equal(got[b, :first].cpu(), want[b, :first].cpu()):
            fail(f"{name} context: request {b}'s tokens part before its "
                 f"first tie")
    return tied.sum(1).tolist()


def _serve_tp(mesh, say) -> dict:
    """serve_tp on this rank (TP_SERVE at model 4), then its context
    check. Rank 0's row."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.core.precision import cast_to_compute
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.tree import tree_leaves

    dev, n = mesh.device, mesh.size
    cfg = dataclasses.replace(get_config("qwen1.5-32b"), flash_attention=True)
    model = build_model(cfg)
    n_req, n_prompt, n_new = TP_SERVE
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    params = pinit.materialize(model.param_pd, seed=0, device=dev,
                               dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    dist.barrier()
    all_init_s = time.perf_counter() - t
    n_local = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (n_req, n_prompt),
                           generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": tokens}
    cache_len = _serve_cache(cfg, batch, n_new)
    generate(model, params, batch, max_new=2, cache_len=cache_len,
             mesh=mesh)                    # warm-up: not timed, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    _zero(*_counters().values())
    out = generate(model, params, batch, max_new=n_new, cache_len=cache_len,
                   timings=timings, mesh=mesh)
    torch.cuda.synchronize()
    counts = _read_path("serve_tp", {"k5": cfg.n_layers})
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad(), _collectives() as calls:
        last, _ = model.forward_prefill(cast_to_compute(params), batch,
                                        cache_len, mesh)
    if calls["all_reduce"] != 2 * cfg.n_layers:
        fail(f"serve_tp: {calls['all_reduce']} all-reduces a prefill; the "
             f"model axis makes 2 a layer ({2 * cfg.n_layers})")
    if not bool(torch.isfinite(last).all()):
        fail("serve_tp: non-finite prefill logits")
    outs, peaks, inits = ([None] * n for _ in range(3))
    dist.all_gather_object(outs, out.cpu())
    dist.all_gather_object(peaks, peak)
    dist.all_gather_object(inits, init_s)
    if tuple(out.shape) != (n_req, n_new) or not all(
            torch.equal(o, outs[0]) for o in outs):
        fail(f"serve_tp: the ranks' tokens differ or have shape "
             f"{tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail("serve_tp: a token outside the vocabulary")
    dec = timings["decode_ms"]
    q1, med, q3 = statistics.quantiles(dec, n=4)
    rate = n_req * n_prompt / timings["prefill_ms"] * 1e3
    say(f"serve_tp: {cfg.arch_id}, {cfg.n_layers} layers at full width, "
        f"model {n}: {n_local / 1e9:.3f} B params a rank (bf16), pinit "
        f"{all_init_s:.2f} s (the ranks' own: "
        f"{[round(s, 2) for s in inits]}); {n_req} requests of {n_prompt} "
        f"tokens, {n_new} new, cache {cache_len} rows; prefill "
        f"{timings['prefill_ms']:.2f} ms ({rate:.0f} prompt tokens/s); "
        f"decode ms a token median {med:.3f} (p25 "
        f"{q1:.3f}, p75 {q3:.3f}, {len(dec)} steps), {n_req * 1e3 / med:.1f}"
        f" tokens/s; peak memory a rank GiB "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; a prefill: "
        f"{calls['all_reduce']} all-reduces, {calls['all_gather']} "
        f"all-gathers, flash_attention {counts['k5']} launches a rank; "
        f"every rank's tokens equal")
    say(f"serve_tp: first request's tokens {out[0].tolist()}")
    row = {"arch": cfg.arch_id, "layers": cfg.n_layers, "model": n,
           "params_a_rank": n_local, "pinit_s": all_init_s,
           "pinit_rank_s": inits, "prefill_ms": timings["prefill_ms"],
           "decode_ms": {"p25": q1, "median": med, "p75": q3},
           "tokens_per_s": n_req * 1e3 / med,
           "peak_gib": [p / 2 ** 30 for p in peaks], "sizes": list(TP_SERVE),
           "cache_len": cache_len, "collectives_a_prefill": calls,
           "launches": counts}
    del params, out, last
    gc.collect()
    torch.cuda.empty_cache()

    # context: TP_CONTEXT_LAYERS layers at full width, model 4 against
    # model 1 on rank 0's card (the same values: the shards gathered)
    cfg4 = dataclasses.replace(cfg, n_layers=TP_CONTEXT_LAYERS)
    model4 = build_model(cfg4)
    p4 = pinit.materialize(model4.param_pd, seed=0, device=dev,
                           dtype=torch.bfloat16, mesh=mesh)
    with torch.no_grad():
        last4, _ = model4.forward_prefill(p4, batch, cache_len, mesh)
    tp_tokens = generate(model4, p4, batch, max_new=TP_CONTEXT_NEW,
                         cache_len=cache_len, mesh=mesh)
    whole = weights.gather_tree(p4, model4.param_pd, mesh)
    del p4
    if mesh.rank == 0:
        with torch.no_grad():
            last1, _ = model4.forward_prefill(whole, batch, cache_len)
            d = _rel(last4.float(), last1.float())
            one_tokens = generate(model4, whole, batch,
                                  max_new=TP_CONTEXT_NEW, cache_len=cache_len)
            ties = _greedy_rule(model4, whole, batch, tp_tokens, one_tokens,
                                cache_len, SERVE_TOL)
        say(f"serve_tp context: {cfg.arch_id} at {TP_CONTEXT_LAYERS} of its "
            f"{cfg.n_layers} layers (full width), model {n} against model 1 "
            f"on one card: prefill logits differ by {d:.3e} of their max "
            f"(limit {SERVE_TOL}); {TP_CONTEXT_NEW} greedy tokens within the "
            f"rule (margin {SERVE_TOL} of the max), tied steps a request "
            f"{ties}")
        if not d <= SERVE_TOL:
            fail("serve_tp context: model 4's prefill disagrees with model "
                 "1's")
        row["context"] = {"layers": TP_CONTEXT_LAYERS, "prefill_vs_one": d,
                          "ties": ties}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return row


def _lm_train_tp(say, name="lm_train_tp", cfg=None,
                 rows_seq=TP_TRAIN, moe_chunks=None, donate=False) -> dict:
    """lm_train_tp on this rank: TP_TRAIN_STEPS comm='xla' steps on the
    (data 2, model 2) mesh, then rank 0 runs the one-card step over the
    same global batches from the same initial values and holds the
    masters and losses against it. ``cfg`` (default qwen1.5-0.5b) and
    ``rows_seq`` (sequences, tokens a data rank; whisper's and the VLM's
    with their stub frames): lm_train_tp_frames' runs. ``moe_chunks``
    (lm_train_tp_moe): the one-card step's MoE layer chunked as the mesh
    chunks it (``_moe_chunked``), each chunk taking the expert choices its
    rank made (``_RoutingPin``: among 60 experts two bf16 paths part at
    near-ties, and a flipped choice moves the router's update by far more
    than rounding; the choices that differ are printed), and the
    replicated masters (the router, the norms) must be the same bits on
    every rank. ``donate`` (lm_train_tp_mla): both steps write the masters
    and momentum in place, rank 0 keeps the whole initial and final
    masters of the mesh's run on the host, and the one card's LARS takes
    the per-tensor norms (the one card holds one state of the whole model
    and its step, no more). Rank 0's row."""
    import contextlib
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import dp_axes
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    mesh = make_local_mesh(2)
    dev = mesh.device
    cfg = cfg or get_config("qwen1.5-0.5b")
    if not cfg.remat or cfg.flash_attention:
        fail(f"{name}: the config must train with remat and without the "
             f"flash kernel")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                         total_steps=TP_TRAIN_STEPS,
                                         decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    rows_a_rank, seq = rows_seq
    n_data = mesh.axis("data").size
    shape = InputShape("train_4k", "train", seq, rows_a_rank * n_data)
    step = make_train_step(model, opt, sched, smoothing=0.1, mesh=mesh,
                           comm="xla", donate=donate)
    part = make_batch_fn(cfg, shape, device=dev, mesh=mesh,
                         axes=dp_axes(mesh))
    torch.cuda.empty_cache()
    state = init_state(model, 0, device=dev, **sharded_state_kwargs(step))

    def whole(params):
        """The masters gathered whole (a collective), on the host where
        donated, and only on rank 0."""
        tree = tree_flatten(weights.gather_tree(params, model.param_pd,
                                                mesh))
        if not donate:
            return dict(tree)
        return ({p: x.to("cpu", copy=True) for p, x in tree}
                if mesh.rank == 0 else {})
    p0 = whole(state.params)
    times, losses = [], []
    pin = _RoutingPin() if moe_chunks is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(*_counters().values())
    for i in range(TP_TRAIN_STEPS):
        batch = part(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with pin.record() if pin else contextlib.nullcontext():
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
    counts = _read_path(name, {"k4": TP_TRAIN_STEPS,
                                        "k4_bwd": TP_TRAIN_STEPS,
                                        "k1": 2 * TP_TRAIN_STEPS})
    routes = rep_same = None
    if pin is not None:
        # each rank's choices, call by call (the remat recompute's too);
        # the chunked one-card layer routes the chunks rank by rank
        routes = [None] * mesh.size
        dist.all_gather_object(routes, [x.cpu() for x in pin.ids])
        routes = [r[i].to(dev) for i in range(len(routes[0]))
                  for r in routes]
        rep_same = _replicated_same(state, model, mesh)
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * mesh.size
    dist.all_gather_object(peaks, peak)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{name}: losses not all finite: {losses}")
    got = whole(state.params)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    row = None
    if mesh.rank == 0:
        # donated: the one card takes each tensor's norm apart, since
        # K1's one call packs the whole masters in f32 (19 GiB at 5.09 B
        # params), which the card's fragmented pool did not find room for
        one = make_train_step(model, dataclasses.replace(
            opt, use_kernel=not donate), sched, smoothing=0.1, comm="xla",
            donate=donate)
        full = make_batch_fn(cfg, shape, device=dev)
        s1 = init_state(model, 0, device=dev)
        init_same = all(torch.equal(x, p0[p].to(dev))
                        for p, x in tree_flatten(s1.params))
        ones = []
        pinned = contextlib.nullcontext()
        if moe_chunks is not None:
            replay = _RoutingPin()
            pinned = contextlib.ExitStack()
            pinned.enter_context(_moe_chunked(*moe_chunks))
            pinned.enter_context(replay.replay(routes))
        torch.cuda.reset_peak_memory_stats(dev)
        with pinned:
            for i in range(TP_TRAIN_STEPS):
                s1, m1 = one(s1, full(i))
                ones.append(float(m1["loss"]))
        one_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        want = dict(tree_flatten(s1.params))
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ones))
        worst = max(((got[p].to(dev) - want[p]).abs().max().item()
                     / max((want[p] - p0[p].to(dev)).abs().max().item(),
                           1e-30), p)
                    for p in want)
        med = statistics.median(times[1:])
        tokens = rows_a_rank * seq * n_data
        frames = (f" + {cfg.encoder.n_frames} stub frames"
                  if cfg.encoder is not None else "")
        say(f"{name}: {cfg.arch_id}, {cfg.n_layers} layers at full "
            f"width, (data {n_data}, model {mesh.axis('model').size}), "
            f"comm='xla', remat, LARS with K1, {rows_a_rank} x ({seq} tokens"
            f"{frames}) a data rank: losses {[round(v, 4) for v in losses]} (one card "
            f"at the global batch {[round(v, 4) for v in ones]}: within "
            f"{d_loss:.3e} relative, limit {TP_LOSS_TOL}); masters within "
            f"{worst[0]:.3e} of the one-card step's largest update of their "
            f"tensor ({worst[1]}; limit {LM_UPDATE_TOL}); initial values "
            f"{'equal' if init_same else 'DIFFERENT'}; step times ms "
            f"{[round(x * 1e3, 2) for x in times]}, median after the first "
            f"{med * 1e3:.2f} ms, {tokens / med:.0f} tokens/s on "
            f"{mesh.size} cards; peak memory a rank GiB "
            f"{[round(p / 2 ** 30, 2) for p in peaks]} (the one card "
            f"{one_peak:.2f}{', its LARS without K1' if donate else ''}); "
            f"launches K4 "
            f"{counts['k4']} + {counts['k4_bwd']}, K1 {counts['k1']}"
            + ("" if rep_same is None else
               f"; the one card's MoE layer chunked as (data "
               f"{moe_chunks[0]}, model {moe_chunks[1]}) chunks it, each "
               f"chunk on its rank's expert choices (its own top-"
               f"{cfg.moe.top_k} differs in {replay.flips} of "
               f"{replay.choices} token-layers, by at most "
               f"{replay.gap:.3e} in probability; limits "
               f"{ROUTE_FLIP_SHARE} of them and {ROUTE_GAP_TOL}); "
               f"replicated masters and "
               f"momentum "
               f"{'the same bits on every rank' if rep_same else 'DIFFER'}"))
        if rep_same is False:
            fail(f"{name}: the replicated masters differ between ranks")
        if not init_same:
            fail(f"{name}: the shards' initial values are not the "
                 f"one-card state's")
        if not d_loss <= TP_LOSS_TOL:
            fail(f"{name}: losses {d_loss:.3e} off the one-card step")
        if not worst[0] <= LM_UPDATE_TOL:
            fail(f"{name}: masters {worst[0]:.3e} of the update off the "
                 f"one-card step ({worst[1]})")
        if moe_chunks is not None:
            replay.hold(name)
        row = {"arch": cfg.arch_id, "vocab": cfg.vocab_size,
               "mesh": [n_data, 2],
               "batch": [rows_a_rank, seq], "losses": losses,
               "one_card_losses": ones, "loss_rel": d_loss,
               "masters_of_update": list(worst),
               "step_ms": [x * 1e3 for x in times], "median_ms": med * 1e3,
               "tokens_per_s": tokens / med,
               "peak_gib": [p / 2 ** 30 for p in peaks],
               "one_card_peak_gib": one_peak, "launches": counts}
        if rep_same is not None:
            row.update(replicated_same=rep_same, flips=replay.flips,
                       choices=replay.choices, max_gap=replay.gap)
        del s1
    dist.barrier()
    mesh.destroy()
    return row


def _replicated_same(state, model, mesh) -> bool:
    """Whether this job's ranks hold the same bits in every replicated
    master and momentum leaf (a collective every rank joins)."""
    import torch.distributed as dist
    from repro_torch.models.common import local_slice, model_axis
    from repro_torch.tree import tree_flatten
    pds = dict(tree_flatten(model.param_pd))
    tp = model_axis(mesh)
    rep = {f"{f}/{p}": x for f in ("params", "mom")
           for p, x in tree_flatten(getattr(state, f))
           if local_slice(pds[p], tp)[0] is None}
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, _sha(rep))
    return len(set(digests)) == 1


def _hybrid_collectives(cfg) -> dict:
    """The collectives of zamba2's prefill at a model axis: per Mamba
    layer the norm's sum of squares and the row-split ``out``, per
    shared-block application the attention's and the FFN's row-split
    products (all-reduces); the untied embedding's columns and the
    vocab-split logits (all-gathers); no all_to_all (no MoE layer)."""
    groups = -(-cfg.n_layers // cfg.attn_every)
    return {"all_reduce": 2 * cfg.n_layers + 2 * groups,
            "all_gather": 1 + (not cfg.tie_embeddings),
            "all_to_all_single": 0}


def _serve_tp_hybrid(mesh, say) -> dict:
    """serve_tp_hybrid on this rank: zamba2-7b at full width and depth at
    model 4, at serve_hybrid's sizes, then its context checks on rank 0's
    card (model 4 against model 1: in f32 at TP_HYBRID_F32_LAYERS layers,
    the gate, and at full depth in bf16). Rank 0's row."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.core import pinit, precision
    from repro_torch.core.precision import cast_to_compute
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.tree import tree_leaves

    dev, n = mesh.device, mesh.size
    cfg = dataclasses.replace(get_config("zamba2-7b"), flash_attention=True)
    groups = -(-cfg.n_layers // cfg.attn_every)
    model = build_model(cfg)
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    params = pinit.materialize(model.param_pd, seed=0, device=dev,
                               dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    init_s = time.perf_counter() - t
    n_local = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": tokens}
    cache_len = _serve_cache(cfg, batch)
    generate(model, params, batch, max_new=2, cache_len=cache_len,
             mesh=mesh)                    # warm-up: not timed, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    _zero(*_counters().values())
    out = generate(model, params, batch, max_new=SERVE_NEW,
                   cache_len=cache_len, timings=timings, mesh=mesh)
    torch.cuda.synchronize()
    counts = _read_path("serve_tp_hybrid", {"k5": groups})
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad(), _collectives() as calls:
        last4, cache4 = model.forward_prefill(cast_to_compute(params), batch,
                                              cache_len, mesh)
    if calls != _hybrid_collectives(cfg):
        fail(f"serve_tp_hybrid: a prefill made {calls}; the model axis "
             f"makes {_hybrid_collectives(cfg)}")
    if not bool(torch.isfinite(last4).all()):
        fail("serve_tp_hybrid: non-finite prefill logits")
    with torch.no_grad():
        dec4, _ = model.forward_decode(cast_to_compute(params), cache4,
                                       out[:, :1], SERVE_PROMPT, mesh)
    del cache4
    outs, peaks = [None] * n, [None] * n
    dist.all_gather_object(outs, out.cpu())
    dist.all_gather_object(peaks, peak)
    if tuple(out.shape) != (SERVE_BATCH, SERVE_NEW) or not all(
            torch.equal(o, outs[0]) for o in outs):
        fail(f"serve_tp_hybrid: the ranks' tokens differ or have shape "
             f"{tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail("serve_tp_hybrid: a token outside the vocabulary")
    dec = timings["decode_ms"]
    q1, med, q3 = statistics.quantiles(dec, n=4)
    say(f"serve_tp_hybrid: {cfg.arch_id}, {cfg.n_layers} Mamba layers and "
        f"{groups} shared-block applications at full width, model {n}: "
        f"{n_local / 1e9:.3f} B params a rank (bf16), pinit {init_s:.2f} s; "
        f"{SERVE_BATCH} requests of {SERVE_PROMPT} tokens, {SERVE_NEW} new, "
        f"cache {cache_len} rows; prefill {timings['prefill_ms']:.2f} ms "
        f"({SERVE_BATCH * SERVE_PROMPT / timings['prefill_ms'] * 1e3:.0f} "
        f"prompt tokens/s); decode ms a token median {med:.3f} (p25 "
        f"{q1:.3f}, p75 {q3:.3f}, {len(dec)} steps), "
        f"{SERVE_BATCH * 1e3 / med:.1f} tokens/s; peak memory a rank GiB "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; a prefill: "
        f"{calls['all_reduce']} all-reduces, {calls['all_gather']} "
        f"all-gathers, flash_attention {counts['k5']} launches a rank; "
        f"every rank's tokens equal")
    say(f"serve_tp_hybrid: first request's tokens {out[0].tolist()}")
    row = {"arch": cfg.arch_id, "layers": cfg.n_layers, "model": n,
           "params_a_rank": n_local, "pinit_s": init_s,
           "prefill_ms": timings["prefill_ms"],
           "decode_ms": {"p25": q1, "median": med, "p75": q3},
           "tokens_per_s": SERVE_BATCH * 1e3 / med,
           "peak_gib": [p / 2 ** 30 for p in peaks],
           "sizes": [SERVE_BATCH, SERVE_PROMPT, SERVE_NEW],
           "cache_len": cache_len, "collectives_a_prefill": calls,
           "launches": counts}

    # context, bf16 at full depth: the shards gathered, model 1 on rank 0
    whole = weights.gather_tree(params, model.param_pd, mesh)
    del params
    if mesh.rank == 0:
        with torch.no_grad():
            last1, cache1 = model.forward_prefill(whole, batch, cache_len)
            dec1, _ = model.forward_decode(whole, cache1, out[:, :1],
                                           SERVE_PROMPT)
        del cache1
        d16 = (_rel(last4.float(), last1.float()),
               _rel(dec4.float(), dec1.float()))
    del whole, last4, dec4
    gc.collect()
    torch.cuda.empty_cache()

    # context, f32 at TP_HYBRID_F32_LAYERS layers: the gate
    cfg12 = dataclasses.replace(cfg, n_layers=TP_HYBRID_F32_LAYERS)
    model12 = build_model(cfg12)
    p4 = pinit.materialize(model12.param_pd, seed=0, device=dev, mesh=mesh)
    sub = {"tokens": tokens[:SERVE_F32_REQUESTS]}
    tok = out[:SERVE_F32_REQUESTS, :1]
    torch.backends.cuda.matmul.allow_tf32 = False
    before = _counters()["k5"].launches
    with torch.no_grad(), precision.f32_compute():
        f4, c4 = model12.forward_prefill(p4, sub, cache_len, mesh)
        g4, _ = model12.forward_decode(p4, c4, tok, SERVE_PROMPT, mesh)
    k5_f32 = _counters()["k5"].launches - before
    del c4
    whole = weights.gather_tree(p4, model12.param_pd, mesh)
    del p4
    if mesh.rank == 0:
        with torch.no_grad(), precision.f32_compute():
            f1, c1 = model12.forward_prefill(whole, sub, cache_len)
            g1, _ = model12.forward_decode(whole, c1, tok, SERVE_PROMPT)
        d32 = (_rel(f4, f1), _rel(g4, g1))
        apps = -(-TP_HYBRID_F32_LAYERS // cfg.attn_every)
        say(f"serve_tp_hybrid context: model {n} against model 1 on one "
            f"card. f32 (the gate) at {TP_HYBRID_F32_LAYERS} of its "
            f"{cfg.n_layers} layers ({apps} shared-block applications), "
            f"{SERVE_F32_REQUESTS} requests, K5's f32 route {k5_f32} "
            f"launches a rank: prefill logits {d32[0]:.3e}, one decode "
            f"step {d32[1]:.3e} of their max (limit {SERVE_F32_TOL}); bf16 "
            f"at all {cfg.n_layers} layers: prefill {d16[0]:.3e}, decode "
            f"{d16[1]:.3e} (limit {HYBRID_SERVE_TOL})")
        if k5_f32 != apps:
            fail(f"serve_tp_hybrid context: the f32 prefill launched K5 "
                 f"{k5_f32} times")
        if not max(d32) <= SERVE_F32_TOL:
            fail("serve_tp_hybrid context: model 4 disagrees with model 1 "
                 "in f32")
        if not max(d16) <= HYBRID_SERVE_TOL:
            fail("serve_tp_hybrid context: model 4 disagrees with model 1 "
                 "in bf16")
        row["context"] = {"f32_layers": TP_HYBRID_F32_LAYERS,
                          "f32_prefill_vs_one": d32[0],
                          "f32_decode_vs_one": d32[1],
                          "bf16_prefill_vs_one": d16[0],
                          "bf16_decode_vs_one": d16[1]}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return row


def _zero_grad_paths(cfg) -> tuple:
    """The xLSTM's sLSTM input-gate biases: their gradient vanishes (a
    shift of that gate scales c and n alike, and h = o · c / n), so
    their update is their weight decay and rounding noise."""
    pat = cfg.xlstm.pattern
    return tuple(f"layer_{i:02d}/blk/b_i" for i in range(cfg.n_layers)
                 if pat[i % len(pat)] == "s")


def _lm_train_tp_xlstm(say) -> dict:
    """lm_train_tp_xlstm on this rank: xlstm-125m whole at (data 2, model
    2), wholly in f32, TP_XLSTM_STEPS comm='xla' LARS steps; rank 0 then
    runs the one-card step over the same global batches from the same
    values and holds the losses and, after each step, the masters against
    it (and its first step run again, beside: the one card's own
    run-to-run spread). Rank 0's row."""
    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars, precision
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import dp_axes
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten

    mesh = make_local_mesh(2)
    dev = mesh.device
    cfg = get_config("xlstm-125m")
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                         total_steps=TP_XLSTM_STEPS,
                                         decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    rows_a_rank, seq = TP_XLSTM_TRAIN
    n_data = mesh.axis("data").size
    shape = InputShape("train_xlstm", "train", seq, rows_a_rank * n_data)
    step = make_train_step(model, opt, sched, smoothing=0.1, mesh=mesh,
                           comm="xla", comm_dtype="f32")
    part = make_batch_fn(cfg, shape, device=dev, mesh=mesh,
                         axes=dp_axes(mesh))
    torch.cuda.empty_cache()
    state = init_state(model, 0, device=dev, **sharded_state_kwargs(step))
    whole = lambda t: dict(tree_flatten(weights.gather_tree(  # noqa: E731
        t, model.param_pd, mesh)))
    p0 = whole(state.params)
    torch.backends.cuda.matmul.allow_tf32 = False
    times, losses, got, inputs = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(*_counters().values())
    for i in range(TP_XLSTM_STEPS):
        # each step's input state, whole (the gathers launch no kernel)
        inputs.append((whole(state.params), whole(state.mom)))
        batch = part(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with precision.f32_compute():
            state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        got.append(whole(state.params))
    counts = _read_path("lm_train_tp_xlstm", {
        "k4": TP_XLSTM_STEPS, "k4_bwd": TP_XLSTM_STEPS,
        "k1": 2 * TP_XLSTM_STEPS})
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * mesh.size
    dist.all_gather_object(peaks, peak)
    if not all(math.isfinite(v) for v in losses):
        fail(f"lm_train_tp_xlstm: losses not all finite: {losses}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    row = None
    if mesh.rank == 0:
        one = make_train_step(model, opt, sched, smoothing=0.1, comm="xla",
                              comm_dtype="f32")
        full = make_batch_fn(cfg, shape, device=dev)
        s1 = init_state(model, 0, device=dev)
        init_same = all(torch.equal(x, p0[p])
                        for p, x in tree_flatten(s1.params))
        zero = _zero_grad_paths(cfg)

        def of_update(a, b, before):
            """Each tensor's difference over its largest update (the
            vanishing-gradient biases' over the tree's largest), the worst
            four."""
            upd = {p: (b[p] - before[p]).abs().max().item() for p in b}
            top = max(upd.values())
            return sorted(((a[p] - b[p]).abs().max().item()
                           / max(top if p in zero else upd[p], 1e-30), p)
                          for p in b)[::-1][:4]

        from repro_torch.train.state import TrainState
        from repro_torch.tree import tree_unflatten
        tree = lambda flat: tree_unflatten(list(flat), list(  # noqa: E731
            flat.values()))
        # the gate: each step against the one card's from the same input
        # state (the model-2 run's, gathered); then the one card's own
        # trajectory, printed: a step's gradient is sensitive enough that
        # two trajectories parted by rounding after step 1 part further
        ones, one_times, worst, free, before = [], [], [], [], p0
        for i in range(TP_XLSTM_STEPS):
            params_in, mom_in = inputs[i]
            torch.cuda.synchronize()
            t = time.perf_counter()
            with precision.f32_compute():
                s_next, m1 = one(TrainState(i, tree(params_in),
                                            tree(mom_in)), full(i))
            torch.cuda.synchronize()
            one_times.append(time.perf_counter() - t)
            ones.append(float(m1["loss"]))
            worst.append(of_update(got[i], dict(tree_flatten(
                s_next.params)), params_in))
            with precision.f32_compute():
                s1, _ = one(s1, full(i))
            want = dict(tree_flatten(s1.params))
            free.append(of_update(got[i], want, before))
            if i == 0:
                with precision.f32_compute():
                    again, _ = one(TrainState(0, tree(params_in),
                                              tree(mom_in)), full(0))
                spread = of_update(dict(tree_flatten(again.params)), want,
                                   before)
                del again
            before = want
            del s_next
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ones))
        tokens = rows_a_rank * seq * n_data
        fmt = lambda w: [(f"{e:.3e}", p) for e, p in w]  # noqa: E731
        say(f"lm_train_tp_xlstm: {cfg.arch_id}, {cfg.n_layers} layers at "
            f"full width, (data {n_data}, model {mesh.axis('model').size}), "
            f"comm='xla' wholly in f32, LARS with K1, {rows_a_rank} x {seq} "
            f"tokens a data rank: losses {[round(v, 6) for v in losses]} "
            f"(one card at the global batch {[round(v, 6) for v in ones]}: "
            f"within {d_loss:.3e} relative, limit {TP_XLSTM_LOSS_TOL}); "
            f"masters after each step against the one card's step from the "
            f"same input state, each tensor's difference over its largest "
            f"update, the worst four (the sLSTM input-gate biases "
            f"{list(zero)} over the tree's; limit {TP_XLSTM_UPDATE_TOL}): "
            f"{[fmt(w) for w in worst]}; against the one card's own "
            f"trajectory (not gated): {[fmt(w) for w in free]}; the one "
            f"card's first step again: {fmt(spread)}; initial values "
            f"{'equal' if init_same else 'DIFFERENT'}; step times ms "
            f"{[round(x * 1e3, 2) for x in times]} (one card "
            f"{[round(x * 1e3, 2) for x in one_times]}); peak memory a rank "
            f"GiB {[round(p / 2 ** 30, 2) for p in peaks]}; launches K4 "
            f"{counts['k4']} + {counts['k4_bwd']}, K1 {counts['k1']}; "
            f"{tokens / statistics.median(times):.0f} tokens/s on "
            f"{mesh.size} cards")
        if not init_same:
            fail("lm_train_tp_xlstm: the shards' initial values are not the "
                 "one-card state's")
        if not d_loss <= TP_XLSTM_LOSS_TOL:
            fail(f"lm_train_tp_xlstm: losses {d_loss:.3e} off the one-card "
                 f"step")
        bad = max(w[0] for w in worst)
        if not bad[0] <= TP_XLSTM_UPDATE_TOL:
            fail(f"lm_train_tp_xlstm: masters {bad[0]:.3e} of the update "
                 f"off the one-card step ({bad[1]})")
        row = {"arch": cfg.arch_id, "mesh": [n_data, 2],
               "batch": [rows_a_rank, seq], "losses": losses,
               "one_card_losses": ones, "loss_rel": d_loss,
               "masters_of_update": worst, "free_running": free,
               "one_card_spread": spread,
               "step_ms": [x * 1e3 for x in times],
               "one_card_step_ms": [x * 1e3 for x in one_times],
               "peak_gib": [p / 2 ** 30 for p in peaks], "launches": counts}
        del s1
    dist.barrier()
    mesh.destroy()
    return row


def _damped(state, scale: float):
    """``state`` with each residual branch's last BN scale set to
    ``scale`` (``RESNET_XLA_BN3_SCALE``), in place."""
    for blk in state.params.values():
        if "bn3" in blk:
            blk["bn3"]["scale"].fill_(scale)
    return state


def _step1_against_one_card(first, s0, s1, loss, one_loss) -> dict:
    """Step 1 of the four ranks (``first``, from ``s0``; its loss
    ``loss``) against the one card's (``s1``; ``one_loss``): the loss
    relative; the new BN statistics of their max (the stem's, the median
    tensor's, the worst); the update's relative L2 error (median tensor,
    worst); the masters' worst element over its tensor's largest
    update."""
    from repro_torch.tree import tree_flatten
    bn = {p: _rel(a, b) for (p, a), (_, b) in zip(
        tree_flatten(first.bn_state), tree_flatten(s1.bn_state))}
    want, p0 = dict(tree_flatten(s1.params)), dict(tree_flatten(s0.params))
    got = dict(tree_flatten(first.params))
    l2 = {p: ((got[p] - want[p]).norm()
              / (want[p] - p0[p]).norm().clamp_min(1e-30)).item()
          for p in want}
    return {"loss_rel": abs(loss - one_loss) / abs(one_loss),
            "bn_stem": max(v for p, v in bn.items() if p.startswith("stem/")),
            "bn_median": statistics.median(bn.values()),
            "bn_worst": max((v, p) for p, v in bn.items()),
            "update_l2_median": statistics.median(l2.values()),
            "update_l2_worst": max((v, p) for p, v in l2.items()),
            "masters_of_update": max(
                ((got[p] - want[p]).abs().max().item()
                 / max((want[p] - p0[p]).abs().max().item(), 1e-30), p)
                for p in want if want[p].dim() >= 2),
            "masters_of_update_1d": max(
                ((got[p] - want[p]).abs().max().item()
                 / max((want[p] - p0[p]).abs().max().item(), 1e-30), p)
                for p in want if want[p].dim() < 2)}


def _fmt_step1(d: dict) -> str:
    return (f"loss {d['loss_rel']:.3e} relative; new BN statistics of "
            f"their max: the stem's {d['bn_stem']:.3e}, the median "
            f"tensor's {d['bn_median']:.3e}, the worst "
            f"{d['bn_worst'][0]:.3e} ({d['bn_worst'][1]}); the update's "
            f"relative L2 error: median tensor {d['update_l2_median']:.3e}, "
            f"worst {d['update_l2_worst'][0]:.3e} "
            f"({d['update_l2_worst'][1]}); masters' worst element of its "
            f"tensor's largest update: the weights' (2-D and up) "
            f"{d['masters_of_update'][0]:.3e} ({d['masters_of_update'][1]}),"
            f" the BN scales' and biases' {d['masters_of_update_1d'][0]:.3e}"
            f" ({d['masters_of_update_1d'][1]})")


def _resnet_xla(say) -> dict:
    """resnet_xla on this rank: ResNet-50 at full width under comm='xla' on
    (data 4, model 1), in each sync_bn form: first one step from pinit's
    state, held against the one card's (printed, not gated: chaotic),
    then RESNET_XLA_STEPS steps from that state with its residual
    branches damped; every rank's masters, momentum and BN state must be
    the same bits; rank 0 holds the damped run's step 1 against the
    one-card comm='xla' step on the same global batch from the same
    state. Rank 0's row."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import Axis, Mesh, make_local_mesh
    from repro_torch.models.common import dp_axes
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.train.step import make_train_step

    mesh = make_local_mesh(1)
    dev, n = mesh.device, mesh.size
    sched = make_schedule(ScheduleConfig(base_lr=0.1 * n * RESNET_XLA_BATCH
                                         / 256, warmup_steps=1,
                                         total_steps=RESNET_XLA_STEPS,
                                         decay="poly2"))
    opt = lars.OptConfig(kind="lars", use_kernel=True)
    shape = InputShape("resnet_xla", "train", 0, RESNET_XLA_BATCH * n)
    rows = {}
    for sync in (False, True):
        name = f"resnet_xla sync_bn={int(sync)}"
        cfg = dataclasses.replace(get_config("resnet50"), sync_bn=sync)
        model = build_model(cfg)
        step = make_train_step(model, opt, sched, mesh=mesh, comm="xla")
        one = make_train_step(model, opt, sched, comm="xla")
        part = make_batch_fn(cfg, shape, device=dev, mesh=mesh,
                             axes=dp_axes(mesh))
        full = make_batch_fn(cfg, shape, device=dev)

        # pinit's state: step 1 against one card, printed only
        s_in = init_state(model, 0, device=dev)
        first, m = step(s_in, part(0))
        if mesh.rank == 0:
            s1, m1 = one(s_in, full(0))
            undamped = _step1_against_one_card(
                first, s_in, s1, float(m["loss"]), float(m1["loss"]))
            say(f"{name} at pinit's init (not gated: bf16 ResNet-50 at "
                f"random init is chaotic): step 1 against the one card: "
                f"{_fmt_step1(undamped)}")
            del s1
        del s_in, first
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()

        state = _damped(init_state(model, 0, device=dev),
                        RESNET_XLA_BN3_SCALE)
        times, losses = [], []
        torch.cuda.synchronize()
        _zero(*_counters().values())
        for i in range(RESNET_XLA_STEPS):
            batch = part(i)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(float(metrics["loss"]))
            if i == 0:
                first = state
        counts = _read_path(name, {"k1": 2 * RESNET_XLA_STEPS})
        # the same RESNET_XLA_BATCH images on every rank: the global
        # statistics' sums are then 4 x the rank's, exactly, and the step
        # must be the one card's on those images bit for bit
        same = {k: v[:RESNET_XLA_BATCH] for k, v in full(0).items()}
        s_in = _damped(init_state(model, 0, device=dev),
                       RESNET_XLA_BN3_SCALE)
        replicated, _ = step(s_in, same)
        shas = [None] * n
        dist.all_gather_object(shas, _sha({"params": state.params,
                                           "mom": state.mom,
                                           "bn": state.bn_state}))
        if len(set(shas)) != 1:
            fail(f"{name}: the ranks' masters, momentum or BN state differ")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: losses not all finite: {losses}")
        row = {"losses": losses, "step_ms": [x * 1e3 for x in times],
               "median_ms": statistics.median(times[1:]) * 1e3,
               "launches": counts, "ranks_bit_equal": True}
        if mesh.rank == 0:
            s0 = _damped(init_state(model, 0, device=dev),
                         RESNET_XLA_BN3_SCALE)
            # the one card over a one-rank mesh: the same BatchNorm form
            # (with sync_bn the cross-replica one), so the same sums
            lone = Mesh(tuple(Axis(a.name, 1, 0, (0,), None)
                              for a in mesh.axes), dev)
            alone, _ = make_train_step(model, opt, sched, mesh=lone,
                                       comm="xla")(s_in, same)
            rep_equal = all(_bit_equal(getattr(replicated, k),
                                       getattr(alone, k))
                            for k in ("params", "mom", "bn_state"))
            rep_worst = _worst_rel(
                _tensors(replicated.params) + _tensors(replicated.bn_state),
                _tensors(alone.params) + _tensors(alone.bn_state))
            del alone
            s1, m1 = one(s0, full(0))
            ones = [float(m1["loss"])]
            d = _step1_against_one_card(first, s0, s1, losses[0], ones[0])
            # the one card's step 1 again, from the same state and batch:
            # the card's own run-to-run spread
            again, m2 = one(s0, full(0))
            spread = _step1_against_one_card(again, s0, s1,
                                             float(m2["loss"]), ones[0])
            del again
            for i in range(1, RESNET_XLA_STEPS):
                s1, m1 = one(s1, full(i))
                ones.append(float(m1["loss"]))
            say(f"{name}: ResNet-50 at full width, comm='xla' on (data {n}, "
                f"model 1), LARS with K1, {RESNET_XLA_BATCH} images a rank, "
                f"the residual branches' last BN scale "
                f"{RESNET_XLA_BN3_SCALE}: losses "
                f"{[round(v, 5) for v in losses]} (one card on the "
                f"{RESNET_XLA_BATCH * n} images: "
                f"{[round(v, 5) for v in ones]}); step 1 against the one "
                f"card: {_fmt_step1(d)}; the one card's step 1 again "
                f"against itself: {_fmt_step1(spread)}; limits (loss, every "
                f"BN tensor, the median update) {RESNET_XLA_TOL}; the four "
                f"ranks on the "
                f"same {RESNET_XLA_BATCH} images against the one card on "
                f"them: {'bit-equal' if rep_equal else 'NOT bit-equal'} "
                f"(worst {rep_worst:.3e} of a tensor's max); steps 2-"
                f"{RESNET_XLA_STEPS} "
                f"printed, not gated; the {n} ranks' masters, momentum and "
                f"BN state bit-equal; step ms "
                f"{[round(x * 1e3, 2) for x in times]}, median after the "
                f"first {row['median_ms']:.2f} (ring replicated "
                f"{RING_REPLICATED_MS}, PR 27's r1; not a gate); K1 "
                f"{counts['k1']}")
            if not (d["loss_rel"] <= RESNET_XLA_TOL[0]
                    and d["bn_worst"][0] <= RESNET_XLA_TOL[1]
                    and d["update_l2_median"] <= RESNET_XLA_TOL[2]):
                fail(f"{name}: step 1 disagrees with the one-card step")
            row.update(one_card_losses=ones, step1=d,
                       one_card_spread=spread, undamped_step1=undamped,
                       replicated_bit_equal=rep_equal,
                       replicated_worst=rep_worst)
            del s0, s1
        rows[f"sync_bn={int(sync)}"] = row
        del state, first, s_in, replicated
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    mesh.destroy()
    return rows


def _tp_cli_in_process(mesh, say) -> dict:
    """The CLI runs of TP_CLI_RUNS, ``launch.train.main`` called in each
    rank's own process (the job's process group is the CLI's); each must
    reach run_stop on every rank, a --resume-elastic run from step
    TP_CLI_RESUMED_AT. Rank 0's row: each run's seconds and its kernels'
    launches on rank 0."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist
    from repro_torch.launch import train as cli
    row = {}
    d = _shared_dir(mesh, "tp_cli_")
    for args in TP_CLI_RUNS:
        args = [a.replace("{ckpt}", d) for a in args]
        torch.cuda.empty_cache()
        dist.barrier()
        t = time.perf_counter()
        buf = io.StringIO()
        _zero(*_counters().values())
        with contextlib.redirect_stdout(buf):
            history = cli.main(list(args))
        secs = time.perf_counter() - t
        launches = {k: w.launches for k, w in _counters().items()}
        stops = [ln for ln in buf.getvalue().splitlines() if "run_stop" in ln]
        ok = bool(stops) and all(math.isfinite(h["loss"]) for h in history
                                 if "loss" in h)
        if "--resume-elastic" in args:
            ok = ok and f"restored step {TP_CLI_RESUMED_AT}" in buf.getvalue()
        oks = [None] * dist.get_world_size()
        dist.all_gather_object(oks, ok)
        if not all(oks):
            fail(f"tp CLI {' '.join(args)}: no run_stop or a non-finite "
                 f"loss on ranks {[r for r, o in enumerate(oks) if not o]}")
        say(f"tp: CLI on 4 ranks ({' '.join(args)}) reached run_stop on "
            f"every rank in {secs:.1f} s, launches {launches}: "
            f"{stops[0].strip()}")
        row[" ".join(args)] = {"s": secs, "launches": launches}
    dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    return row


def _vocab_cut(arch):
    """``arch``'s config with only its vocabulary cut to the multiple of
    TP_VOCAB_MULTIPLE below it, and its published vocabulary: the model
    axis splits the untied ``lm_head`` by vocabulary columns, and neither
    package can place an odd V over model > 1."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    V = cfg.vocab_size
    return dataclasses.replace(cfg, vocab_size=V - V % TP_VOCAB_MULTIPLE), V


def _frames_collectives(cfg, m: int) -> tuple:
    """The collectives of whisper's or the VLM's prefill and of a decode
    step at model ``m``: a row-split product's all-reduce per attention
    and per FFN (whisper's decoder layers add the cross-attention's), so 2
    a layer (whisper: 2 an encoder layer, 3 a decoder layer; its decode
    step 3 a decoder layer); the untied embedding's columns and the
    vocab-split logits gathered (all-gathers), and q's, k's and v's where
    m cuts a head (``attention.HeadSplit``: none at whisper-base's 8 heads
    and internvl2-2b's 16 on 8 over 4); no all_to_all (no MoE layer)."""
    import types

    from repro_torch.models import attention
    hs = attention.head_split(cfg, types.SimpleNamespace(size=m, index=0))
    qkv = hs.q_whole + 2 * hs.kv_whole
    gathers = 1 + (not cfg.tie_embeddings)
    L = cfg.n_layers
    if cfg.family == "audio":
        attn = cfg.encoder.n_layers + 2 * L
        prefill = 2 * cfg.encoder.n_layers + 3 * L
        decode, dec_gathers = 3 * L, L * qkv + L * hs.q_whole
    else:
        attn, prefill = L, 2 * L
        decode, dec_gathers = 2 * L, L * qkv
    return ({"all_reduce": prefill, "all_gather": gathers + attn * qkv,
             "all_to_all_single": 0},
            {"all_reduce": decode, "all_gather": gathers + dec_gathers,
             "all_to_all_single": 0})


def _serve_tp_frames(mesh, say, name, arch, sizes) -> dict:
    """serve_tp_audio or serve_tp_vlm on this rank: ``arch`` (whisper-base
    or internvl2-2b) at full width and depth, only its vocabulary cut
    (``_vocab_cut``), at model 4, bf16, flash, ``sizes`` (requests, prompt
    tokens, new tokens) with their stub frames; then, on rank 0's card,
    model 4 against model 1 (the shards gathered): prefill logits and the
    greedy rule. Rank 0's row."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.core import pinit
    from repro_torch.data.synthetic import stub_frames
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.tree import tree_leaves

    dev, n = mesh.device, mesh.size
    cfg, V = _vocab_cut(arch)
    cfg = dataclasses.replace(cfg, flash_attention=True)
    audio = cfg.family == "audio"
    k5 = (cfg.encoder.n_layers + 2 * cfg.n_layers) if audio else cfg.n_layers
    want_prefill, want_decode = _frames_collectives(cfg, n)
    model = build_model(cfg)
    n_req, n_prompt, n_new = sizes
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    params = pinit.materialize(model.param_pd, seed=0, device=dev,
                               dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    init_s = time.perf_counter() - t
    n_local = sum(x.numel() for x in tree_leaves(params))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (n_req, n_prompt),
                           generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": tokens,
             "frames": stub_frames(cfg, batch=n_req, step=0, device=dev)}
    cache_len = _serve_cache(cfg, batch, n_new)
    generate(model, params, batch, max_new=2, cache_len=cache_len,
             mesh=mesh)                    # warm-up: not timed, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    _zero(*_counters().values())
    out = generate(model, params, batch, max_new=n_new, cache_len=cache_len,
                   timings=timings, mesh=mesh)
    torch.cuda.synchronize()
    counts = _read_path(name, {"k5": k5})
    peak = torch.cuda.max_memory_allocated(dev)
    pos = _prompt_pos(cfg, batch)
    with torch.no_grad():
        with _collectives() as calls:
            last4, cache4 = model.forward_prefill(params, batch, cache_len,
                                                  mesh)
        with _collectives() as dcalls:
            model.forward_decode(params, cache4, out[:, :1], pos, mesh)
    del cache4
    if calls != want_prefill or dcalls != want_decode:
        fail(f"{name}: a prefill made {calls} and a decode step {dcalls}; "
             f"the model axis makes {want_prefill} and {want_decode}")
    if not bool(torch.isfinite(last4).all()):
        fail(f"{name}: non-finite prefill logits")
    outs, peaks = [None] * n, [None] * n
    dist.all_gather_object(outs, out.cpu())
    dist.all_gather_object(peaks, peak)
    if tuple(out.shape) != (n_req, n_new) or not all(
            torch.equal(o, outs[0]) for o in outs):
        fail(f"{name}: the ranks' tokens differ or have shape "
             f"{tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{name}: a token outside the vocabulary")
    dec = timings["decode_ms"]
    q1, med, q3 = statistics.quantiles(dec, n=4)
    layers = (f"{cfg.encoder.n_layers} encoder and {cfg.n_layers} decoder "
              f"layers" if audio else f"{cfg.n_layers} layers")
    say(f"{name}: {cfg.arch_id}, {layers} at full width, vocabulary cut "
        f"from {V:,} to {cfg.vocab_size:,} (the model axis cannot place an "
        f"odd V), model {n}: {n_local / 1e6:.1f} M params a rank (bf16), "
        f"pinit {init_s:.2f} s; {n_req} requests of {n_prompt} tokens + "
        f"{cfg.encoder.n_frames} stub frames, {n_new} new, cache "
        f"{cache_len} rows; prefill {timings['prefill_ms']:.2f} ms; decode "
        f"ms a token median {med:.3f} (p25 {q1:.3f}, p75 {q3:.3f}, "
        f"{len(dec)} steps), {n_req * 1e3 / med:.1f} tokens/s; peak memory "
        f"a rank GiB {[round(p / 2 ** 30, 2) for p in peaks]}; a prefill: "
        f"{calls['all_reduce']} all-reduces, {calls['all_gather']} "
        f"all-gathers; a decode step: {dcalls['all_reduce']} and "
        f"{dcalls['all_gather']}; flash_attention {counts['k5']} launches a "
        f"rank; every rank's tokens equal")
    say(f"{name}: first request's tokens {out[0].tolist()}")
    row = {"arch": cfg.arch_id, "vocab": cfg.vocab_size, "published_vocab": V,
           "layers": cfg.n_layers, "model": n, "params_a_rank": n_local,
           "pinit_s": init_s, "prefill_ms": timings["prefill_ms"],
           "decode_ms": {"p25": q1, "median": med, "p75": q3},
           "tokens_per_s": n_req * 1e3 / med,
           "peak_gib": [p / 2 ** 30 for p in peaks], "sizes": list(sizes),
           "cache_len": cache_len, "collectives_a_prefill": calls,
           "collectives_a_decode_step": dcalls, "launches": counts}

    # context: model 4 against model 1 on rank 0's card, the same values
    whole = weights.gather_tree(params, model.param_pd, mesh)
    del params
    if mesh.rank == 0:
        with torch.no_grad():
            last1, _ = model.forward_prefill(whole, batch, cache_len)
            d = _rel(last4.float(), last1.float())
            one = generate(model, whole, batch, max_new=TP_CONTEXT_NEW,
                           cache_len=cache_len)
            ties = _greedy_rule(model, whole, batch, out[:, :TP_CONTEXT_NEW],
                                one, cache_len, SERVE_TOL, name)
        say(f"{name} context: model {n} against model 1 on one card: "
            f"prefill logits differ by {d:.3e} of their max (limit "
            f"{SERVE_TOL}); {TP_CONTEXT_NEW} greedy tokens within the rule "
            f"(margin {SERVE_TOL} of the max; the first decode at position "
            f"{pos}), tied steps a request {ties}")
        if not d <= SERVE_TOL:
            fail(f"{name} context: model 4's prefill disagrees with model "
                 f"1's")
        row["context"] = {"prefill_vs_one": d, "ties": ties}
    del whole, last4
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return row


def _lm_train_tp_frames(say) -> dict:
    """lm_train_tp_frames on this rank: lm_train_tp's run for each of
    TP_FRAMES_TRAIN (the vocabulary cut, ``_vocab_cut``). Rank 0's rows
    by arch, and the launches summed over both runs."""
    rows, launches = {}, {}
    for arch, rows_seq in TP_FRAMES_TRAIN:
        cfg, _ = _vocab_cut(arch)
        row = _lm_train_tp(say, "lm_train_tp_frames", cfg, rows_seq)
        if row is not None:
            rows[arch] = row
            for key, v in row["launches"].items():
                launches[key] = launches.get(key, 0) + v
    return dict(rows, launches=launches) if rows else None


def _moe_collectives(cfg) -> tuple:
    """The collectives of a MoE decoder's prefill and decode step at a
    model axis: a layer's attention and shared-expert row-split products
    (all-reduces); in the prefill the MoE layer's two all_to_alls, its
    sequence chunks' gather and its aux's all-reduce, in decode its local
    experts' psum; the untied embedding's columns and the vocab-split
    logits gathered once each."""
    L = cfg.n_layers
    return ({"all_reduce": 3 * L, "all_gather": L + 2,
             "all_to_all_single": 2 * L},
            {"all_reduce": 3 * L, "all_gather": 2, "all_to_all_single": 0})


def _moe_context(model, mesh, params, batch, cache_len, say, cf=None,
                 name="serve_tp_moe"):
    """serve_tp_moe's context (or serve_tp_mla's: ``name``) on this rank:
    ``model`` (at
    ``capacity_factor`` ``cf`` where given) prefilled and decoding
    TP_CONTEXT_NEW tokens at model 4, then on rank 0's card the same
    params gathered whole, the MoE layer chunked as model 4 chunks it
    (``cf`` None) or whole (no choice drops at ``cf``), every MoE layer on
    the ranks' expert choices (``_RoutingPin``: two bf16 paths part at
    near-ties among 60 experts, and a flipped choice moves a token by far
    more than rounding; unpinned, the prefill's difference and the choices
    that differ are printed): the prefill's logits within SERVE_TOL of
    their max, and the tokens by the greedy rule. Rank 0's figures."""
    import contextlib
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch import weights
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    cfg = model.cfg
    if cf is not None:
        model = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf)))
    recorded = []
    for run in (lambda: model.forward_prefill(params, batch, cache_len,
                                              mesh),
                lambda: generate(model, params, batch,
                                 max_new=TP_CONTEXT_NEW,
                                 cache_len=cache_len, mesh=mesh)):
        pin = _RoutingPin()
        with torch.no_grad(), pin.record():
            recorded.append(run())
        calls = [None] * mesh.size
        dist.all_gather_object(calls, [x.cpu() for x in pin.ids])
        recorded.append(calls)
    (last4, _), prefill_calls, tp_tokens, gen_calls = recorded
    whole = weights.gather_tree(params, model.param_pd, mesh)
    out = None
    if mesh.rank == 0:
        m, L = mesh.axis("model").size, cfg.n_layers
        B, S = batch["tokens"].shape

        def pinned(calls):
            """The one card's choices, call by call: a prefill's chunk by
            chunk (chunked) or its chunks' tokens in order (whole); a
            decode step's (every rank routes every token alike)."""
            if cf is None:
                ids = [r[i] for i in range(L) for r in calls]
            else:
                ids = [torch.cat([r[i].view(B, S // m, -1) for r in calls],
                                 1).view(B * S, -1) for i in range(L)]
            return [x.to(mesh.device) for x in ids + calls[0][L:]]

        one = (contextlib.nullcontext() if cf is not None
               else _moe_chunked(1, m))
        replay = _RoutingPin()
        with torch.no_grad(), one:
            free, _ = model.forward_prefill(whole, batch, cache_len)
            with replay.replay(pinned(prefill_calls)):
                last1, _ = model.forward_prefill(whole, batch, cache_len)
            d, d_free = (_rel(last4.float(), x.float()) for x in (last1, free))
            with _RoutingPin().replay(pinned(gen_calls)):
                one_tokens = generate(model, whole, batch,
                                      max_new=TP_CONTEXT_NEW,
                                      cache_len=cache_len)
            with _RoutingPin().replay(pinned(gen_calls)):
                ties = _greedy_rule(model, whole, batch, tp_tokens,
                                    one_tokens, cache_len, SERVE_TOL, name)
        what = (f"one card's MoE layer chunked as model {m} chunks it"
                if cf is None else f"one card's whole layer, capacity_factor "
                                   f"{cf} (no choice dropped)")
        say(f"{name} context: {cfg.arch_id} at {cfg.n_layers} of its "
            f"layers (full width), model {m} against {what}, on the ranks' "
            f"expert choices: prefill logits differ by {d:.3e} of their max "
            f"(limit {SERVE_TOL}; unpinned {d_free:.3e}, its own top-"
            f"{cfg.moe.top_k} differing in {replay.flips} of "
            f"{replay.choices} token-layers, by at most {replay.gap:.3e} in "
            f"probability; limits {ROUTE_FLIP_SHARE} of them and "
            f"{ROUTE_GAP_TOL}); {TP_CONTEXT_NEW} greedy tokens within the rule "
            f"(margin {SERVE_TOL} of the max), tied steps a request {ties}")
        if not d <= SERVE_TOL:
            fail(f"{name} context: model {m}'s prefill disagrees with "
                 f"one card's ({what})")
        replay.hold(f"{name} context")
        out = {"prefill_vs_one": d, "unpinned": d_free, "ties": ties,
               "flips": replay.flips, "choices": replay.choices,
               "max_gap": replay.gap, "capacity_factor": cf}
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_tp_moe(mesh, say, name="serve_tp_moe", cfg=None,
                  context_cfs=(None, SERVE_MOE_CF),
                  one_card=f"one card {SERVE_MOE_ONE_CARD_MS} ms, serve_moe"
                  ) -> dict:
    """serve_tp_moe on this rank: qwen2-moe-a2.7b (or ``cfg``) at model
    4, then its context checks at TP_CONTEXT_LAYERS layers, one a capacity
    factor of ``context_cfs`` (``_moe_context``); ``one_card``: the
    one-card prefill printed beside. Rank 0's row."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.models.common import local_shape, model_axis
    from repro_torch.models.moe import padded_experts
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.tree import tree_flatten, tree_leaves

    dev, n = mesh.device, mesh.size
    cfg = dataclasses.replace(cfg or get_config("qwen2-moe-a2.7b"),
                              flash_attention=True)
    model = build_model(cfg)
    tp = model_axis(mesh)
    pds = [pd for _, pd in tree_flatten(model.param_pd)]
    reckoned = sum(math.prod(local_shape(pd, tp)) for pd in pds)
    n_whole = sum(math.prod(pd.shape) for pd in pds)
    n_req, n_prompt, n_new = TP_SERVE
    torch.cuda.synchronize()
    dist.barrier()
    t = time.perf_counter()
    params = pinit.materialize(model.param_pd, seed=0, device=dev,
                               dtype=torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    dist.barrier()
    all_init_s = time.perf_counter() - t
    n_local = sum(x.numel() for x in tree_leaves(params))
    if n_local != reckoned:
        fail(f"{name}: {n_local} params a rank, the specs give "
             f"{reckoned}")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (n_req, n_prompt),
                           generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": tokens}
    cache_len = _serve_cache(cfg, batch, n_new)
    generate(model, params, batch, max_new=2, cache_len=cache_len,
             mesh=mesh)                    # warm-up: not timed, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    _zero(*_counters().values())
    out = generate(model, params, batch, max_new=n_new, cache_len=cache_len,
                   timings=timings, mesh=mesh)
    torch.cuda.synchronize()
    counts = _read_path(name, {"k5": cfg.n_layers})
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad(), _collectives() as pre:
        last, cache = model.forward_prefill(params, batch, cache_len, mesh)
    with torch.no_grad(), _collectives() as dec:
        dl, _ = model.forward_decode(params, cache, out[:, :1],
                                     _prompt_pos(cfg, batch), mesh)
    del cache
    for what, got, want in zip(("prefill", "decode step"), (pre, dec),
                               _moe_collectives(cfg)):
        if got != want:
            fail(f"{name}: a {what} calls {got}; the model axis "
                 f"makes {want}")
    if not (bool(torch.isfinite(last).all())
            and bool(torch.isfinite(dl).all())):
        fail(f"{name}: non-finite logits")
    outs, peaks, inits = ([None] * n for _ in range(3))
    dist.all_gather_object(outs, out.cpu())
    dist.all_gather_object(peaks, peak)
    dist.all_gather_object(inits, init_s)
    if tuple(out.shape) != (n_req, n_new) or not all(
            torch.equal(o, outs[0]) for o in outs):
        fail(f"{name}: the ranks' tokens differ or have shape "
             f"{tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{name}: a token outside the vocabulary")
    q1, med, q3 = statistics.quantiles(timings["decode_ms"], n=4)
    rate = n_req * n_prompt / timings["prefill_ms"] * 1e3
    E = padded_experts(cfg)
    full_depth = get_config(cfg.arch_id).n_layers
    depth = ("" if cfg.n_layers == full_depth
             else f" (of its {full_depth})")
    say(f"{name}: {cfg.arch_id}, {cfg.n_layers} layers{depth} at full "
        f"width, model {n}: {n_local / 1e9:.3f} B params a rank of "
        f"{n_whole / 1e9:.3f} B (the specs' reckoning, bf16; {E // n} of the "
        f"{E} padded experts a rank), pinit {all_init_s:.2f} s (the ranks' "
        f"own: {[round(s, 2) for s in inits]}); {n_req} requests of "
        f"{n_prompt} tokens, {n_new} new, cache {cache_len} rows; prefill "
        f"{timings['prefill_ms']:.2f} ms ({rate:.0f} prompt tokens/s; "
        f"{one_card}); decode ms a token median "
        f"{med:.3f} (p25 {q1:.3f}, p75 {q3:.3f}), {n_req * 1e3 / med:.1f} "
        f"tokens/s; peak memory a rank GiB "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; a prefill {pre}, a "
        f"decode step {dec}; flash_attention {counts['k5']} launches a "
        f"rank; every rank's tokens equal")
    say(f"{name}: first request's tokens {out[0].tolist()}")
    row = {"arch": cfg.arch_id, "layers": cfg.n_layers, "model": n,
           "params_a_rank": n_local, "params": n_whole,
           "pinit_s": all_init_s, "pinit_rank_s": inits,
           "prefill_ms": timings["prefill_ms"],
           "decode_ms": {"p25": q1, "median": med, "p75": q3},
           "tokens_per_s": n_req * 1e3 / med,
           "peak_gib": [p / 2 ** 30 for p in peaks], "sizes": list(TP_SERVE),
           "cache_len": cache_len,
           "collectives": {"prefill": pre, "decode_step": dec},
           "launches": counts}
    del params, out, last, dl
    gc.collect()
    torch.cuda.empty_cache()

    # context: TP_CONTEXT_LAYERS layers at full width, model 4 against one
    # card, chunked alike (cf None), then (serve_tp_moe) at SERVE_MOE_CF
    # against the whole layer
    cfg4 = dataclasses.replace(cfg, n_layers=TP_CONTEXT_LAYERS)
    model4 = build_model(cfg4)
    p4 = pinit.materialize(model4.param_pd, seed=0, device=dev,
                           dtype=torch.bfloat16, mesh=mesh)
    for key, cf in zip(("context", "context_cf"), context_cfs):
        row[key] = _moe_context(model4, mesh, p4, batch, cache_len, say,
                                cf=cf, name=name)
    del p4
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return row


def _serve_tp_mla(mesh, say) -> dict:
    """serve_tp_mla on this rank: deepseek-v2-236b at full width, its
    depth cut to TP_MLA_LAYERS, at model 4 (MLA's heads split, the latent
    whole on every rank; 40 of the 160 experts a rank), then its context
    at TP_CONTEXT_LAYERS against one card chunked alike. Rank 0's row."""
    import dataclasses

    from repro_torch.configs import get_config
    full = get_config("deepseek-v2-236b")
    say(f"serve_tp_mla: {full.arch_id}'s depth cut to {TP_MLA_LAYERS} of "
        f"its {full.n_layers} layers (full width)")
    return _serve_tp_moe(
        mesh, say, "serve_tp_mla",
        dataclasses.replace(full, n_layers=TP_MLA_LAYERS),
        context_cfs=(None,),
        one_card=f"one card: serve_mla at {MLA_LAYERS} layers")


def _lm_train_tp_mla(say) -> dict:
    """lm_train_tp_mla on this rank: deepseek-v2-236b at full width, its
    depth cut to TP_MLA_TRAIN_LAYERS, ``fsdp`` off, lm_train_tp's run at
    TP_MLA_TRAIN a data rank with the state donated, against one card
    with the MoE layer chunked as (2, 2) chunks it. Rank 0's row."""
    import dataclasses

    from repro_torch.configs import get_config
    full = get_config("deepseek-v2-236b")
    say(f"lm_train_tp_mla: {full.arch_id}'s depth cut to "
        f"{TP_MLA_TRAIN_LAYERS} of its {full.n_layers} layers (full width), "
        f"fsdp off (the masters whole over data: fsdp over data ranks is "
        f"item 6.3's fsdp part)")
    return _lm_train_tp(say, "lm_train_tp_mla", dataclasses.replace(
        full, n_layers=TP_MLA_TRAIN_LAYERS, fsdp=False), TP_MLA_TRAIN,
        moe_chunks=(2, 2), donate=True)


def _lm_train_tp_moe(mesh4, say) -> dict:
    """lm_train_tp_moe on this rank: (a) lm_train_tp's run of
    qwen2-moe-a2.7b at MOE_TRAIN_LAYERS against one card chunked alike;
    (b) TP_MOE_DEEP_LAYERS layers at (data 1, model 4) (``mesh4``):
    TP_TRAIN_STEPS steps, finite losses, the replicated masters the same
    bits on every rank, K4 and K1 on the path. Rank 0's rows."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.models.common import dp_axes
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    full = get_config("qwen2-moe-a2.7b")
    say(f"lm_train_tp_moe: {full.arch_id}'s depth cut to {MOE_TRAIN_LAYERS} "
        f"of its {full.n_layers} layers (full width), as lm_train_moe")
    row = {"two": _lm_train_tp(say, "lm_train_tp_moe", dataclasses.replace(
        full, n_layers=MOE_TRAIN_LAYERS), TP_TRAIN, moe_chunks=(2, 2))}

    # (b) the deep run at (data 1, model 4)
    cfg = dataclasses.replace(full, n_layers=TP_MOE_DEEP_LAYERS)
    dev = mesh4.device
    model = build_model(cfg)
    sched = make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                         total_steps=TP_TRAIN_STEPS,
                                         decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    rows_a_rank, seq = TP_TRAIN
    shape = InputShape("train_4k", "train", seq, rows_a_rank)
    # the state donated, as the CLI's loop does: the update writes the
    # masters and momentum in place (a second copy of them, 28 GiB a
    # rank, does not fit beside the gradients and K1's packs)
    step = make_train_step(model, opt, sched, smoothing=0.1, mesh=mesh4,
                           comm="xla", donate=True)
    part = make_batch_fn(cfg, shape, device=dev, mesh=mesh4,
                         axes=dp_axes(mesh4))
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    t = time.perf_counter()
    state = init_state(model, 0, device=dev, **sharded_state_kwargs(step))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_local = sum(x.numel() for x in tree_leaves(state.params))
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(*_counters().values())
    for i in range(TP_TRAIN_STEPS):
        batch = part(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
    counts = _read_path("lm_train_tp_moe", {"k4": TP_TRAIN_STEPS,
                                            "k4_bwd": TP_TRAIN_STEPS,
                                            "k1": 2 * TP_TRAIN_STEPS})
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * mesh4.size
    dist.all_gather_object(peaks, peak)
    rep_same = _replicated_same(state, model, mesh4)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses):
        fail(f"lm_train_tp_moe: deep losses not all finite: {losses}")
    if not rep_same:
        fail("lm_train_tp_moe: the deep run's replicated masters differ "
             "between ranks")
    med = statistics.median(times[1:])
    tokens = rows_a_rank * seq
    cut = ("" if cfg.n_layers == full.n_layers else
           f", its depth cut to {cfg.n_layers} of {full.n_layers} (the "
           f"deepest that fits: PERF.md §4)")
    say(f"lm_train_tp_moe: {cfg.arch_id}, {cfg.n_layers} layers at full "
        f"width{cut}, (data 1, model {mesh4.size}), comm='xla', remat, LARS "
        f"with K1, {rows_a_rank} x {seq} tokens: {n_local / 1e9:.3f} B "
        f"params a rank, init_state {init_s:.2f} s; losses "
        f"{[round(v, 4) for v in losses]} (finite); replicated masters and "
        f"momentum the same bits on every rank; step times ms "
        f"{[round(x * 1e3, 2) for x in times]}, median after the first "
        f"{med * 1e3:.2f} ms, {tokens / med:.0f} tokens/s on {mesh4.size} "
        f"cards; peak memory a rank GiB "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; launches K4 "
        f"{counts['k4']} + {counts['k4_bwd']}, K1 {counts['k1']}")
    row["deep"] = {"layers": [cfg.n_layers, full.n_layers],
                   "mesh": [1, mesh4.size], "batch": [rows_a_rank, seq],
                   "params_a_rank": n_local, "init_s": init_s,
                   "losses": losses, "step_ms": [x * 1e3 for x in times],
                   "median_ms": med * 1e3, "tokens_per_s": tokens / med,
                   "peak_gib": [p / 2 ** 30 for p in peaks],
                   "replicated_same": rep_same, "launches": counts}
    launches = dict(counts)
    if row["two"] is not None:
        for key, v in row["two"]["launches"].items():
            launches[key] = launches.get(key, 0) + v
    row["launches"] = launches
    dist.barrier()
    return row if mesh4.rank == 0 else None


def _shared_dir(mesh, prefix: str) -> str:
    """A fresh directory under build/ that every rank of the job names
    (rank 0 makes it)."""
    import tempfile

    import torch.distributed as dist
    names = [None]
    if mesh.rank == 0:
        (ROOT / "build").mkdir(exist_ok=True)
        names[0] = tempfile.mkdtemp(dir=ROOT / "build", prefix=prefix)
    dist.broadcast_object_list(names, src=0)
    return names[0]


def _ckpt_tp(mesh4, say) -> dict:
    """ckpt_tp on this rank: lm_train_tp's model and recipe at (data 2,
    model 2), TP_CKPT_STEPS steps through loop.train with a checkpoint a
    step (the counts read just after); the committed file's leaves whole
    and its per-key sha256 the state's gathered whole; a resume at (2, 2)
    for one more step against an uninterrupted run, bit for bit under
    torch.use_deterministic_algorithms (else within DUR_TOL of the max,
    the op named); the file loaded at (1, 4) and (4, 1), gathered
    bit-equal to it, and a finite step on each. Rank 0's row."""
    import hashlib
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import dp_axes, local_shape, model_axis
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, loop
    from repro_torch.train.state import TrainState, init_state, \
        sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    pd = model.param_pd
    total = TP_CKPT_STEPS + 1
    sched = make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                         total_steps=total, decay="poly2"))
    opt = lars.OptConfig(kind="lars", weight_decay=5e-5, use_kernel=True)
    rows_a_rank, seq = TP_TRAIN

    def setup(m):
        mesh = make_local_mesh(m)
        n_data = mesh.axis("data").size
        step = make_train_step(model, opt, sched, smoothing=0.1, mesh=mesh,
                               comm="xla")
        part = make_batch_fn(cfg, InputShape("train_4k", "train", seq,
                                             rows_a_rank * n_data),
                             device=mesh.device, mesh=mesh,
                             axes=dp_axes(mesh))
        return mesh, step, part

    def template(mesh):
        """A state of ``mesh``'s shapes to load into (not initialised)."""
        tp = model_axis(mesh)
        flat = tree_flatten(pd)
        leaves = lambda: tree_unflatten(  # noqa: E731
            [p for p, _ in flat],
            [torch.empty(local_shape(x, tp), device=mesh.device)
             for _, x in flat])
        return TrainState(0, leaves(), leaves())

    def whole(state, mesh):
        """{checkpoint key: numpy} of the state gathered whole (every rank
        joins; rank 0 keeps the arrays)."""
        out = {}
        for f in ("params", "mom"):
            for k, v in ckpt._flatten(ckpt._whole(getattr(state, f), pd,
                                                  mesh)).items():
                if mesh.rank == 0:
                    out[f"{f}|{k}"] = v.cpu().numpy()
        return out

    def leaves(state):
        return [x for f in (state.params, state.mom)
                for _, x in tree_flatten(f)]

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    sha = lambda a: hashlib.sha256(  # noqa: E731
        np.ascontiguousarray(a).tobytes()).hexdigest()
    mesh, step, part = setup(2)
    dev = mesh.device
    d = _shared_dir(mesh4, "ckpt_tp_")
    saves, real_save = [], ckpt.save

    def timed_save(*a, **kw):
        r, secs = timed(real_save, *a, **kw)
        saves.append(secs)
        return r

    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.empty_cache()
            state0 = init_state(model, 0, device=dev,
                                **sharded_state_kwargs(step))
            _zero(*_counters().values())
            ckpt.save = timed_save
            try:
                state, _ = loop.train(state0, step, part,
                                      steps=TP_CKPT_STEPS, ckpt_dir=d,
                                      ckpt_every=1, keep_last_k=1,
                                      log_every=0)
            finally:
                ckpt.save = real_save
            counts = _read_path("ckpt_tp", {"k4": TP_CKPT_STEPS,
                                            "k4_bwd": TP_CKPT_STEPS,
                                            "k1": 2 * TP_CKPT_STEPS})
            del state0
            got = whole(state, mesh)
            tag = ckpt.latest_tag(d)
            path = os.path.join(d, f"ckpt_{tag}.npz")
            data, bad_shape, bad_sha = {}, [], []
            if mesh.rank == 0:
                with np.load(path, allow_pickle=False) as z:
                    data = {k: z[k] for k in z.files}
                for f in ("params", "mom"):
                    for k, x in ckpt._flatten(pd).items():
                        if data[f"{f}|{k}"].shape != tuple(x.shape):
                            bad_shape.append(f"{f}|{k}")
                bad_sha = [k for k, v in got.items()
                           if sha(v) != sha(data[k])]
                if bad_shape or bad_sha or set(got) != set(data):
                    fail(f"ckpt_tp: the committed file's leaves "
                         f"{bad_shape[:3]} are not whole, or its keys "
                         f"{bad_sha[:3]} differ from the state gathered "
                         f"whole")
            del got
            resumed, load_s = timed(ckpt.load, template(mesh), d, mesh=mesh,
                                    param_pd=pd)
            resumed, _ = loop.train(resumed, step, part, steps=total,
                                    log_every=0)
            straight, _ = loop.train(
                init_state(model, 0, device=dev,
                           **sharded_state_kwargs(step)),
                step, part, steps=total, log_every=0)
            same = resumed.step == straight.step == total and all(
                torch.equal(a, b) for a, b in zip(leaves(resumed),
                                                  leaves(straight)))
            worst = max(((a - b).abs().max()
                         / b.abs().max().clamp_min(1e-30)).item()
                        for a, b in zip(leaves(resumed), leaves(straight)))
            del resumed, straight, state
        nondet = sorted({str(w.message).splitlines()[0] for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(before)
    sames = [None] * mesh.size
    dist.all_gather_object(sames, (same, worst))
    if nondet:
        how = (f"{max(w for _, w in sames):.3e} of the max (limit {DUR_TOL}: "
               f"no deterministic form for {nondet[0]})")
        if not all(w <= DUR_TOL for _, w in sames):
            fail(f"ckpt_tp: the resumed run's masters part from the "
                 f"uninterrupted run's: {how}")
    else:
        how = "bit for bit (torch.use_deterministic_algorithms)"
        if not all(s for s, _ in sames):
            fail("ckpt_tp: the resumed run's masters and momentum are not "
                 "the uninterrupted run's bit for bit")
    gc.collect()
    torch.cuda.empty_cache()

    # the same file onto (data 1, model 4) and (data 4, model 1)
    other = {}
    for m in (4, 1):
        em, estep, epart = setup(m)
        s, secs = timed(elastic.load_resharded, d, template(em), None, 1,
                        mesh=em, param_pd=pd)
        got = whole(s, em)
        if em.rank == 0 and not (
                set(got) == set(data) and all(
                    got[k].dtype == data[k].dtype
                    and got[k].tobytes() == data[k].tobytes() for k in got)):
            fail(f"ckpt_tp: the file loaded at (data {4 // m}, model {m}) "
                 f"and gathered is not the file bit for bit")
        del got
        s, metrics = estep(s, epart(s.step))
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            fail(f"ckpt_tp: a non-finite step at (data {4 // m}, model {m})")
        other[f"{4 // m}x{m}"] = {"load_s": secs, "loss": loss}
        del s
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    row = None
    if mesh.rank == 0:
        mb = os.path.getsize(path) / 1e6
        say(f"ckpt_tp: {cfg.arch_id} at full width and depth, (data 2, "
            f"model 2), lm_train_tp's recipe, {TP_CKPT_STEPS} steps through "
            f"loop.train with a checkpoint a step: payload {mb:.1f} MB (f32 "
            f"masters and momentum, every leaf whole; per-key sha256 the "
            f"state's gathered whole), saves ms "
            f"{[round(x * 1e3, 1) for x in saves]}, load at (2, 2) "
            f"{load_s * 1e3:.1f} ms; resumed for step {total}: {how}; "
            f"loaded at (1, 4) in {other['1x4']['load_s'] * 1e3:.1f} ms and "
            f"(4, 1) in {other['4x1']['load_s'] * 1e3:.1f} ms, each gathered "
            f"bit-equal to the file, a step from each: losses "
            f"{other['1x4']['loss']:.4f}, {other['4x1']['loss']:.4f}; "
            f"launches K4 {counts['k4']} + {counts['k4_bwd']}, K1 "
            f"{counts['k1']}")
        row = {"arch": cfg.arch_id, "payload_mb": mb, "save_ms":
               [x * 1e3 for x in saves], "load_ms": load_s * 1e3,
               "resume": how, "other_meshes": other, "launches": counts}
        shutil.rmtree(d, ignore_errors=True)
    del data
    gc.collect()
    dist.barrier()
    return row


def tp_rank(phases=TP_PHASES):
    """One rank of the model-axis phases (``chip_smoke.py --tp-rank
    [PHASE ...]`` under torch.distributed.run, one card each), those of
    TP_PHASES named in ``phases`` in its order: serve_tp, serve_tp_hybrid,
    serve_tp_audio, serve_tp_vlm and serve_tp_moe on the (data 1, model 4)
    mesh, lm_train_tp, lm_train_tp_xlstm, ckpt_tp (which also loads onto
    (1, 4) and (4, 1)) and lm_train_tp_frames on the (data 2, model 2) one,
    lm_train_tp_moe on both, resnet_xla on (data 4, model 1), then the CLI
    runs in process. Rank 0 prints the lines and, last, ``tp-json:
    {...}``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(4)
    say = (lambda msg: print(msg, flush=True)) if mesh.rank == 0 else \
        (lambda msg: None)
    runs = {"serve_tp": lambda: _serve_tp(mesh, say),
            "lm_train_tp": lambda: _lm_train_tp(say),
            "serve_tp_hybrid": lambda: _serve_tp_hybrid(mesh, say),
            "lm_train_tp_xlstm": lambda: _lm_train_tp_xlstm(say),
            "resnet_xla": lambda: _resnet_xla(say),
            "ckpt_tp": lambda: _ckpt_tp(mesh, say),
            "serve_tp_audio": lambda: _serve_tp_frames(
                mesh, say, "serve_tp_audio", "whisper-base", AUDIO_SERVE),
            "serve_tp_vlm": lambda: _serve_tp_frames(
                mesh, say, "serve_tp_vlm", "internvl2-2b", VLM_SERVE),
            "lm_train_tp_frames": lambda: _lm_train_tp_frames(say),
            "serve_tp_moe": lambda: _serve_tp_moe(mesh, say),
            "lm_train_tp_moe": lambda: _lm_train_tp_moe(mesh, say),
            "serve_tp_mla": lambda: _serve_tp_mla(mesh, say),
            "lm_train_tp_mla": lambda: _lm_train_tp_mla(say),
            "cli": lambda: _tp_cli_in_process(mesh, say)}
    out, seconds = {"cards": mesh.size}, {}
    for name in TP_PHASES:
        if name not in phases:
            continue
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out[name] = runs[name]()
        seconds[name] = time.perf_counter() - t
    say("tp: phase seconds " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in seconds.items()))
    out["seconds"] = seconds
    say("tp-json: " + json.dumps(out))
    mesh.destroy()


def run_tp(phases=TP_PHASES):
    """The model-axis phases on four cards, one rank each over NCCL
    (``torch.distributed.run`` starts this script with ``--tp-rank``), the
    CLI runs among them. None with fewer than four cards."""
    import torch
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    if n < 4:
        print(f"{', '.join(TP_PHASES)}: not run: {n} card(s); the phases "
              f"need 4", flush=True)
        return None
    out = _launch_ranks(["--tp-rank", *phases], 4, TP_TIMEOUT_S,
                        "the model-axis phases")
    result = None
    for line in out.splitlines():
        if line.startswith("tp-json: "):
            result = json.loads(line[len("tp-json: "):])
        elif line.startswith(("serve_tp", "lm_train_tp", "resnet_xla",
                              "ckpt_tp", "tp")):
            print(line, flush=True)
    if result is None:
        fail("the model-axis phases printed no result")
    return result


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


#: K5's shapes the ``--tp`` call holds against the plain version: a rank's
#: launches in the model-axis prefills
TP_K5_SHAPES = ("serve_tp", "serve_tp_hybrid", "serve_tp_audio_enc",
                "serve_tp_audio_cross", "serve_tp_vlm", "serve_tp_moe",
                "serve_tp_mla")


def tp_main(phases=()):
    """``python3 chip_smoke.py --tp [PHASE ...]``: the card check, the
    build, K5 at TP_K5_SHAPES and the model-axis phases alone (on four
    cards; those of TP_PHASES named, all by default), then the phases'
    JSON (with their kernels' launches), the card's name and power limit
    and, last, the ``{"ok": true, ...}`` line."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    card = _card_line()
    unknown = set(phases) - set(TP_PHASES)
    if unknown:
        fail(f"--tp: unknown phases {sorted(unknown)}; of {TP_PHASES}")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import backend
    t = time.time()
    built = backend.build()
    print(f"built {sorted(built) or 'nothing (current)'} in "
          f"{time.time() - t:.1f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = backend.resolve_device(None)
    k5 = {name: _flash_case(dev, gen, *next(c for c in FLASH_SHAPES
                                            if c[0] == name))
          for name in TP_K5_SHAPES}
    result = run_tp(tuple(phases) or TP_PHASES)
    if result is None:
        sys.exit(1)
    result["k5"] = k5
    print(json.dumps({"tp": result}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _launch_ranks(args, n: int, timeout_s: float, what: str) -> str:
    """This script under ``torch.distributed.run`` on ``n`` cards, one
    rank each, with ``args``; rank 0's standard output. Fails if a rank
    fails or the run outlasts ``timeout_s`` (then every rank is killed)."""
    import signal
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(n), "--master-addr", "127.0.0.1", "--master-port", str(port),
           str(ROOT / "chip_smoke.py"), *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env=dict(os.environ, OMP_NUM_THREADS="4"))
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{what} did not end within {timeout_s} s")
    if proc.returncode != 0:
        for line in out.splitlines()[-20:]:
            print(line, flush=True)
        fail(f"{what} exited {proc.returncode}: {err[-4000:]}")
    return out


def run_ring():
    """The ring phases on min(count, 4) cards, one rank each over NCCL
    (``torch.distributed.run`` starts this script with ``--ring-rank``);
    None on one card."""
    import torch
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print(f"ring: not run: {n} card; the multi-card path needs >= 2 "
              f"(NCCL gives each rank a card of its own)", flush=True)
        return None
    torch.cuda.empty_cache()
    out = _launch_ranks(["--ring-rank"], n, RING_TIMEOUT_S,
                        "the ring phases")
    result = None
    for line in out.splitlines():     # rank 0's lines; not the ranks'
        if line.startswith("ring-json: "):        # MLPerf tag streams
            result = json.loads(line[len("ring-json: "):])
        elif line.startswith("ring"):
            print(line, flush=True)
    if result is None:
        fail("the ring phases printed no result")
    return result


def check_lm_shard_site(dev):
    """K1 and K2 at the four-card LM step's call site, measured on one
    card: rank 0's shards of full-width qwen1.5-0.5b's 4 MB plan on 4
    shards (224 buckets, ~116 M f32 elements a rank). K1's one call over
    the 448 p and g shards (``batched_sumsq_multi``: two pass-1 launches,
    the pointer table holds 256) against its plain version at rtol 2e-3;
    K2's one call over the 224 buckets (``lars_packed_update_multi``: two
    launches, 128 a table) against its plain version at rtol 1e-5 / atol
    1e-6 and equal across two calls. Times each beside its plain version
    and bound. Returns ({'lm_shard_site': ...} for K1, the same for K2)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing
    from repro_torch.kernels import batched_norm, lars_update, ref
    from repro_torch.models.registry import build_model

    plan = bucketing.make_plan(
        build_model(get_config("qwen1.5-0.5b")).param_pd)
    if plan.n_buckets != LM_RING_BUCKETS:
        fail(f"the qwen1.5-0.5b 4 MB plan has {plan.n_buckets} buckets, "
             f"not {LM_RING_BUCKETS}")
    gen = torch.Generator(device=dev).manual_seed(3)
    p, g, m, segs, seg_all, trust = _shard_case(plan, 4, 0, dev, gen)
    n_t = plan.n_tensors
    got = batched_norm.batched_sumsq_multi((p, g), seg_all, n_t)
    want = ref.batched_sumsq_multi((p, g), seg_all, n_t)
    torch.cuda.synchronize()
    k1_rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    if not k1_rel <= 2e-3:
        fail(f"batched_sumsq_multi at the LM shard site disagrees with its "
             f"plain version (max rel err {k1_rel:.3e}, rtol 2e-3)")
    lr = torch.tensor(0.37, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, wd=5e-5)
    clone = lambda xs: [x.clone() for x in xs]
    runs = [lars_update.lars_packed_update_multi(clone(p), g, clone(m),
                                                 trust, seg_all, **kw)
            for _ in range(2)]
    want2 = ref.lars_packed_update_multi(clone(p), g, clone(m), trust,
                                         seg_all, **kw)
    torch.cuda.synchronize()
    k2_abs = 0.0
    for b in range(plan.n_buckets):
        for x, x2, y in ((runs[0][0][b], runs[1][0][b], want2[0][b]),
                         (runs[0][1][b], runs[1][1][b], want2[1][b])):
            if not torch.equal(x, x2):
                fail(f"lars_packed_update_multi at the LM shard site: two "
                     f"calls differ (bucket {b})")
            if not torch.allclose(x, y, rtol=1e-5, atol=1e-6):
                fail(f"lars_packed_update_multi at the LM shard site "
                     f"disagrees with its plain version (bucket {b}, rtol "
                     f"1e-5, atol 1e-6)")
            k2_abs = max(k2_abs, (x - y).abs().max().item())
    del runs, want2
    elems, chunks = sum(x.numel() for x in p), seg_all.numel()
    k1_ms = time_ms(lambda: batched_norm.batched_sumsq_multi(
        (p, g), seg_all, n_t), iters=20, warmup=3)
    k1_plain = time_ms(lambda: ref.batched_sumsq_multi((p, g), seg_all, n_t),
                       iters=5, warmup=1)
    k1_b, k1_by = bound_ms(2 * 4 * elems + 4 * chunks + 2 * 4 * n_t,
                           2 * 2 * elems)
    views = _segment_views(p, segs) + _segment_views(g, segs)
    k1_lib = time_ms(lambda: torch._foreach_norm(views), iters=20, warmup=3)
    k2_ms = time_ms(lambda: lars_update.lars_packed_update_multi(
        p, g, m, trust, seg_all, **kw), iters=20, warmup=3)
    k2_plain = time_ms(lambda: ref.lars_packed_update_multi(
        p, g, m, trust, seg_all, **kw), iters=5, warmup=1)
    k2_b, k2_by = bound_ms(5 * 4 * elems + 4 * chunks + 4 * n_t + 4,
                           6 * elems)
    # the device alone, the host's table packing hidden
    k1_dev = device_ms(lambda: batched_norm.batched_sumsq_multi(
        (p, g), seg_all, n_t), iters=10)
    k2_dev = device_ms(lambda: lars_update.lars_packed_update_multi(
        p, g, m, trust, seg_all, **kw), iters=10)
    dev_us = lambda t: "host-paced" if t is None else f"{t * 1e3:.1f} us"
    print(f"LM shard site (qwen1.5-0.5b 4 MB plan, {plan.n_buckets} "
          f"buckets, rank 0 of 4, {elems} elements): batched_sumsq_multi "
          f"over {2 * plan.n_buckets} shards {k1_ms * 1e3:.1f} us (device "
          f"alone {dev_us(k1_dev)}), plain "
          f"{k1_plain * 1e3:.1f} us, bound {k1_b * 1e3:.1f} us ({k1_by}), "
          f"max rel err {k1_rel:.3e} (rtol 2e-3), torch._foreach_norm "
          f"over the same {len(views)} per-tensor views "
          f"{k1_lib * 1e3:.1f} us; lars_packed_update_multi "
          f"over {plan.n_buckets} buckets {k2_ms * 1e3:.1f} us (device "
          f"alone {dev_us(k2_dev)}), plain "
          f"{k2_plain * 1e3:.1f} us, bound {k2_b * 1e3:.1f} us ({k2_by}), "
          f"max abs err {k2_abs:.3e} (rtol 1e-5, atol 1e-6), two calls "
          f"bit-equal", flush=True)
    site = lambda ms, dev, plain, b, by, err: {
        "shape": f"qwen1.5-0.5b 4 MB plan, rank 0 of 4: {plan.n_buckets} "
                 f"buckets, {elems} elements", "ms": ms, "device_ms": dev,
        "plain_ms": plain, "bound_ms": b, "bound_by": by, "max_err": err}
    return ({"lm_shard_site": dict(
                site(k1_ms, k1_dev, k1_plain, k1_b, k1_by, k1_rel),
                library_ms=k1_lib, library=f"torch._foreach_norm over the "
                f"{len(views)} per-tensor views of the 2 x {plan.n_buckets} "
                f"shards")},
            {"lm_shard_site": site(k2_ms, k2_dev, k2_plain, k2_b, k2_by,
                                   k2_abs)})


def _lm_sched():
    """The LM phases' schedule: LARS poly2 with a one-step warm-up."""
    from repro_torch.core.schedule import ScheduleConfig, make_schedule
    return make_schedule(ScheduleConfig(base_lr=LM_LR, warmup_steps=1,
                                        total_steps=LM_STEPS, decay="poly2"))


def _lm_ring_state(state0, step, mesh):
    """The state ``step`` takes, from the replicated ``state0`` (fresh
    buffers: the sharded step updates its input in place): the packed
    master shards and zero momentum of this rank on a sharded rung, the
    params and a zero momentum replicated."""
    import torch
    from repro_torch.train import state as st
    from repro_torch.tree import tree_map
    if step.sharding == "replicated":
        return st.TrainState(0, tree_map(torch.clone, state0.params),
                             tree_map(torch.zeros_like, state0.params))
    plan, n = step.bucket_plan, step.n_shards
    i = mesh.axis(step.shard_axis).index
    return st.TrainState(
        0, None if step.sharding == "zero3"
        else tree_map(torch.clone, state0.params),
        st.local_shards(st.init_packed_momentum(plan, n, device=mesh.device),
                        n, i), None,
        None if step.sharding == "zero2"
        else st.local_shards(st.init_packed_shards(state0.params, plan, n),
                             n, i))


def _lm_ring_want(comm, sharding, nb, steps):
    """The launches a run of ``steps`` LM steps must read: K3 folds 3 a
    bucket a step on four cards' ring, K1 twice a replicated step and once
    a sharded one, K2 once a sharded step (update_kernel), K4 once forward
    and once backward; zero3's checkpointed loss runs its forward, K4
    included, again in the backward."""
    sharded = sharding != "replicated"
    return {"k3": (3 * nb if comm == "ring" else 0) * steps,
            "k1": (1 if sharded else 2) * steps,
            "k2": (1 if sharded else 0) * steps,
            "k4": (2 if sharding == "zero3" else 1) * steps,
            "k4_bwd": steps}


def _sha(tree) -> str:
    """sha256 over a tensor tree's bytes, leaves in flatten order."""
    import hashlib
    from repro_torch.tree import tree_flatten
    h = hashlib.sha256()
    for path, x in tree_flatten(tree):
        h.update(path.encode())
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _lm_ring_run(model, mesh, comm, sharding, gather, state0, batch_fn,
                 say, ckpt_dir=None):
    """One configuration of the lm_ring phase: one warm-up step on a copy
    of its state, then ``LM_RING_STEPS`` timed steps through loop.train.
    Checks the launches and the losses; with ``ckpt_dir``, saves the state
    there (every rank's rows gathered, rank 0 writing). Returns (row, the
    masters after the timed steps)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import checkpoint, loop
    from repro_torch.train.state import host_snapshot
    from repro_torch.train.step import make_train_step

    dev, n = mesh.device, mesh.size
    ring = comm == "ring"
    step = make_train_step(
        model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                              use_kernel=True), _lm_sched(), smoothing=0.1,
        mesh=mesh, comm=CommConfig(strategy=comm, sharding=sharding,
                                   gather=gather, use_kernel=ring,
                                   update_kernel=sharding != "replicated",
                                   bucket_mb=4))
    plan = step.bucket_plan
    what = f"{comm} {sharding}{'/' + gather if gather else ''}"
    if plan.n_buckets != LM_RING_BUCKETS or step.sharding != sharding:
        fail(f"lm_ring {what}: {plan.n_buckets} buckets, sharding "
             f"{step.sharding!r}")
    state = _lm_ring_state(state0, step, mesh)
    step(host_snapshot(state), batch_fn(0))       # the warm-up, on a copy
    times = []

    def timed_step(s, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(s, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state, timed_step, batch_fn,
                                    steps=LM_RING_STEPS, log_every=1,
                                    seed=0)
    counts = _read_path(f"lm_ring {what}", _lm_ring_want(
        comm, sharding, plan.n_buckets, LM_RING_STEPS))
    peak = torch.cuda.max_memory_allocated(dev)
    peaks = [None] * n
    dist.all_gather_object(peaks, peak)
    losses = [h["loss"] for h in history]
    if len(losses) != LM_RING_STEPS or not all(math.isfinite(v)
                                               for v in losses):
        fail(f"lm_ring {what}: losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail(f"lm_ring {what}: loop.train did not reach run_stop")
    masters = loop.make_params_reader(step)(state)
    row = {"comm": comm, "sharding": sharding, "gather": gather,
           "buckets": plan.n_buckets, "step_ms": [t * 1e3 for t in times],
           "median_ms": statistics.median(times) * 1e3,
           "tokens_per_s": LM_BATCH * LM_SEQ * n / statistics.median(times),
           "peak_gib": [p / 2 ** 30 for p in peaks], "launches": counts,
           "losses": losses}
    if ckpt_dir is not None:
        t = time.perf_counter()
        checkpoint.save(state, ckpt_dir, tag=LM_CKPT_TAG,
                        comm_plan=step.comm_plan, mesh=mesh)
        row["save_ms"] = (time.perf_counter() - t) * 1e3
        if mesh.rank == 0:
            row["masters_sha256"] = _sha(masters)
    del state
    say(f"lm_ring: {what} ({plan.n_buckets} buckets): losses "
        f"{[round(v, 4) for v in losses]}; step times ms "
        f"{[round(t * 1e3, 2) for t in times]} after a warm-up step, median "
        f"{row['median_ms']:.2f} ms, {row['tokens_per_s']:.0f} tokens/s on "
        f"{n} cards; peak memory a rank GiB "
        f"{[round(p / 2 ** 30, 2) for p in peaks]}; launches a step K3 "
        f"{counts['k3'] / LM_RING_STEPS:g}, K1 "
        f"{counts['k1'] / LM_RING_STEPS:g}, K2 "
        f"{counts['k2'] / LM_RING_STEPS:g}, K4 "
        f"{counts['k4'] / LM_RING_STEPS:g} + "
        f"{counts['k4_bwd'] / LM_RING_STEPS:g}"
        + (f"; saved in {row['save_ms']:.0f} ms" if ckpt_dir else ""))
    return row, masters


def _lm_ring_hw(mesh, say):
    """The card's constants measured now (``launch/hw.measure``: the link
    along the data axis, HBM, bf16 matmul) beside ``launch/hw.py``'s;
    fails if the link's alpha or beta or the HBM rate is more than
    ``HW_TOL`` times off the module's."""
    from repro_torch.launch import hw
    got = hw.measure(mesh)
    mod = hw.H100
    rows = {"alpha_s": (got["link"]["alpha"], mod.link_alpha),
            "beta_bytes_per_s": (got["link"]["beta"], mod.link_bw),
            "hbm_bytes_per_s": (got["hbm_bw"], mod.hbm_bw),
            "bf16_flops_per_s": (got["peak_flops_bf16"],
                                 mod.peak_flops_bf16)}
    say(f"lm_ring hw: measured / launch/hw.py: "
        + ", ".join(f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in rows.items())
        + f"; link fit's largest relative residual "
          f"{got['link']['residual']:.3f} over "
          f"{[r[0] for r in got['link']['rows']]} bytes")
    for k in ("alpha_s", "beta_bytes_per_s", "hbm_bytes_per_s"):
        a, b = rows[k]
        if not (a > 0 and max(a / b, b / a) <= HW_TOL):
            fail(f"lm_ring hw: the measured {k} {a:.4g} is more than "
                 f"{HW_TOL}x off launch/hw.py's {b:.4g}")
    return {"measured": got, "module": {k: b for k, (_, b) in rows.items()}}


def _autotune_reading(model, mesh, batch_fn, name, say, want_fn, sched,
                      overlap_gate=False):
    """``bucket_mb='auto'`` with ``backward_profile='measured'`` on ring
    zero1 (K1, K2, K3 on): the chosen bucket size and the simulated step
    time, then 3 traced steps through loop.train: the measured step time
    (median of the last two) and obs.drift.compute's measured / predicted
    per span kind (the first step skipped). Fails if the profile fell back
    to the FLOPs model; with ``overlap_gate``, also unless the profile
    stamps under half of its groups in the backward's last tenth and the
    last step's rs spans all begin inside its backward span."""
    import torch
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.obs import drift as obs_drift
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import loop
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step

    sink, tracer = obs_metrics.MemorySink(), Tracer()
    with obs_metrics.default_registry().use_sink(sink):
        step = make_train_step(
            model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                                  use_kernel=True), sched, smoothing=0.1,
            mesh=mesh, comm=CommConfig(
                strategy="ring", sharding="zero1", bucket_mb="auto",
                backward_profile="measured", use_kernel=True,
                update_kernel=True), profile_batch=batch_fn(0),
            tracer=tracer)
    if sink.find("backward_profile_fallback") or \
            not sink.find("backward_profile_measured"):
        fail(f"autotune {name}: the measured profile was not used: "
             f"{[(e.name, e.value) for e in sink.events]}")
    tuned, prof = step.tuned, step.backward_profile
    state = init_state(model, 0, device=mesh.device,
                       **sharded_state_kwargs(step))
    times = []

    def timed_step(s, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(s, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(obs_metrics.MemorySink()):
        state, history = loop.train(state, timed_step, batch_fn, steps=3,
                                    log_every=1, seed=0, tracer=tracer)
    counts = _read_path(f"autotune {name}",
                        want_fn(step.bucket_plan.n_buckets, 3))
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(v) for v in losses):
        fail(f"autotune {name}: losses not all finite: {losses}")
    drifts = obs_drift.compute(tracer, step.comm_plan)
    kinds = {}
    for k in obs_drift.COMM_KINDS:
        ds = [d for d in drifts if d.kind == k]
        if ds:
            kinds[k] = {"spans": len(ds), "measured_s":
                        sum(d.measured_s for d in ds), "predicted_s":
                        sum(d.predicted_s for d in ds),
                        "rel_err": obs_drift.aggregate(ds)}
    if not kinds:
        fail(f"autotune {name}: no traced bucket comm span to score")
    # where the collectives start: each rs span's begin (the moment its
    # group's identity ran) in ms after the last step's backward span
    # begins, that span's length (it ends once the last shard is back),
    # and the measured profile's share of groups stamped in the backward's
    # last tenth
    last = tracer.steps[-1][1]
    bwd = next(sp for sp in last if sp.name == "backward")
    bwd_ms = (bwd.t1 - bwd.t0) * 1e3
    starts = sorted((sp.t0 - bwd.t0) * 1e3 for sp in last
                    if sp.name.startswith("rs["))
    late = sum(t >= 0.9 * prof.total_s for t in prof.cum_time_s) \
        / len(prof.cum_time_s)
    measured = statistics.median(times[1:])
    if overlap_gate and not (late < 0.5 and 0.0 <= starts[0]
                             and starts[-1] <= bwd_ms):
        fail(f"autotune {name}: the profile stamped {late:.3f} of its groups "
             f"in the backward's last tenth (limit: under 0.5) and the rs "
             f"spans begin {starts[0]:.2f}..{starts[-1]:.2f} ms into a "
             f"{bwd_ms:.2f} ms backward span (all must begin inside it)")
    say(f"autotune {name} (ring zero1, bucket_mb='auto', measured "
        f"profile: {len(prof.cum_elems)} groups, backward "
        f"{prof.total_s * 1e3:.1f} ms, forward {prof.t_forward_s * 1e3:.1f}"
        f" ms): chose {tuned.bucket_mb:g} MB x {tuned.n_buckets} buckets "
        f"({tuned.sim.mode}); simulated step {tuned.sim.t_step_s * 1e3:.2f} "
        f"ms, measured {measured * 1e3:.2f} ms (traced; steps "
        f"{[round(t * 1e3, 2) for t in times]}); drift measured/predicted "
        f"per span kind: "
        + ", ".join(f"{k} {v['measured_s'] * 1e3:.3f} / "
                    f"{v['predicted_s'] * 1e3:.3f} ms over {v['spans']} "
                    f"spans (rel err {v['rel_err']:+.3f})"
                    for k, v in kinds.items())
        + f"; rs spans begin {starts[0]:.1f} / "
          f"{statistics.median(starts):.1f} / {starts[-1]:.1f} ms (first / "
          f"median / last) into a {bwd_ms:.1f} ms backward span; the "
          f"profile stamped {late:.3f} of its groups in the backward's "
          f"last tenth")
    del state
    return {"bucket_mb": tuned.bucket_mb, "buckets": tuned.n_buckets,
            "mode": tuned.sim.mode, "sim_step_ms": tuned.sim.t_step_s * 1e3,
            "sim_exposed_ms": tuned.sim.t_exposed_s * 1e3,
            "profile_backward_ms": prof.total_s * 1e3,
            "profile_forward_ms": prof.t_forward_s * 1e3,
            "measured_step_ms": measured * 1e3,
            "step_ms": [t * 1e3 for t in times], "drift": kinds,
            "rs_begin_ms": [starts[0], statistics.median(starts),
                            starts[-1]], "backward_span_ms": bwd_ms,
            "profile_groups_in_last_tenth": late,
            "launches": counts, "losses": losses}


def lm_ring_rank(ckpt_dir):
    """One rank of the lm_ring phase (``chip_smoke.py --lm-ring-rank DIR``
    under torch.distributed.run, one card each): the card's constants,
    the LM configurations (masters against the psum anchor's; ring zero1's
    state saved to DIR), then the autotune readings. Rank 0 prints the
    lines and, last, ``lm-ring-json: {...}``."""
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.schedule import ScheduleConfig, linear_scaled_lr, \
        make_schedule
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train.state import init_state
    from repro_torch.tree import tree_flatten

    mesh = make_local_mesh()
    n, dev = mesh.size, mesh.device
    say = (lambda msg: print(msg, flush=True)) if mesh.rank == 0 else \
        (lambda msg: None)
    hw_row = _lm_ring_hw(mesh, say)
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", LM_SEQ,
                                             LM_BATCH * n), device=dev,
                             mesh=mesh)
    state0 = init_state(model, seed=0, device=dev)
    p0 = [x for _, x in tree_flatten(state0.params)]
    rows, anchor, worst = [], None, ("", 0.0)
    for comm, sharding, gather in LM_RING_CONFIGS:
        save = ckpt_dir if (comm, sharding) == ("ring", "zero1") else None
        row, masters = _lm_ring_run(model, mesh, comm, sharding, gather,
                                    state0, batch_fn, say, save)
        got = tree_flatten(masters)
        if anchor is None:
            anchor = [(p, x, (x - a).abs().max().item())
                      for (p, x), a in zip(got, p0)]
        else:
            d = max(((p, (x - want).abs().max().item() / max(upd, 1e-30))
                     for (_, x), (p, want, upd) in zip(got, anchor)),
                    key=lambda t: t[1])
            row["masters_of_update"] = list(d)
            worst = max(worst, d, key=lambda t: t[1])
            say(f"lm_ring: {comm} {sharding}: masters within {d[1]:.3e} of "
                f"the largest update of the psum anchor's ({d[0]}; limit "
                f"{LM_UPDATE_TOL})")
            if not d[1] <= LM_UPDATE_TOL:
                fail(f"lm_ring {comm} {sharding}: masters {d[1]:.3e} of the "
                     f"anchor's largest update off ({d[0]}; limit "
                     f"{LM_UPDATE_TOL})")
        rows.append(row)
        del masters, got
        torch.cuda.empty_cache()
    if min(upd for _, _, upd in anchor) <= 0.0:
        fail("lm_ring: the psum anchor left a tensor unchanged")
    del anchor, state0, p0
    torch.cuda.empty_cache()
    sharded = lambda nb, steps: _lm_ring_want("ring", "zero1", nb, steps)
    tune = {"lm": _autotune_reading(model, mesh, batch_fn, "qwen1.5-0.5b",
                                    say, sharded, _lm_sched())}
    del model
    torch.cuda.empty_cache()
    rcfg = get_config("resnet50")
    rbatch = make_batch_fn(rcfg, InputShape("in", "train", 0, BATCH * n),
                           device=dev, mesh=mesh)
    tune["resnet50"] = _autotune_reading(
        build_model(rcfg), mesh, rbatch, "resnet50", say,
        lambda nb, steps: {"k3": 3 * nb * steps, "k1": steps, "k2": steps},
        make_schedule(ScheduleConfig(
            base_lr=linear_scaled_lr(16.0, BATCH * n) / 4, warmup_steps=1,
            total_steps=RING_STEPS, decay="poly2")), overlap_gate=True)
    say("lm-ring-json: " + json.dumps({
        "cards": n, "runs": rows, "masters_worst_of_update": list(worst),
        "hw": hw_row, "autotune": tune}))
    mesh.destroy()


def run_lm_ring(ckpt_dir):
    """The lm_ring phase on four cards, one rank each over NCCL
    (``torch.distributed.run`` starts this script with ``--lm-ring-rank``);
    None with fewer than four cards."""
    import torch
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    if n < 4:
        print(f"lm_ring: not run: {n} card(s); the phase needs 4", flush=True)
        return None
    out = _launch_ranks(["--lm-ring-rank", str(ckpt_dir)], 4,
                        LM_RING_TIMEOUT_S, "the lm_ring phase")
    result = None
    for line in out.splitlines():
        if line.startswith("lm-ring-json: "):
            result = json.loads(line[len("lm-ring-json: "):])
        elif line.startswith(("lm_ring", "autotune")):
            print(line, flush=True)
    if result is None:
        fail("the lm_ring phase printed no result")
    return result


def _sha_masters(step, state) -> str:
    """sha256 of the masters a rank reads: the params on the replicated
    rung; on a sharded one the packed global buffers, gathered and hashed
    a bucket at a time (zamba2-7b's unpacked fp32 tree would take 27 GB
    beside its state)."""
    import hashlib

    from repro_torch.core import bucketing
    from repro_torch.train.state import gather_rows
    if step.sharding == "replicated":
        return _sha(state.params)
    axis = step.mesh.axis(step.shard_axis)
    h = hashlib.sha256()
    for b, shard in enumerate(state.shards):
        full = bucketing.unrotate_shards(gather_rows(shard, axis),
                                         step.n_shards)
        h.update(full[:step.bucket_plan.bucket_sizes[b]].cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _span_ms(spans) -> dict:
    """One traced step's spans (step, forward, backward, update; ms) and
    its in-backward collectives' spans by kind (ar, rs): [count, summed
    ms]. The gathers are left out: zero3's run twice a step, and the
    tracer merges a name's stamps into one span."""
    out = {}
    for sp in spans:
        ms = (sp.t1 - sp.t0) * 1e3
        if sp.cat in ("compute", "step"):
            out[sp.name] = ms
        elif sp.name[:2] in ("ar", "rs"):
            n, total = out.get(sp.name[:2], (0, 0.0))
            out[sp.name[:2]] = (n + 1, total + ms)
    return out


def _family_run(model, mesh, comm, sharding, gather, batch_fn, tokens, say,
                what, *, keep, gate):
    """One configuration of the lm_ring_families phase: LM_FAMILY_STEPS
    steps through loop.train from init_state (seed 0), the first the
    warm-up, under a tracer. Checks the launches (over every step), the
    losses, run_stop and that every rank reads the same masters; prints
    the last step's spans (``_span_ms``), the allocator's retries and its
    peak reserved bytes; ``gate``: the last step's ar spans must begin in
    the order the backward reaches their groups (``_overlap_gate``).
    Returns (row, the masters where ``keep``, the initial params where
    ``keep`` on the replicated rung: None elsewhere)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import CommConfig
    from repro_torch.core import lars
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.trace import Tracer
    from repro_torch.train import loop
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_map

    dev, n = mesh.device, mesh.size
    ring = comm == "ring"
    tracer = Tracer()
    step = make_train_step(
        model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                              use_kernel=True), _lm_sched(), smoothing=0.1,
        mesh=mesh, comm=CommConfig(strategy=comm, sharding=sharding,
                                   gather=gather, use_kernel=ring,
                                   update_kernel=sharding != "replicated",
                                   bucket_mb=4), tracer=tracer)
    plan = step.bucket_plan
    if step.sharding != sharding:
        fail(f"lm_ring_families {what}: sharding {step.sharding!r}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    state = init_state(model, 0, device=dev, **sharded_state_kwargs(step))
    init_s = time.perf_counter() - t
    resident = torch.cuda.memory_allocated(dev)
    p0 = (tree_map(torch.clone, state.params)
          if keep and sharding == "replicated" else None)
    times = []

    def timed_step(s, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(s, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
    sink = obs_metrics.MemorySink()
    _zero(*_counters().values())
    with obs_metrics.default_registry().use_sink(sink):
        state, history = loop.train(state, timed_step, batch_fn,
                                    steps=LM_FAMILY_STEPS, log_every=1,
                                    seed=0, tracer=tracer)
    counts = _read_path(f"lm_ring_families {what}", _lm_ring_want(
        comm, sharding, plan.n_buckets, LM_FAMILY_STEPS))
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries",
                                               0) - retries
    peaks, shas = [None] * n, [None] * n
    dist.all_gather_object(peaks, peak)
    losses = [h["loss"] for h in history]
    if len(losses) != LM_FAMILY_STEPS or not all(math.isfinite(v)
                                                 for v in losses):
        fail(f"lm_ring_families {what}: losses not all finite: {losses}")
    if not sink.find("run_stop"):
        fail(f"lm_ring_families {what}: loop.train did not reach run_stop")
    dist.all_gather_object(shas, _sha_masters(step, state))
    if len(set(shas)) != 1:
        fail(f"lm_ring_families {what}: the ranks read different masters "
             f"(sha256 {shas})")
    med = statistics.median(times[1:])
    row = {"comm": comm, "sharding": sharding, "gather": gather,
           "buckets": plan.n_buckets, "step_ms": [x * 1e3 for x in times],
           "median_ms": med * 1e3, "tokens_per_s": tokens / med,
           "peak_gib": [p / 2 ** 30 for p in peaks],
           "resident_gib": resident / 2 ** 30, "init_s": init_s,
           "peak_reserved_gib": reserved / 2 ** 30, "alloc_retries": retries,
           "launches": counts, "losses": losses, "masters_sha256": shas[0]}
    spans = tracer.steps[-1][1]
    row["spans_ms"] = _span_ms(spans)
    if gate:
        meta = {"tokens": torch.zeros((1, 64), dtype=torch.int32),
                "labels": torch.zeros((1, 64), dtype=torch.int32)}
        row["overlap"] = _overlap_gate(spans, _overlap_order(
            model, plan, meta), f"lm_ring_families {what}", kind="ar")
    say(f"lm_ring_families: {what} ({plan.n_buckets} buckets): losses "
        f"{[round(v, 4) for v in losses]}; step times ms "
        f"{[round(x * 1e3, 2) for x in times]}, median after the first "
        f"{med * 1e3:.2f} ms, {tokens / med:.0f} tokens/s on {n} cards; "
        f"peak memory a rank GiB {[round(p / 2 ** 30, 2) for p in peaks]} "
        f"(resident after init_state {resident / 2 ** 30:.2f} GiB, made in "
        f"{init_s:.1f} s); "
        f"launches K3 {counts['k3']}, K1 {counts['k1']}, K2 {counts['k2']}, "
        f"K4 {counts['k4']} + {counts['k4_bwd']} over {LM_FAMILY_STEPS} "
        f"steps; every rank's masters sha256 {shas[0][:16]}; rank 0's last "
        f"step: " + ", ".join(
            f"{k} {v:.1f} ms" if not isinstance(v, tuple) else
            f"{v[0]} {k} spans {v[1]:.1f} ms" for k, v in
            row["spans_ms"].items())
        + f"; peak reserved {reserved / 2 ** 30:.2f} GiB, {retries} "
          f"allocator retries"
        + ("" if not gate else
           f"; ar spans begin {row['overlap']['first_ms']:.1f} / "
           f"{row['overlap']['median_ms']:.1f} / "
           f"{row['overlap']['last_ms']:.1f} ms (first / median / last) "
           f"into a {row['overlap']['backward_ms']:.1f} ms backward span, "
           f"in the order the backward reaches their groups"))
    masters = loop.make_params_reader(step)(state) if keep else None
    del state
    return row, masters, p0


def lm_ring_families_rank(archs=()):
    """One rank of the lm_ring_families phase (``chip_smoke.py
    --lm-ring-families-rank [ARCH ...]`` under torch.distributed.run, one
    card each): LM_FAMILY_RUNS in order (those of ``archs`` where given),
    the second configuration of a pair held against its psum anchor's
    masters. Rank 0 prints the lines and, last, ``lm-ring-families-json:
    {...}``."""
    import dataclasses

    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.tree import tree_flatten

    mesh = make_local_mesh()
    n, dev = mesh.size, mesh.device
    say = (lambda msg: print(msg, flush=True)) if mesh.rank == 0 else \
        (lambda msg: None)
    rows = []
    for arch, layers, (batch, seq), configs in LM_FAMILY_RUNS:
        if archs and arch not in archs:
            continue
        cfg = get_config(arch)
        depth = cfg.n_layers
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        if not cfg.remat or cfg.flash_attention:
            fail(f"lm_ring_families: {arch} must train with remat and "
                 f"without the flash kernel")
        model = build_model(cfg)
        batch_fn = make_batch_fn(cfg, InputShape("train_4k", "train", seq,
                                                 batch * n), device=dev,
                                 mesh=mesh)
        frames = ("" if cfg.encoder is None else
                  f" + {cfg.encoder.n_frames} stub frames")
        cut = (f"its depth cut to {layers} of {depth} layers"
               if layers is not None else f"all {depth} layers")
        if arch == "zamba2-7b" and layers is None:
            cut += ("; the batch a rank not cut" if batch == 2 else
                    f"; the batch a rank cut from 2 to {batch}")
        say(f"lm_ring_families: {arch} at full width, {cut}; {batch} x "
            f"({seq} tokens{frames}) a rank")
        anchor = None
        for comm, sharding, gather in configs:
            what = (f"{arch} {cfg.n_layers} layers {comm} {sharding}"
                    + (f"/{gather}" if gather else ""))
            row, masters, p0 = _family_run(
                model, mesh, comm, sharding, gather, batch_fn,
                batch * seq * n, say, what, keep=len(configs) > 1,
                gate=arch == "xlstm-125m")
            row.update(arch=arch, layers=[cfg.n_layers, depth],
                       batch=[batch, seq])
            if masters is not None and anchor is None:
                anchor = [(p, x, (x - a).abs().max().item()) for (p, x), (
                    _, a) in zip(tree_flatten(masters), tree_flatten(p0))]
                if min(upd for _, _, upd in anchor) <= 0.0:
                    fail(f"lm_ring_families {what}: the psum anchor left a "
                         f"tensor unchanged")
            elif masters is not None:
                d = max(((p, (x - want).abs().max().item() / max(upd, 1e-30))
                         for (_, x), (p, want, upd) in
                         zip(tree_flatten(masters), anchor)),
                        key=lambda t: t[1])
                row["masters_of_update"] = list(d)
                say(f"lm_ring_families: {what}: masters within {d[1]:.3e} "
                    f"of the largest update of the psum anchor's ({d[0]}; "
                    f"limit {LM_UPDATE_TOL})")
                if not d[1] <= LM_UPDATE_TOL:
                    fail(f"lm_ring_families {what}: masters {d[1]:.3e} of "
                         f"the anchor's largest update off ({d[0]}; limit "
                         f"{LM_UPDATE_TOL})")
            rows.append(row)
            del masters, p0
            torch.cuda.empty_cache()
        del anchor, model
        gc.collect()
        torch.cuda.empty_cache()
    say("lm-ring-families-json: " + json.dumps({"cards": n, "runs": rows}))
    mesh.destroy()


def _family_cli() -> dict:
    """The phase's CLI run: ``python -m torch.distributed.run
    --nproc-per-node 4 -m repro_torch.launch.train`` + LM_FAMILY_CLI,
    which must exit 0 with its run_stop line. Returns its seconds."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           "4", "--master-addr", "127.0.0.1", "--master-port", str(port),
           "-m", "repro_torch.launch.train", *LM_FAMILY_CLI]
    t = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=str(SRC),
                                               OMP_NUM_THREADS="4"))
    secs = time.perf_counter() - t
    if out.returncode != 0 or "run_stop" not in out.stdout:
        print(out.stdout[-1500:], end="", flush=True)
        fail(f"lm_ring_families CLI {' '.join(LM_FAMILY_CLI)} on 4 ranks "
             f"exited {out.returncode}: {out.stderr[-3000:]}")
    stop = [ln for ln in out.stdout.splitlines() if "run_stop" in ln]
    print(f"lm_ring_families: CLI on 4 ranks ({' '.join(LM_FAMILY_CLI)}) "
          f"exited 0 in {secs:.1f} s: {stop[0].strip()}", flush=True)
    return {"args": list(LM_FAMILY_CLI), "seconds": secs}


def run_lm_ring_families(archs=()):
    """The lm_ring_families phase on four cards, one rank each over NCCL
    (``torch.distributed.run`` starts this script with
    ``--lm-ring-families-rank``), then its CLI run; ``archs``, given, runs
    only their configurations and no CLI. None with fewer than four
    cards."""
    import torch
    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    if n < 4:
        print(f"lm_ring_families: not run: {n} card(s); the phase needs 4",
              flush=True)
        return None
    out = _launch_ranks(["--lm-ring-families-rank", *archs], 4,
                        LM_FAMILY_TIMEOUT_S, "the lm_ring_families phase")
    result = None
    for line in out.splitlines():
        if line.startswith("lm-ring-families-json: "):
            result = json.loads(line[len("lm-ring-families-json: "):])
        elif line.startswith("lm_ring_families"):
            print(line, flush=True)
    if result is None:
        fail("the lm_ring_families phase printed no result")
    if not archs:
        result["cli"] = _family_cli()
    return result


def lm_ring_families_main(archs):
    """``python3 chip_smoke.py --lm-ring-families [ARCH ...]``: the card
    check, the build and the lm_ring_families phase alone (on four cards;
    only ``archs``' configurations where given), its JSON last."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import backend
    backend.build()
    result = run_lm_ring_families(archs)
    if result is None:
        sys.exit(1)
    print(json.dumps({"lm_ring_families": result}), flush=True)


def ring_main():
    """``python3 chip_smoke.py --ring``: the card check, the build and the
    four-card ring phases alone (ring and its context, lm_ring and its
    one-card resume), their seconds, and their JSON last."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import backend
    phase("build")
    backend.build()
    phase("ring, ring context")
    ring = run_ring()
    phase("lm_ring")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        lm_ring = run_lm_ring(Path(tmp))
        if ring is None or lm_ring is None:
            sys.exit(1)
        phase("lm_ring resume")
        lm_ring["resume"] = run_lm_resume(backend.resolve_device(None),
                                          Path(tmp), lm_ring)
    phase()
    print(f"phase seconds: {json.dumps(_PHASE_S)}", flush=True)
    print(json.dumps({"ring": ring, "lm_ring": lm_ring}), flush=True)


def run_lm_resume(dev, ckpt_dir, lm_ring):
    """The four-card ring zero1 LM's checkpoint resumed on this one card
    (``elastic.load_resharded``, 4 -> 1 shards over the LM's split-leaf
    plan): the masters bit-equal to the four ranks' gathered rows (sha256
    against rank 0's), then one step with a finite loss (K1, K2, K4)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import lars
    from repro_torch.data.synthetic import make_batch_fn
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint, elastic
    from repro_torch.train.loop import make_params_reader
    from repro_torch.train.state import init_state, sharded_state_kwargs
    from repro_torch.train.step import make_train_step

    want = next(r for r in lm_ring["runs"] if r["sharding"] == "zero1")
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    saved = checkpoint.load_comm_plan(str(ckpt_dir), tag=LM_CKPT_TAG)
    if saved.n_shards != 4 or saved.sharding != "zero1":
        fail(f"lm_ring resume: the saved plan has {saved.n_shards} shards, "
             f"sharding {saved.sharding!r}")
    mesh = make_local_mesh()
    try:
        step = make_train_step(
            model, lars.OptConfig(kind="lars", weight_decay=5e-5,
                                  use_kernel=True), _lm_sched(),
            smoothing=0.1, mesh=mesh,
            comm=saved.comm_config(reautotune=True))
        template = init_state(model, 0, device=dev,
                              **sharded_state_kwargs(step))
        t = time.perf_counter()
        state = elastic.load_resharded(str(ckpt_dir), template,
                                       step.bucket_plan, 1, tag=LM_CKPT_TAG,
                                       old_comm_plan=saved, mesh=mesh)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t) * 1e3
        del template
        sha = _sha(make_params_reader(step)(state))
        if sha != want["masters_sha256"]:
            fail("lm_ring resume: the masters resumed on one card are not "
                 "bit-equal to the four ranks' gathered rows")
        batch = make_batch_fn(cfg, InputShape("train_4k", "train", LM_SEQ,
                                              LM_BATCH), device=dev)(
            state.step)
        _zero(*_counters().values())
        state, m = step(state, batch)
        torch.cuda.synchronize()
        counts = _read_path("lm_ring resume", {"k1": 1, "k2": 1, "k4": 1,
                                               "k4_bwd": 1})
        loss = float(m["loss"])
        if not math.isfinite(loss) or state.step != LM_RING_STEPS + 1:
            fail(f"lm_ring resume: step {state.step}, loss {loss}")
    finally:
        mesh.destroy()
    print(f"lm_ring resume: the ring zero1 checkpoint ({saved.n_shards} "
          f"shards, {len(saved.bucket_sizes)} buckets, saved in "
          f"{want['save_ms']:.0f} ms) resumed on one card (1 shard) in "
          f"{load_ms:.0f} ms: masters bit-equal to the gathered rows "
          f"(sha256); then step {state.step} on one card, loss {loss:.4f}",
          flush=True)
    return {"load_ms": load_ms, "loss": loss, "launches": counts}


def _serve_cache(cfg, batch, new=SERVE_NEW) -> int:
    """The serving cache's rows: the prompt, the VLM's image prefix, the
    new tokens and 8 more."""
    from repro_torch.serve.decode import prefix_len
    return batch["tokens"].shape[1] + prefix_len(cfg) + new + 8


def _prompt_pos(cfg, batch) -> int:
    """The first new token's position (the VLM's counts its prefix)."""
    from repro_torch.serve.decode import prefix_len
    return batch["tokens"].shape[1] + prefix_len(cfg)


def run_serve(dev, name="serve", cfg=None, k5=None,
              sizes=(SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)):
    """A full-width LM (qwen1.5-0.5b unless ``cfg``) served through
    serve.decode.generate with the flash kernel in the prefill, as
    examples/serve_decode.py drives the JAX package (at full width here),
    on bf16 weights made leaf by leaf from pinit, as the serving CLI holds
    them: ``sizes`` (requests, prompt tokens, new tokens), whisper's and
    the VLM's requests with their stub frames. K5 must launch ``k5`` times
    (by default once a layer), in the prefill, and no other kernel."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import pinit
    from repro_torch.data.synthetic import stub_frames
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import generate
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(cfg or get_config("qwen1.5-0.5b"),
                              flash_attention=True)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    params = pinit.materialize(model.param_pd, seed=0, device=dev,
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(x.numel() for x in tree_leaves(params))
    n_req, n_prompt, n_new = sizes
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (n_req, n_prompt),
                           generator=gen, dtype=torch.int32).to(dev)
    batch = {"tokens": tokens}
    if cfg.encoder is not None:
        batch["frames"] = stub_frames(cfg, batch=n_req, step=0, device=dev)
    cache_len = _serve_cache(cfg, batch, n_new)
    # warm-up (cuBLAS handles, first launches); not timed, not counted
    generate(model, params, batch, max_new=2, cache_len=cache_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    _zero(*_counters().values())
    out = generate(model, params, batch, max_new=n_new,
                   cache_len=cache_len, timings=timings)
    torch.cuda.synchronize()
    # K5 once a layer (or as the caller says), in the prefill; no other
    # kernel
    counts = _read_path(name, {"k5": cfg.n_layers if k5 is None else k5})
    launches = counts["k5"]
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(out.shape) != (n_req, n_new):
        fail(f"{name}: generated shape {tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"{name}: a token outside the vocabulary")
    dec = timings["decode_ms"]
    q1, med, q3 = statistics.quantiles(dec, n=4)
    frames = (f" + {cfg.encoder.n_frames} stub frames"
              if cfg.encoder is not None else "")
    print(f"{name}: {cfg.arch_id}, {cfg.n_layers} layers, "
          f"{n_params / 1e6:.1f} M params (bf16), pinit {init_s:.2f} s; "
          f"{n_req} requests of {n_prompt} tokens{frames}, {n_new} new, "
          f"cache {cache_len} rows; prefill {timings['prefill_ms']:.2f} ms "
          f"({n_req * n_prompt / timings['prefill_ms'] * 1e3:.0f}"
          f" prompt tokens/s); decode ms a token median {med:.3f} "
          f"(p25 {q1:.3f}, p75 {q3:.3f}, {len(dec)} steps), "
          f"{n_req * 1e3 / med:.1f} tokens/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB; flash_attention launches {launches}",
          flush=True)
    print(f"{name}: first request's tokens {out[0].tolist()}", flush=True)
    result = {"arch": cfg.arch_id, "layers": cfg.n_layers,
              "params": n_params, "pinit_s": init_s,
              "prefill_ms": timings["prefill_ms"],
              "decode_ms": {"p25": q1, "median": med, "p75": q3},
              "tokens_per_s": n_req * 1e3 / med,
              "peak_gib": peak / 2 ** 30, "sizes": list(sizes),
              "cache_len": cache_len}
    return model, params, batch, out, counts, result


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@contextlib.contextmanager
def _moe_chunked(data: int = 1, model: int = 1):
    """Within: the MoE layer as ``moe.moe_apply_chunked`` at (data,
    model), the mesh's answer on one card (the transformer calls
    ``moe.moe_apply`` by name; the stand-in takes ``tp`` and ignores
    it)."""
    from repro_torch.models import moe
    real = moe.moe_apply

    def chunked(p, x, cfg, *, decode, tp=None):
        return moe.moe_apply_chunked(p, x, cfg, decode=decode, data=data,
                                     model=model)
    moe.moe_apply = chunked
    try:
        yield
    finally:
        moe.moe_apply = real


class _RoutingPin:
    """Pins a MoE model's expert choices across two runs: ``record()``
    keeps each MoE layer's top-k ids, ``replay(ids)`` makes each layer
    take the given ids in place of its own top-k (the gates are still its
    own probabilities at those ids), and counts the token-layers whose own
    choice differs, with the largest gap between its own top-k
    probabilities and those at the pinned ids. Two bf16 paths (K5 and the
    chunked attention) round apart by ~1e-2, and among 60 experts many a
    token's 4th and 5th probabilities lie closer than that, so unpinned
    the paths pick other experts for some tokens, and with capacity other
    tokens are dropped: the pin holds the rest of the two paths against
    each other."""

    def __init__(self):
        self.ids, self.flips, self.choices, self.gap = [], 0, 0, 0.0
        self._replay = None

    def hold(self, name: str):
        """Fails unless the replayed choices parted from the run's own
        only at near-ties: by at most ROUTE_GAP_TOL in probability, in at
        most ROUTE_FLIP_SHARE of the token-layers."""
        if not (self.choices and self.gap <= ROUTE_GAP_TOL
                and self.flips <= ROUTE_FLIP_SHARE * self.choices):
            fail(f"{name}: the pinned expert choices part from the one "
                 f"card's own in {self.flips} of {self.choices} "
                 f"token-layers, by up to {self.gap:.3e} in probability "
                 f"(limits {ROUTE_FLIP_SHARE} of them and {ROUTE_GAP_TOL})")

    def record(self):
        return self._patch(None)

    def replay(self, ids):
        return self._patch(list(ids))

    def _patch(self, replay):
        import contextlib

        from repro_torch.models import moe
        real = moe._top_k

        def top_k(x, k):
            vals, ids = real(x, k)
            if self._replay is None:
                self.ids.append(ids)
                return vals, ids
            want = self._replay.pop(0)
            got = x.gather(-1, want)
            self.flips += int((ids.sort(-1).values
                               != want.sort(-1).values).any(-1).sum())
            self.choices += ids.shape[0]
            self.gap = max(self.gap, float((vals - got.sort(
                -1, descending=True).values).abs().max()))
            return got, want

        @contextlib.contextmanager
        def patched():
            self._replay = replay
            moe._top_k = top_k
            try:
                yield self
            finally:
                moe._top_k = real
            if replay is not None and self._replay:
                fail("routing pin: layers left unreplayed")
        return patched()


def _least_cf(e, ids, B: int, S: int) -> float:
    """The least capacity factor at which a prefill of B x S tokens making
    the choices ``ids`` (each MoE layer's (B·S, k) expert ids) drops none,
    nor a full forward over one token more a request (each may pick the
    fullest expert): its count over the prefill, and that plus B."""
    import dataclasses

    import torch
    from repro_torch.models.moe import capacity
    most = max(int(torch.bincount(i.reshape(-1), minlength=e.n_routed).max())
               for i in ids)
    per = e.top_k / e.n_routed
    cf = max(most / (B * S * per), (most + B) / (B * (S + 1) * per))

    def fits(cf):
        c = dataclasses.replace(e, capacity_factor=cf)
        return capacity(B * S, c) >= most and \
            capacity(B * (S + 1), c) >= most + B
    while not fits(cf):               # past the ceiling's float rounding
        cf = math.nextafter(cf, math.inf)
    return cf


def check_serve_in_context(dev, model, params, batch, out, name="serve",
                           decode_cf=SERVE_MOE_CF, tol=SERVE_TOL):
    """The K5 prefill against the chunked one (no kernel), and one decode
    step from a K5 prefill's cache against the chunked full forward. A MoE
    model's decode check runs at ``decode_cf`` (prefill and full forward),
    by default ``SERVE_MOE_CF``, as tests/test_serve.py does: the full
    forward drops tokens over capacity, decode never does; None takes the
    least factor at which neither drops a choice (``_least_cf``, from the
    K5 prefill's recorded choices, then from those of the prefill at that
    factor until they need no more). A MoE model's chunked runs take the
    K5 runs' expert choices (``_RoutingPin``); their differences unpinned
    and the choices that differ are printed beside the gates."""
    import contextlib
    import dataclasses

    import torch
    from repro_torch.core.precision import cast_to_compute
    from repro_torch.models.registry import build_model

    cfg = model.cfg
    moe = cfg.moe is not None
    plain = build_model(dataclasses.replace(cfg, flash_attention=False))
    p16 = cast_to_compute(params)
    cache_len, pos = _serve_cache(cfg, batch), _prompt_pos(cfg, batch)
    pin = _RoutingPin()
    with pin.record() if moe else contextlib.nullcontext():
        k5_last, cache = model.forward_prefill(p16, batch, cache_len)
    if not bool(torch.isfinite(k5_last).all()):
        fail(f"{name} context: non-finite prefill logits")
    if not torch.equal(k5_last[:, -1].argmax(-1).int(), out[:, 0]):
        fail(f"{name} context: the prefill's argmax is not generate's "
             f"first token")
    free = {}
    if moe:
        ch_last, _ = plain.forward_prefill(p16, batch, cache_len)
        free["prefill"] = _rel(k5_last, ch_last)
        del ch_last, cache
        replay = _RoutingPin()
        with replay.replay(pin.ids):
            ch_last, _ = plain.forward_prefill(p16, batch, cache_len)
        # the decode check's model: no token over capacity
        B, S = batch["tokens"].shape
        least = decode_cf is None
        if least:
            decode_cf = _least_cf(cfg.moe, pin.ids, B, S)
        for _ in range(3):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=decode_cf))
            model = build_model(cfg)
            pin = _RoutingPin()
            with pin.record():
                _, cache = model.forward_prefill(p16, batch, cache_len)
            need = _least_cf(cfg.moe, pin.ids, B, S)
            if not least or need <= decode_cf:
                break
            del cache
            decode_cf = need
        else:
            fail(f"{name} context: the least capacity factor did not "
                 f"settle ({decode_cf:.4f}, then {need:.4f})")
        plain = build_model(dataclasses.replace(cfg, flash_attention=False))
    else:
        ch_last, _ = plain.forward_prefill(p16, batch, cache_len)
    d_prefill = _rel(k5_last, ch_last)
    del ch_last
    tok = out[:, :1]
    n_prefill = len(pin.ids)
    with pin.record() if moe else contextlib.nullcontext():
        dl, _ = model.forward_decode(p16, cache, tok, pos)
    del cache
    if not bool(torch.isfinite(dl).all()):
        fail(f"{name} context: non-finite decode logits")
    full_batch = dict(batch, tokens=torch.cat([batch["tokens"], tok], dim=1))
    if moe:
        (full, _), _ = plain.forward_train(p16, full_batch)
        free["decode"] = _rel(dl[:, 0], full[:, -1])
        del full
        B, k = tok.shape[0], cfg.moe.top_k
        # each layer's choices over prompt + token, request-major
        ids = [torch.cat([a.view(B, -1, k), b.view(B, 1, k)], 1)
               .reshape(-1, k) for a, b in zip(pin.ids[:n_prefill],
                                               pin.ids[n_prefill:])]
        decode_replay = _RoutingPin()
        with decode_replay.replay(ids):
            (full, _), _ = plain.forward_train(p16, full_batch)
    else:
        (full, _), _ = plain.forward_train(p16, full_batch)
    d_decode = _rel(dl[:, 0], full[:, -1])
    del full
    pinned = ""
    if moe:
        pinned = (f"; the chunked runs take the K5 runs' expert choices: "
                  f"unpinned they differ by {free['prefill']:.3e} and "
                  f"{free['decode']:.3e}, their own top-{cfg.moe.top_k} "
                  f"differs in {replay.flips} of {replay.choices} and "
                  f"{decode_replay.flips} of {decode_replay.choices} "
                  f"token-layers, by at most "
                  f"{max(replay.gap, decode_replay.gap):.3e} in probability")
    cf = f" (capacity_factor {decode_cf:.4f})" if moe else ""
    print(f"{name} context: K5 prefill vs chunked prefill, last logits "
          f"differ by {d_prefill:.3e} of their max (limit {tol}); "
          f"decode step vs chunked full forward{cf} {d_decode:.3e} (limit "
          f"{tol}); {batch['tokens'].shape[0]} requests{pinned}",
          flush=True)
    if not d_prefill <= tol:
        fail(f"{name}: the K5 prefill disagrees with the chunked prefill")
    if not d_decode < tol:
        fail(f"{name}: the decode step disagrees with the full forward")
    result = {"prefill_vs_chunked": d_prefill, "decode_vs_full": d_decode}
    if moe:
        result.update(unpinned=free, flips=[replay.flips, decode_replay.flips],
                      choices=[replay.choices, decode_replay.choices],
                      max_gap=max(replay.gap, decode_replay.gap),
                      decode_capacity_factor=decode_cf)
    return result


def run_serve_moe(dev):
    """qwen2-moe-a2.7b at full width and full depth (15.15 B params) served
    as the serve phase serves qwen1.5-0.5b, then its context checks."""
    from repro_torch.configs import get_config
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_moe", get_config("qwen2-moe-a2.7b"))
    phase("serve_moe context")
    result["context"] = check_serve_in_context(dev, model, params, batch,
                                               out, "serve_moe")
    return counts, result


def _cut_depth(name, arch, layers):
    """``arch``'s config at full width with its depth cut to ``layers``
    (printed), and its own depth."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    print(f"{name}: {arch}'s depth cut to {layers} of its {cfg.n_layers} "
          f"layers (full width)" if layers < cfg.n_layers else
          f"{name}: {arch} at full width and all of its {cfg.n_layers} "
          f"layers", flush=True)
    return dataclasses.replace(cfg, n_layers=layers), cfg.n_layers


def run_serve_nemo(dev):
    """mistral-nemo-12b at full width and depth (40 layers, 32 query heads
    on 8 kv heads of 128; its 131,072-token sliding window, wider than the
    prompt, takes K5's window path) served as serve_qk is, then checked in
    context."""
    from repro_torch.configs import get_config
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_nemo", get_config("mistral-nemo-12b"))
    phase("serve_nemo context")
    result["context"] = check_serve_in_context(dev, model, params, batch,
                                               out, "serve_nemo")
    return counts, result


def run_serve_qk(dev):
    """qwen3-14b at full width (qk_norm, 40 query heads on 8 kv heads) and
    depth (``QK_LAYERS``), served and checked in context."""
    cfg, depth = _cut_depth("serve_qk", "qwen3-14b", QK_LAYERS)
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_qk", cfg)
    result["context"] = check_serve_in_context(dev, model, params, batch,
                                               out, "serve_qk")
    result["depth_cut"] = [QK_LAYERS, depth]
    return counts, result


def run_serve_mla(dev):
    """deepseek-v2-236b at full width, its depth cut to ``MLA_LAYERS``
    layers, served (K5 at Dk 192 / Dv 128 on 128 heads in the prefill, the
    absorbed decode against the latent cache) and checked in context, the
    decode check at the least capacity factor that drops no choice."""
    from repro_torch.tree import tree_leaves
    cfg, depth = _cut_depth("serve_mla", "deepseek-v2-236b", MLA_LAYERS)
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_mla", cfg)
    m = cfg.mla
    latent = sum(2 * math.prod(pd.shape) for pd in tree_leaves(
        model.cache_pd(SERVE_BATCH, SERVE_CACHE)))
    gqa = 2 * 2 * MLA_LAYERS * SERVE_BATCH * SERVE_CACHE * cfg.n_heads \
        * m.v_head_dim
    print(f"serve_mla: latent cache {latent / 1e6:.2f} MB ({MLA_LAYERS} x "
          f"{SERVE_BATCH} x {SERVE_CACHE} rows of {m.kv_lora_rank} + "
          f"{m.rope_head_dim} bf16), where k and v of {cfg.n_heads} heads "
          f"of {m.v_head_dim} would hold {gqa / 1e9:.2f} GB "
          f"({gqa / latent:.1f}x)", flush=True)
    result.update(depth_cut=[MLA_LAYERS, depth], cache_bytes=latent,
                  gqa_cache_bytes=gqa)
    phase("serve_mla context")
    result["context"] = check_serve_in_context(
        dev, model, params, batch, out, "serve_mla", decode_cf=None)
    return counts, result


def _cache_bytes(tree) -> int:
    """Bytes of a descriptor tree's leaves."""
    from repro_torch.tree import tree_leaves
    return sum(math.prod(pd.shape) * pd.dtype.itemsize
               for pd in tree_leaves(tree))


def run_serve_hybrid(dev):
    """zamba2-7b at full width and full depth (81 Mamba2 layers, the shared
    block applied before each group of 6: 14 times) served as the serve
    phase serves qwen1.5-0.5b: K5 once for each application in the
    prefill, at 32 heads of 112; then its context checks (the recurrent
    decode from the SSD prefill's states against the parallel full
    forward)."""
    from repro_torch.configs import get_config, param_count
    cfg = get_config("zamba2-7b")
    groups = -(-cfg.n_layers // cfg.attn_every)
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_hybrid", cfg, k5=groups)
    pd = model.cache_pd(SERVE_BATCH, SERVE_CACHE)
    attn_b, state_b = _cache_bytes(pd["attn"]), _cache_bytes(
        pd["mamba"]["state"])
    conv_b = _cache_bytes(pd["mamba"]) - state_b
    print(f"serve_hybrid: {result['params'] / 1e9:.3f} B params in the "
          f"tree, {param_count(cfg) / 1e9:.2f} B by configs.param_count "
          f"(the reference's accounting: B and C counted once a head); "
          f"cache: the shared block's k and v {attn_b / 1e9:.2f} GB "
          f"({groups} applications x {SERVE_BATCH} x {SERVE_CACHE} rows of "
          f"{cfg.n_kv_heads} x {cfg.resolved_head_dim}, bf16), the Mamba "
          f"states {state_b / 1e9:.3f} GB (f32) and conv windows "
          f"{conv_b / 1e6:.1f} MB", flush=True)
    result.update(groups=groups, param_count=param_count(cfg),
                  attn_cache_bytes=attn_b, state_bytes=state_b,
                  conv_bytes=conv_b)
    phase("serve_hybrid context")
    result["context"] = check_serve_in_context(
        dev, model, params, batch, out, "serve_hybrid", tol=HYBRID_SERVE_TOL)
    result["context_f32"] = check_serve_f32(model, params, batch, out,
                                            "serve_hybrid", k5=groups)
    return counts, result


def check_serve_f32(model, params, batch, out, name, k5):
    """The serve context checks in f32, on the first SERVE_F32_REQUESTS
    requests: the served bf16 params cast up, the LM wholly in f32
    (``precision.f32_compute``), every matmul in f32; K5's f32 route
    in the prefill, which must launch ``k5`` times, against the chunked
    prefill, and one decode step from the K5 cache, on generate's first
    token, against the chunked full forward. Both within SERVE_F32_TOL of
    the logits' max: the two sides differ by the order of f32 sums, which
    depth does not grow as it grows bf16 roundings. This is the path's
    correctness gate; the bf16 context's HYBRID_SERVE_TOL is a sanity
    bound."""
    import dataclasses

    import torch
    from repro_torch.core import precision
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map

    cfg = model.cfg
    plain = dataclasses.replace(cfg, flash_attention=False)
    p32 = tree_map(lambda t: t.float(), params)
    sub = {k: v[:SERVE_F32_REQUESTS] for k, v in batch.items()}
    toks = sub["tokens"]
    tok = out[:SERVE_F32_REQUESTS, :1]
    cache_len, pos = _serve_cache(cfg, sub), _prompt_pos(cfg, sub)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = fa.flash_attention.launches
    with torch.no_grad(), precision.f32_compute():
        k5_last, cache = tf.forward_prefill(p32, cfg, sub, cache_len)
        launched = fa.flash_attention.launches - before
        ch_last, _ = tf.forward_prefill(p32, plain, sub, cache_len)
        dl, _ = tf.forward_decode(p32, cfg, cache, tok, pos)
        full, _ = tf.forward_train(p32, plain, dict(sub, tokens=torch.cat(
            [toks, tok], dim=1)))
    d_prefill, d_decode = _rel(k5_last, ch_last), _rel(dl[:, 0], full[:, -1])
    del p32, cache, full
    print(f"{name} context f32: K5 (f32 route, {launched} launches) prefill "
          f"vs chunked prefill {d_prefill:.3e}, decode step vs chunked full "
          f"forward {d_decode:.3e} of the logits' max (limit "
          f"{SERVE_F32_TOL}); {toks.shape[0]} requests", flush=True)
    if launched != k5:
        fail(f"{name}: the f32 prefill launched K5 {launched} times, not "
             f"{k5}: the check would compare the chunked path with itself")
    if not (d_prefill <= SERVE_F32_TOL and d_decode <= SERVE_F32_TOL):
        fail(f"{name}: the f32 serve checks disagree")
    return {"prefill_vs_chunked": d_prefill, "decode_vs_full": d_decode,
            "requests": toks.shape[0], "k5_launches": launched}


def run_serve_xlstm(dev):
    """xlstm-125m at full width and depth (11 mLSTM layers and the sLSTM
    layer 6) served as the serve phase serves qwen1.5-0.5b: no attention,
    so no kernel (K5 0); then its context checks (its prefill twice, and
    the recurrent decode against the parallel full forward)."""
    from repro_torch.configs import get_config
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_xlstm", get_config("xlstm-125m"), k5=0)
    state_b = _cache_bytes(model.cache_pd(SERVE_BATCH, SERVE_CACHE))
    print(f"serve_xlstm: cache {state_b / 1e6:.1f} MB of f32 recurrent "
          f"states, whatever the context length", flush=True)
    result["state_bytes"] = state_b
    phase("serve_xlstm context")
    result["context"] = check_serve_in_context(dev, model, params, batch,
                                               out, "serve_xlstm")
    return counts, result


def run_serve_audio(dev):
    """whisper-base at full width and depth (6 encoder layers over 1,500
    stub frames, 6 decoder layers with cross-attention; 8 heads of 64)
    served at AUDIO_SERVE's sizes: K5 18 times a prefill (each encoder
    layer's self-attention, non-causal 1,500 x 1,500; each decoder layer's
    causal self-attention and its cross-attention, 128 queries over the
    1,500 encoder states), nothing else; then its context checks."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-base")
    k5 = cfg.encoder.n_layers + 2 * cfg.n_layers
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_audio", cfg, k5=k5, sizes=AUDIO_SERVE)
    pd = model.cache_pd(AUDIO_SERVE[0], result["cache_len"])
    self_b, cross_b = _cache_bytes(pd["self"]), _cache_bytes(pd["cross"])
    print(f"serve_audio: cache: self k and v {self_b / 1e6:.1f} MB "
          f"({cfg.n_layers} layers x {AUDIO_SERVE[0]} x "
          f"{result['cache_len']} rows), cross k and v {cross_b / 1e6:.1f} "
          f"MB ({cfg.encoder.n_frames} encoder rows, bf16)", flush=True)
    result.update(self_cache_bytes=self_b, cross_cache_bytes=cross_b)
    phase("serve_audio context")
    result["context"] = check_serve_in_context(dev, model, params, batch,
                                               out, "serve_audio")
    return counts, result


def run_serve_vlm(dev):
    """internvl2-2b at full width and depth (24 layers, 16 query heads on 8
    kv heads of 128; 256 stub patch embeddings through the stub projector
    ahead of each prompt) served at VLM_SERVE's sizes: K5 24 times a
    prefill (causal over 2,048 positions), nothing else; then its context
    checks."""
    from repro_torch.configs import get_config
    model, params, batch, out, counts, result = run_serve(
        dev, "serve_vlm", get_config("internvl2-2b"), sizes=VLM_SERVE)
    result["cache_bytes"] = _cache_bytes(model.cache_pd(
        VLM_SERVE[0], result["cache_len"]))
    print(f"serve_vlm: cache {result['cache_bytes'] / 1e6:.1f} MB (the "
          f"image prefix's rows first)", flush=True)
    phase("serve_vlm context")
    result["context"] = check_serve_in_context(dev, model, params, batch,
                                               out, "serve_vlm")
    return counts, result


def run_serve_cli():
    """Each of ``SERVE_CLI`` through python -m repro_torch.serve.decode
    --reduced on the card, all started together."""
    runs = []
    for arch, flags in SERVE_CLI:
        cmd = [sys.executable, "-m", "repro_torch.serve.decode", "--arch",
               arch, "--reduced", *flags]
        runs.append((arch, subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(SRC)))))
    for arch, proc in runs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for _, p in runs:
                p.kill()
            fail(f"serve CLI ({arch}) did not finish in 600 s")
        print(stdout[-1500:], end="", flush=True)
        if proc.returncode != 0 or "generated (4, 16) tokens" not in stdout:
            for _, p in runs:
                p.kill()
            fail(f"serve CLI ({arch}) exited {proc.returncode}: "
                 f"{stderr[-3000:]}")


def _cli(extra, rc=0):
    """``python -m repro_torch.launch.train --reduced`` + ``extra`` on the
    card; fails unless it exits with ``rc`` (a signal: negative)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           *extra]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(SRC)))
    print(out.stdout[-1500:], end="", flush=True)
    if out.returncode != rc or (rc == 0 and "run_stop" not in out.stdout):
        fail(f"CLI {extra} exited {out.returncode} (want {rc}): "
             f"{out.stderr[-3000:]}")
    return out.stdout


def run_cli():
    resnet = ["--arch", "resnet50", "--steps", "2", "--batch", "8"]
    lm = ["--arch", "qwen1.5-0.5b", "--seq", "128", "--batch", "8",
          "--steps", "3"]
    for extra in (resnet, resnet + ["--comm", "ring", "--sharding", "zero1",
                                    "--update-kernel"], lm):
        _cli(extra)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        run_cli_faults(Path(tmp))


def run_cli_faults(tmp: Path):
    """The CLI's durability flags on the reduced ZeRO-1 run: a SIGKILL and
    the resume from the last committed tag, a SIGTERM drain, a stall that
    the watchdog restores, and a corrupted checkpoint that the load falls
    back from, with the metrics JSONL and the Chrome trace."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.train import checkpoint as ckpt
    run = ["--arch", "resnet50", "--batch", "8", "--comm", "psum",
           "--sharding", "zero1", "--update-kernel", "--ckpt-every", "1"]
    d = str(tmp / "kill")
    _cli(run + ["--steps", "5", "--ckpt-dir", d, "--inject-fault", "kill@3"],
         rc=-9)
    if ckpt.latest_tag(d) != ckpt.step_tag(3):
        fail(f"cli kill@3: last committed tag {ckpt.latest_tag(d)}")
    out = _cli(run + ["--steps", "5", "--ckpt-dir", d, "--resume-elastic"])
    if "elastic resume: restored step 3" not in out:
        fail("cli kill@3: the rerun did not resume from step 3")
    d = str(tmp / "sigterm")
    out = _cli(run + ["--steps", "6", "--ckpt-dir", d,
                      "--inject-fault", "sigterm@3"])
    saves = [ln for ln in out.splitlines() if "checkpoint_saved" in ln]
    if "preempt_drain" not in out or "'preempted': True" not in out or \
            sum("'step': 4," in ln for ln in saves) != 1:
        fail("cli sigterm@3: no drain, or step 4 not saved exactly once")
    out = _cli(run + ["--steps", "4", "--ckpt-dir", str(tmp / "stall"),
                      "--inject-fault", "stall@2:3", "--step-timeout-s", "1"])
    if "watchdog_restore" not in out:
        fail("cli stall@2:3: no watchdog_restore")
    d, jl, tr = (str(tmp / "corrupt"), str(tmp / "m.jsonl"),
                 str(tmp / "t.json"))
    out = _cli(run + ["--steps", "2", "--ckpt-dir", d, "--inject-fault",
                      "corrupt@2", "--metrics", jl, "--trace", tr])
    mem = obs_metrics.MemorySink()
    with obs_metrics.default_registry().use_sink(mem):
        meta = ckpt.load_arrays(d)[0]
    if meta["step"] != 1 or [e.value["rejected_tag"] for e in
                             mem.find("checkpoint_fallback")] != [
                                 ckpt.step_tag(2)]:
        fail(f"cli corrupt@2: the load gave step {meta['step']}")
    tags = [ln.split(") ", 1)[1].split(":", 1)[0] for ln in out.splitlines()
            if ln.startswith(":::MLPv0.5.0 ")]
    with open(jl) as f:
        rows = [json.loads(ln)["name"] for ln in f]
    if tags != rows:
        fail(f"cli --metrics: JSONL names {rows} != stdout tags {tags}")
    spans = obs_trace.spans_from_chrome(obs_trace.load_chrome(tr))
    print(f"cli faults: kill@3 -> SIGKILL, resumed from step 3; sigterm@3 "
          f"drained and saved once; stall@2:3 restored by the watchdog; "
          f"corrupt@2 fell back to step 1; {len(rows)} tag lines in the "
          f"JSONL; {len(spans)} spans in a valid Chrome trace", flush=True)


#: the examples phase: each twin of ``examples/*.py`` as a subprocess on
#: the card (``chip_smoke.py --example NAME ARGS``: the module run as
#: ``__main__`` with every kernel's count set to 0 first), all started
#: together; (name, arguments, the final line's start)
EXAMPLES = (("train_resnet_imagenet", ("--steps", "8"),
             "final eval accuracy: "),
            ("quickstart", (), "loss "),
            ("serve_decode", (), "first request's tokens: ["),
            ("large_batch_ablation", ("--steps", "4"), "   256 "))
EXAMPLES_TIMEOUT_S = 300
#: K4's launches on the examples' path: one forward and one backward a
#: quickstart step (its loss; no other twin runs K4 or any other kernel)
QUICKSTART_STEPS = 60


def example_main(name, args):
    """One twin run as ``python -m repro_torch.examples.<name>`` would run
    it, every kernel's count set to 0 just before; prints the counts last
    (``example-launches: {...}``)."""
    import runpy
    sys.path.insert(0, str(SRC))
    counters = _counters()
    _zero(*counters.values())
    sys.argv = [f"repro_torch.examples.{name}", *args]
    runpy.run_module(f"repro_torch.examples.{name}", run_name="__main__",
                     alter_sys=True)
    print("example-launches: " + json.dumps(
        {key: w.launches for key, w in counters.items()}), flush=True)


def run_examples():
    """The examples phase: the four twins at once, each in its own process
    on the card. Each must exit 0 with finite losses and its final line;
    their launches are summed (K4: one forward and one backward a
    quickstart step; every other kernel 0)."""
    procs = {}
    t0 = time.time()
    for name, args, _ in EXAMPLES:
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--example", name,
             *args], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(SRC)))
    outs = {}
    try:
        for name, p in procs.items():
            left = max(EXAMPLES_TIMEOUT_S - (time.time() - t0), 1)
            outs[name] = p.communicate(timeout=left) + (p.returncode,)
    except subprocess.TimeoutExpired:
        fail(f"examples: {name} ran past {EXAMPLES_TIMEOUT_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    total = {key: 0 for key in _counters()}
    for name, args, final in EXAMPLES:
        out, err, rc = outs[name]
        lines = out.strip().splitlines()
        if rc != 0 or not lines or not lines[-1].startswith(
                "example-launches: "):
            fail(f"examples: {name} {list(args)} exited {rc}: {err[-3000:]}")
        counts = json.loads(lines[-1][len("example-launches: "):])
        body = [ln for ln in lines[:-1] if ln.strip()]
        last = body[-1] if body else ""
        if name == "large_batch_ablation":
            rows = [ln for ln in body if ln.split()[:1] in (
                ["16"], ["64"], ["256"])]
            losses = [float(ln.split()[-1]) for ln in rows]
            ok = len(rows) == 6
        elif name == "serve_decode":
            losses = []
            ok = any("generated (4, 16) tokens" in ln for ln in body)
        else:
            losses = [float(ln.split("'loss': ")[1].split(",")[0])
                      for ln in body if "train_step:" in ln]
            if name == "quickstart":       # "loss 6.295 -> 2.562 (...)"
                losses += [float(x) for x in
                           last.split("(")[0].split()[1::2]]
            ok = bool(losses)
        if not (ok and last.startswith(final) and all(
                math.isfinite(v) for v in losses)):
            fail(f"examples: {name}: final line {last!r} (want "
                 f"{final!r}...), losses {losses}")
        print(f"examples: {name} {' '.join(args)}: {last.strip()}; "
              f"{len(losses)} losses, all finite; launches {counts}",
              flush=True)
        for key in total:
            total[key] += counts[key]
    print(f"examples: the four twins in {time.time() - t0:.1f} s",
          flush=True)
    return _check_counts("examples", total, {
        "k4": QUICKSTART_STEPS, "k4_bwd": QUICKSTART_STEPS})


#: the report phase's sections, with the card's constants (launch/hw.H100)
REPORT_SECTIONS = ("comm", "autotune", "shard")


def run_report():
    """The report phase: ``python -m repro_torch.launch.report`` for the
    comm, autotune and shard sections (the H100's constants named in each
    heading) and for the trace section over the durability phase's Chrome
    trace, whose ``rs[b*]`` rows must start inside their step's
    ``backward`` row. All four processes start together."""
    trace = _RESULTS.get("durability_trace")
    if trace is None:
        fail("report: the durability phase left no trace")
    jobs = {sec: ["--section", sec] for sec in REPORT_SECTIONS}
    jobs["trace"] = ["--section", "trace", "--trace-json", str(trace)]
    procs = {sec: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.report", *a], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC))) for sec, a in jobs.items()}
    outs = {}
    for sec, p in procs.items():
        try:
            outs[sec] = p.communicate(timeout=300) + (p.returncode,)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            fail(f"report: --section {sec} ran past 300 s")
    from repro_torch.launch import hw
    for sec in REPORT_SECTIONS:
        out, err, rc = outs[sec]
        head = out.strip().splitlines()[0] if out.strip() else ""
        rows = [ln for ln in out.splitlines() if ln.startswith("| 16x16")
                or ln.startswith("| 2x16x16")]
        if rc != 0 or hw.H100.name not in head or not rows:
            fail(f"report --section {sec} exited {rc}, heading {head!r}, "
                 f"{len(rows)} rows: {err[-2000:]}")
        print(f"report {sec}: {len(rows)} rows; {head}", flush=True)
    out, err, rc = outs["trace"]
    if rc != 0:
        fail(f"report --section trace exited {rc}: {err[-2000:]}")
    def secs(t):
        """A ``report.fmt_t`` cell in seconds, and half its last digit:
        µs to 0.1, ms to 0.01, s to 0.001."""
        for unit, scale, half in (("µs", 1e-6, 5e-8), ("ms", 1e-3, 5e-6),
                                  ("s", 1.0, 5e-4)):
            if t.endswith(unit):
                return float(t[:-len(unit)]) * scale, half
        return float(t), 0.0

    rows = {}
    for ln in out.splitlines():
        cells = [c.strip() for c in ln.strip("|").split("|")]
        if len(cells) == 5 and cells[0].isdigit():
            rows.setdefault(int(cells[0]), {})[cells[1]] = (
                secs(cells[3]), secs(cells[4]))
    n_rs = 0
    for st, names in sorted(rows.items()):
        (b0, h0), (bd, hd) = names.get("backward", ((None, 0), (None, 0)))
        rs = {k: v for k, v in names.items() if k.startswith("rs[b")}
        # within the table's rounding of each of the three cells compared
        if b0 is None or not rs or not all(
                b0 - h0 - h <= t0 <= b0 + bd + h0 + hd + h
                for (t0, h), _ in rs.values()):
            fail(f"report --section trace: step {st}: backward "
                 f"{(b0, bd)}, rs rows {rs}: each must start inside the "
                 f"backward row")
        n_rs += len(rs)
    print(f"report trace: {len(rows)} steps, {n_rs} rs rows, each starting "
          f"inside its step's backward row", flush=True)


def main():
    import torch
    phase("card")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import backend
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    dev = backend.resolve_device(None)
    card = _card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("build")
    t = time.time()
    built = backend.build()
    print(f"built {sorted(built) or 'nothing (current)'} in "
          f"{time.time() - t:.1f} s", flush=True)

    phase("kernels")
    k1 = check_batched_sumsq(dev)
    k2, k1_site = check_lars_update(dev)
    k1.update(k1_site)
    k5 = check_flash_attention(dev)
    k4, k4_bwd = check_smoothed_xent(dev)
    k3 = check_ring_add(dev)
    k1_lm, k2_lm = check_lm_shard_site(dev)
    k1.update(k1_lm)
    k2.update(k2_lm)

    # each path's launches of every kernel, read just after its run
    by_path = {}
    phase("slice")
    state0, batch_fn, by_path["slice"] = run_slice(dev)

    phase("context")
    check_in_context(dev, state0, batch_fn)
    del state0

    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    try:
        phase("zero1")
        by_path["zero1"] = run_zero1(dev, mesh)

        phase("zero1 context")
        check_zero1_in_context(dev, mesh, batch_fn)

        phase("durability")
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            by_path["durability"] = run_durability(dev, mesh, batch_fn, tmp)
        # torch.use_deterministic_algorithms leaves a reference cycle
        # through the phase's frame (an import's traceback); free its states
        # before the later phases read their peak memory
        gc.collect()
    finally:
        mesh.destroy()

    phase("cli")
    run_cli()

    phase("serve")
    model, params, batch, out, by_path["serve"], k5["serve"] = run_serve(
        dev)

    phase("serve context")
    k5["serve_context"] = check_serve_in_context(dev, model, params, batch,
                                                 out)
    del model, params

    phase("serve cli")
    run_serve_cli()

    phase("serve_moe")
    by_path["serve_moe"], k5["serve_moe"] = run_serve_moe(dev)
    gc.collect()

    phase("serve_qk")
    by_path["serve_qk"], k5["serve_qk"] = run_serve_qk(dev)
    gc.collect()

    phase("serve_nemo")
    by_path["serve_nemo"], k5["serve_nemo"] = run_serve_nemo(dev)
    gc.collect()

    phase("serve_mla")
    by_path["serve_mla"], k5["serve_mla"] = run_serve_mla(dev)
    gc.collect()

    phase("serve_hybrid")
    by_path["serve_hybrid"], k5["serve_hybrid"] = run_serve_hybrid(dev)
    gc.collect()

    phase("serve_xlstm")
    by_path["serve_xlstm"], k5["serve_xlstm"] = run_serve_xlstm(dev)
    gc.collect()

    phase("serve_audio")
    by_path["serve_audio"], k5["serve_audio"] = run_serve_audio(dev)
    gc.collect()

    phase("serve_vlm")
    by_path["serve_vlm"], k5["serve_vlm"] = run_serve_vlm(dev)
    gc.collect()

    phase("lm_train_moe")
    by_path["lm_train_moe"], k4["lm_train_moe"] = run_lm_train_moe(dev)
    gc.collect()

    phase("lm_train_nemo")
    by_path["lm_train_nemo"], k4["lm_train_nemo"] = run_lm_train_nemo(dev)
    gc.collect()

    phase("lm_train_hybrid")
    by_path["lm_train_hybrid"], k4["lm_train_hybrid"] = \
        run_lm_train_recurrent(dev, "lm_train_hybrid", "zamba2-7b",
                               HYBRID_TRAIN_LAYERS)
    gc.collect()

    phase("lm_train_xlstm")
    by_path["lm_train_xlstm"], k4["lm_train_xlstm"] = \
        run_lm_train_recurrent(dev, "lm_train_xlstm", "xlstm-125m")
    gc.collect()

    phase("lm_train_audio")
    by_path["lm_train_audio"], k4["lm_train_audio"] = run_lm_train_frames(
        dev, "lm_train_audio", "whisper-base", *AUDIO_TRAIN)
    gc.collect()

    phase("lm_train_vlm")
    by_path["lm_train_vlm"], k4["lm_train_vlm"] = run_lm_train_frames(
        dev, "lm_train_vlm", "internvl2-2b", *VLM_TRAIN)
    gc.collect()

    phase("lm_train")
    model, state0, batch, by_path["lm_train"], _ = run_lm_train(dev)

    phase("lm_train context")
    k4["lm_train_context"] = check_lm_train_in_context(dev, model, state0,
                                                       batch)
    del model, state0, batch

    phase("examples")
    by_path["examples"] = run_examples()

    phase("report")
    run_report()

    phase("ring, ring context")
    ring = run_ring()

    phase("lm_ring")
    torch.cuda.empty_cache()
    lm_ring = lm_resume = None
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        lm_ring = run_lm_ring(Path(tmp))
        if lm_ring is not None:
            phase("lm_ring resume")
            lm_resume = run_lm_resume(dev, Path(tmp), lm_ring)

    phase("lm_ring_families")
    families = run_lm_ring_families()

    phase(", ".join(TP_PHASES))
    tp = run_tp()
    entries = {"k1": k1, "k2": k2, "k3": k3, "k4": k4, "k4_bwd": k4_bwd,
               "k5": k5}
    # rank 0's counts, summed over the ring's configurations; null where
    # one card ran no ring
    by_path["ring"] = {key: None if ring is None else
                       sum(r["launches"][key] for r in ring["runs"])
                       for key in entries}
    # lm_ring: rank 0's counts over its configurations and autotune runs;
    # lm_resume: the one-card step from the four-card checkpoint; null
    # with fewer than four cards
    by_path["lm_ring"] = {key: None if lm_ring is None else
                          sum(r["launches"][key] for r in lm_ring["runs"])
                          + sum(t["launches"][key]
                                for t in lm_ring["autotune"].values())
                          for key in entries}
    by_path["lm_resume"] = {key: None if lm_resume is None else
                            lm_resume["launches"][key] for key in entries}
    # lm_ring_families: rank 0's counts over its runs; null with fewer
    # than four cards
    by_path["lm_ring_families"] = {
        key: None if families is None else
        sum(r["launches"][key] for r in families["runs"])
        for key in entries}
    # the model-axis paths: rank 0's counts (resnet_xla's summed over its
    # two sync_bn forms); null with fewer than four cards
    for path in ("serve_tp", "lm_train_tp", "serve_tp_hybrid",
                 "lm_train_tp_xlstm", "ckpt_tp", "serve_tp_audio",
                 "serve_tp_vlm", "lm_train_tp_frames", "serve_tp_moe",
                 "lm_train_tp_moe", "serve_tp_mla", "lm_train_tp_mla"):
        by_path[path] = {key: None if tp is None else
                         tp[path]["launches"][key] for key in entries}
    by_path["resnet_xla"] = {key: None if tp is None else sum(
        r["launches"][key] for r in tp["resnet_xla"].values())
        for key in entries}
    if tp is not None:
        k5["tp"] = tp
    if ring is not None:
        k3["ring"] = ring
    if lm_ring is not None:
        k3["lm_ring"] = dict(lm_ring, resume=lm_resume)
    if families is not None:
        k3["lm_ring_families"] = families
    for key, entry in entries.items():
        entry["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        entry["launches"] = sum(c[key] for c in by_path.values()
                                if c[key] is not None)

    phase()
    print(f"phase seconds: {json.dumps(_PHASE_S)}; total "
          f"{sum(_PHASE_S.values()):.1f}", flush=True)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--example"]:
        example_main(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--lm-ring-families"]:
        lm_ring_families_main(tuple(sys.argv[2:]))
    elif sys.argv[1:2] == ["--tp"]:
        tp_main(tuple(sys.argv[2:]))
    elif sys.argv[1:2] == ["--ring"]:
        ring_main()
    elif sys.argv[1:2] in (["--ring-rank"], ["--lm-ring-rank"],
                           ["--lm-ring-families-rank"], ["--tp-rank"]):
        # a rank that fails must not wait at exit on collectives the
        # others will never join: leave at once, the launcher stops them
        try:
            if sys.argv[1] == "--ring-rank":
                ring_rank()
            elif sys.argv[1] == "--lm-ring-families-rank":
                lm_ring_families_rank(tuple(sys.argv[2:]))
            elif sys.argv[1] == "--tp-rank":
                tp_rank(tuple(sys.argv[2:]))
            else:
                lm_ring_rank(sys.argv[2])
        except SystemExit as e:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(e.code if isinstance(e.code, int) else 1)
        except BaseException:
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    else:
        main()
