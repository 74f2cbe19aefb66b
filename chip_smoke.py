#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (visper_lm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. environment: torch, CUDA, Triton, nvcc, the card's name and power limit;
  2. build: nvcc compiles every kernel from visper_lm_tpu_torch/csrc, one
     process per source, all started together;
  3. kernels: each kernel vs its plain PyTorch version on the card, with the
     kernel's, the plain version's and one library call's time (the library
     call is a yardstick only; the port never calls it) beside the least time
     the card could take. Tolerances against the plain version computed in f32:
       B1 flash forward: bf16 max abs error <= 2e-2 (f32 1e-4) on rows with a
          valid key, lse <= 1e-3. At the serving and the training shape the
          mma.sync kernel it replaced is held to the same bounds and timed in
          the same call (`mma_sync_ms`; in turns: old, new, new, old);
       B2/B3 flash backward (dq, dk/dv) against the plain backward fed the
          plain forward's f32 out and lse: relative Frobenius error <= 1e-2
          and, per element, |err| <= 2e-2 + 1e-2 x |ref| (the bf16 rounding
          of the largest gradients, which sum over up to 1024 rows), at the
          training and the GQA shape, timed eager and as CUDA graphs beside
          SDPA's backward; the same launch 20 times must give identical bytes;
       B4 Swin window attention at the eight Swin-L launch shapes (stages 1-4,
          unshifted and shifted; micro-batch 2): bf16 max abs error <= 2e-2;
          the same launch 20 times the same bytes. The kernel and SDPA
          (bf16 bias + mask) timed as CUDA graphs in turns, and their sums
          weighted by a train step's 48 launches beside the bound's;
       B5 w4a16 matmul (Phi3-mini's four (din, dout) pairs at M = 8 and, but
          for lm_head, M = 6144; one AWQ case; a tp 2 rank's slices of the
          block linears at M = 6144, phase 17 (d)'s) against its plain version in
          f32: relative Frobenius error <= 1e-2 and max abs error <= 2e-2 x
          max|ref| (the bf16 output's rounding). Each case also times the
          mma.sync kernel it replaced (`mma_sync_ms`; in turns: old, new, new,
          old). An M = 8 case is host-bound in an eager loop, so beside `ms`
          (eager, as before) it is timed as a CUDA graph of launches: warm
          (`device_ms`: one weight, resident in L2) and cold (`cold_ms`: in
          turn over enough copies of the weight to exceed the 50 MB L2, as
          the decode path finds it), the library call the same way; the
          byte bound is a device-memory bound and goes with `cold_ms`. The
          same M = 8 launch 20 times must give identical bytes;
       B6 decode attention (standalone, as in the JAX package: no path calls
          it, and its launch count over phases 4-9 must stay 0) at the decode
          shape in bf16 and int8, and GQA 32/8 H128 with a fully masked row:
          on rows with a valid key relative Frobenius error <= 1e-2 and max
          abs error <= 5e-3 (max |out| is about 0.3), the masked row exactly 0,
          20 repeated launches the same bytes; the serial kernel it replaced
          is held to the same bounds. A call is host-bound in an eager loop
          (`eager_ms`), so the split kernel, the serial kernel and the library
          call are each timed as a CUDA graph of launches, in turns: warm
          (`device_ms`: one cache; the int8 one fits the L2) and cold
          (`cold_ms`, which is the record's `ms`: in turn over enough copies
          of the cache to exceed the 50 MB L2);
  4. serving path: Phi3-mini-4k + CLIP-ViT-L/14-336 (distill task tokens) at
     full width with seeded random weights serves 8 left-padded multimodal
     prompts (768 tokens) through `Generator.generate`, greedy, NEW_TOKENS = 16 new tokens.
     The flash kernel must launch exactly once per decoder layer (32), and the
     prefill logits must match a prefill with plain attention within
     0.05 x max|logits| (bf16 through 32 layers). The decode chunk keeps its
     step and slot on the device: the same prefill and cache decoded with a
     Python-int q_offset must give the same tokens and cache, bit for bit
     (the same arithmetic), and generate() the same tokens. Timed as
     tools/bench_decode.py (`measure`) times it: the prefill alone, the
     decode chunks alone after a warm chunk, then generate end to end (the
     same timing in phases 6, 10, 11 and 19);
  5. serving profile: device time by kernel for one prefill and one decode chunk
     (of PROFILE_CHUNK = 4 tokens, as phase 6's, for the profiler's host time);
  6. quantized serving on the same model and batch: AWQ activation RMS over
     the batch's spliced embeddings (`decoder_act_rms`), then int8 KV +
     calibrated w4a16 weights through `Generator.generate`: 8 x 16 tokens, B5
     launched 225 times per decoder forward (7 linears x 32 layers + lm_head;
     prefill and every decode step), the prefill logits with the kernels
     within 0.05 x max|logits| of the plain versions' on the same quantized
     weights; the int4-vs-bf16 drift is printed (a quality trade-off, not a
     check). Then int8 KV + w8a16 generates 8 x 16 tokens. Both are timed as
     in phase 4; one int4 prefill and one int4 decode chunk are profiled,
     with B5's share of the device time;
  7. training path: config #1's PT distillation step (the same VLM plus the
     frozen DINOv2-L, CLIP-H and Swin-L teachers computing their targets in
     the step, bf16, B4 x T1024; tools/bench.py's batch, `bench_batch`, which
     phases 8, 11, 16 and 19 also take) through `make_train_step`, timed by
     tools/bench.py's `time_steps`: one warm-up step, then 3 steps between
     two synchronizes. Each step must launch B1, B2 and B3 once per decoder
     layer (32 each) and B4 once per Swin block and teacher micro-batch (48);
     the loss must be finite and change from step 2 on (update 1 has lr 0); a
     frozen decoder weight must not change; at B1 the step's loss and
     trainable gradients with the kernels must match the same step with plain
     attention (decoder and window): loss within 1e-3 (relative), cosine
     >= 0.999 for every trainable with a nonzero gradient. Then one step is
     profiled: B2/B3's and B4's device time, and B4's 48 launches all of the
     streamed kernel. This phase's step runs without remat;
  8. trainer path, the main path (same model, teachers and batch): one
     warm-up and two timed steps with no remat and under each of the seven
     remat policies (bench.py's default is "save_gate"), each printing step
     ms, peak GiB and its B1-B4 launches (B1 once per layer, twice where the
     recompute runs the flash forward again: every policy that does not
     keep "flash_out"; B2/B3 once per layer; B4 48), save_gate's peak below
     no remat's, each exact policy's (all but save_mlp_q8, which changes the
     forward and cuts the gradient at its int8 cast, as in JAX) loss within
     1e-3 and gradient cosine >= 0.999 of no remat's at B1, and one
     save_gate step profiled. Then `trainer.train` (save_gate,
     grad_accum_steps 2, 4 steps, a checkpoint every 2) with its launches
     per step checked, restarted from its step-2 checkpoint to step 4: the
     resumed steps' losses within 1e-5 (relative) of the uninterrupted
     run's; examples/s and MFU (`train_step_flops` + `teacher_flops` against
     989 TFLOP/s; `mfu_pt` without the frozen decoder's weight gradients,
     which JAX's count includes). One step at B8 (the chunked
     cross-entropy): loss within 1e-3 and gradient cosine >= 0.999 of the
     full f32 logits'. Two updates
     at B1 with f32 master weights: every trainable equals its master
     rounded to its dtype;
 8b. the measurement tools on what phases 7-8 hold (`tools_phase`):
     tools/bench_teacher_pattern.py on phase 7's bf16 teachers at 336 / 224 /
     768 px (8 images, one timed pass): every teacher's per-image rows within
     ROW_BOUND (relative Frobenius 2e-2) of its batched rows, B4 once a
     Swin-L block a call (432); serve/speculative._bench at its full-width
     decoders (target 32 x 3072, draft 4 x 1024, seeded) with
     TOOLS_SPEC_ITERS = 5 iterations: finite positive timings and
     break-even; tools/bench_input_pipeline.py on TOOLS_PIPELINE_IMAGES = 32
     PNGs (its default 192): a positive rate and a finite paced step;
  9. engine path: the continuous-batching `Engine` at bench_engine.py's
     defaults (8 slots, max_len 1536, decode quantum 8, admission groups of
     8 with a deferral of 4, prompt bucket 128; int8 KV + w8a16; phase 4's
     decoder, which phases 7-8 leave frozen, cut in depth to its first
     ENGINE_LAYERS = 2 of 32 blocks to keep the script inside its time
     limit: the per-layer counts
     below are of those) serves bench_engine.py's 32
     requests (tools/bench_engine.py `request_mix`: 13 system ids, one image,
     16-63 text tokens, 8-127 new tokens from np.random.default_rng(0);
     phase 17 (e) takes its first 8) after a warm-up, twice, in turns with
     the batch loop (bench_engine.py measurement 2: a Generator per batch of
     8, each batch decoding to its longest request): engine, loop, loop,
     engine. Each engine run: every request gets exactly its max_new_tokens
     (no EOS is set), no slot stays occupied, one host sync per quantum (the
     engine's count, and torch's sync-debug warnings raised inside the
     engine, counted by call stack),
     B1 once per layer per prefill dispatch; requests/s, tokens/s, time to the
     first token (its arrival on the host), ms per engine step. One engine
     step with every slot busy and one decode chunk of the loop profiled.
     The engine's prefill logits with the kernels within 0.05 x max|logits|
     of use_kernel=False. On a one-slot bf16 engine: a prefix
     handle + a 40-token suffix, and a prefill in chunks of 256, each
     against the full prompt's prefill within 0.05 x max|logits|. The
     speculative engine (spec_k 4, spec_quantum 4) on 8 requests, its token
     agreement with the plain engine printed (bf16 GEMMs of other shapes
     round otherwise: not bounded); `SpeculativeDecoder` (Phi3's decoder as
     target, its first half of the blocks with the same embedding, norm and
     head as draft) and `BeamSearchDecoder` (4 beams) on one 128-token prompt, 32
     tokens; an int4 engine run (phase 6's AWQ calibration) on 8 requests
     with B5 at 7 x layers + 1 launches per decoder forward. B6 must stay at 0 over
     phases 4-10;
 10. user API path (visper_lm_tpu_torch/api.py) at Llama-3-8B + CLIP-ViT-L/14-336
     (llama3_clip_vlm with distillation heads, bf16, full width, cut to
     API_LAYERS = 4 of 32 layers for time (the per-layer
     launch counts below scale with it: "32" is the depth), seeded random
     weights made on the card; phases 4-9's model released first) with a whitespace tokenizer defined here (the card has no
     `transformers`): B1 and B5 at Llama-3's shapes against their plain
     versions (B1: B8 at the chat batch's padded length, GQA 32/8 H128, its
     left pads, SDPA with enable_gqa as the yardstick; B5: gate/up 4096 ->
     14336 and down 14336 -> 4096 at M = 8 and M = 8 x the padded length),
     as in phase 3; `export_vlm` -> `import_vlm` in memory, every tensor
     bit-equal; `VisperModel.chat` of 8 questions over 8 seeded uint8 images
     of mixed sizes (LLaVA-1.5's "pad" aspect; "square" once in bf16), 32
     new tokens, in bf16, at the default quantization (bf16 too: JAX
     quantizes by itself only on a TPU; its answers must equal the bf16
     row's), at int8 KV + w8a16 and at int8 KV + int4 (explicit flags): B1
     32 per prefill, B5 225 per forward at int4 and 0 otherwise, first-token
     logits with the kernels within 0.05 x max|logits| of the plain path
     (the share printed), prefill ms, decode ms/token, tokens/s and peak
     GiB, the bf16 prefill and decode chunk profiled; `serve` of the same
     questions at int8 KV + w8a16 (its B1 launches a multiple of 32; each
     request's engine prefill logits within 0.05 x max|logits| of chat's
     Generator row); a `ChatSession` (int8 KV + w8a16) of three turns whose
     turns 2-3 prefill only their own tokens (the engine's `prefill_tokens`);
     `save_hf_checkpoint` -> `from_hf_checkpoint` at full width and 2 layers
     through the repo's tmp/ (removed after), tensors bit-equal, and a
     LLaVA-style config.json without "visper_config" giving the same config
     through `config_from_hf_json`; Vicuna-7B at full width and 4 layers:
     one chat of 2 questions under the vicuna_v1 template.
 11. vision path at Llama-3-8B, reusing phase 10's decoder (the tower
     swapped, not the model made again): the ConvNeXt-XXL trunk at 768 px
     (`with_convnext_tower(llama3_clip_vlm(distill=True))`, 843 M params in
     bf16, every block's gamma from N(0, 0.1^2)) on the chat's 8 images:
     output (8, 576, 3072), finite, relative Frobenius error against an f32
     copy of the same weights <= 2e-2, its time; `chat` through it (bf16,
     16 new tokens; B1 32, first-token logits within 0.05 x max|logits| of
     the plain path); an anyres chat (CLIP-L, spatial_unpad, JAX's
     grid_pinpoints) of 4 images whose sizes select four grids (3, 3, 5
     and 4 tiles: the tiles padded to 5, the newline indices moved), the
     same checks; B1 at both chats' prefill shapes against its plain
     version as in phase 3; one S2 call (`clip_tower_features_s2`, CLIP-L,
     batch 2, scales 336 and 1008): (2, 576, 2048), finite; then, with the
     Llama-3 model released, one PT step of bench.py's --tower convnext
     cell (Phi3-mini, config #1, B4 x T1024, the teachers, save_gate): B1
     64, B2/B3 32, B4 48, loss and every trainable gradient finite, the
     frozen trunk without a gradient and unchanged. Every record carries the
     card's name and power limit.
 12. training from the recipes (phases 10-11's Llama-3-8B released first):
     a seeded dataset in the repo's tmp/ (removed after): 16
     LLaVA-Pretrain-style records (<image> + a question, a 20-60-word
     answer) and 16 IFT-style multi-turn ones (a quarter text-only) over 16
     PNG images of phase 10's sizes written with the port's PNG writer; the
     host pipeline timed per PT batch (decode, tower pixels, teacher_batch
     through the native library, whose g++ build is timed). (a) PT at
     Llama-3-8B + CLIP-L from recipes/pretrain.args through `cli.main`
     (fake-whitespace tokenizer, B4, 3 steps, a checkpoint at step 2, the
     teachers seeded with the CLI's WARNING): B1 64 (full remat), B2/B3 32,
     B4 48 per step; finite losses, 3 metrics rows; every frozen weight
     bit-equal to a fresh seed-0 init and the trainables moved; one step
     profiled; a second `cli.main` resumed from the step-2 checkpoint gives
     step 3's loss within 1e-5. (b) IFT at Phi3-mini from
     recipes/finetune.args with --init-from a seeded Phi3-mini + CLIP-L
     checkpoint written by `save_hf_checkpoint` (save_gate, B4, 3 steps;
     the run's final 38 GB checkpoint of weights and f32 moments is
     recorded, not written): the whole decoder trains, the tower stays the
     checkpoint's bit for bit, B1 64 and B2/B3 32 per step, peak GiB; layer
     16's seven weight gradients with the kernels against use_kernel=False
     (cosine >= 0.999, relative Frobenius printed) and both against the
     plain path on an f32 copy of the weights: the kernels' relative
     Frobenius distance from f32 at most 1e-2 above the plain bf16 path's
     (itself 1-2.4 % at full depth). (c) bench.py's --stage
     lora (r 64, alpha 16, all seven targets) and --stage vision_tower
     configurations on (b)'s model: 3 `trainer.train` steps each at B4 on
     the IFT data: LoRA's B zero at the start (the first loss equals the
     base model's bit for bit), the base decoder bit-unchanged by both, the
     adapters, projector and tower moved where their stage trains them.
 13. visual interpretations at Llama-3-8B + CLIP-L (phase 12's models
     released; `llama3_clip_vlm(distill=True)` made on the card as phase 10
     makes it, with its whitespace tokenizer; its taps VIZ_TAPS, the gen
     task at layers 18-20 instead of 12-20, for time: the demo renders a
     generation for each), every record with the card's
     name and power limit. (a) `VisperModel.get_visual_interpretations` of one
     seeded 480 x 640 image and a 40-word question: B1 exactly 32 launches,
     every task / layer prediction of the expected shape and within 0.05 x
     max|ref| of the same call with use_kernel=False (the shares printed),
     its ms. (b) DPT at DAv2-L's widths (in_channels 1024, seeded): each
     depth layer's map 336 x 336, finite, in [0, 1]. (c) OneFormer at
     ONEFORMER_COCO (seeded) over Swin-L (bf16, seeded) at 768 px with the seg
     head's prediction substituted for the last stage: B4 launches equal to
     Swin-L's 24 blocks (printed), class and mask logits within 0.05 x
     max|ref| of use_kernel=False, the semantic maps equal on >= 99 % of
     pixels, its ms. (d) the unCLIP pipeline at SD21_UNCLIP's widths (bf16,
     seeded) renders one 768 x 768 image from the gen head's 1024-wide
     prediction, 25 DPM-Solver++ steps at guidance 10: finite, in [0, 1], the
     same seed the same bytes twice (cuDNN's deterministic algorithms); one
     UNet forward in bf16 within 2e-2 relative Frobenius of an f32 copy of the
     same weights; ms per denoise step (one UNet call on the CFG batch), the
     VAE's ms, the whole generation's ms and its peak GiB. (e)
     `teacher_bundles.pack_modules` writes (b)-(d)'s decoders into the
     repo's tmp/ (removed after; the gen bundle at VIZ_DEMO_STEPS = 5
     denoise steps, for time); `demo.main` one-shot --viz loads them
     through `load_viz_decoders` and writes all three tasks' PNGs for every
     tapped layer, each read back with `read_png`; `DistillVizHook` called
     directly writes its grids; a `delta` of the heads (bf16) round-trips
     bit for bit.
 14. evaluation at Llama-3-8B + CLIP-L (made again, seed 14, phase 10's
     tokenizer; full width, cut to EVAL_LAYERS = 8 layers for time: the
     "32"s below are the depth) through the port's eval package, every record with the card's
     name and power limit: (a) 16 CV-Bench-shaped records (test.jsonl and
     PNGs of four sizes) and 16 MMStar-shaped ones, written under the repo's
     tmp/ (removed after); (b) `run_cvbench` / `run_mmstar` in chat batches
     of 8 (8 new tokens): B1 exactly 32 per prefill, every score in [0, 1],
     an answer per record; (c) `harness.evaluate` of 8 CV-Bench docs through
     `VisperLmms.generate_until` (B1 32 per chunk, `errors` empty),
     `loglikelihood` on 8 requests (B1 exactly 32 a request) and
     `loglikelihood_rolling` on 3 (32 a request), finite and negative; (d)
     the 8 requests' per-token log-probs with the kernel, with the plain path
     (bf16) and with the plain path on an f32 copy of the weights: the
     kernel's relative distance from f32 at most 1e-2 above the plain bf16
     path's (phase 12's form: both bf16 paths drift over 32 layers); (e)
     FID-InceptionV3 from a seeded pt_inception-layout state dict on 64
     images at 512 px (the antialiased downscale to 299): (64, 2048) finite,
     within 1e-4 relative Frobenius of the CPU run of the same weights (f32,
     TF32 off: f32 sums in other orders), its ms; (f) `python -m
     visper_lm_tpu_torch.eval.validate` (run in-process through runpy, so its
     B1 launches are counted: 2 layers x 2 prefills) on a full-width 2-layer
     checkpoint written by `save_hf_checkpoint`, `--tokenizer fake-whitespace
     --device cuda --limit 8`: exit 0, both score tables, the answer files;
     the logit-parity gate runs where transformers is installed (its diff in
     the report) and prints its skip where it is not.
 15. the memory levers (every record with the card's name and power limit;
     phase 1 also prints the host's MemTotal / MemAvailable and the
     locked-memory limit): (a) 1 GiB between page-locked host memory
     (`device.HostPool`) and the card, each way and both at once: GB/s;
     (b) at Llama-3-8B + CLIP-L widths cut to MEM_LAYERS = 2 layers (bf16,
     IFT stage, lr
     1e-3, B2 x T1024 full-length rows), 3 steps each of the on-card AdamW,
     `offload_opt_state=True` and offload + `stream_grads=2`: B1 4 / B2 2 /
     B3 2 a step, the losses within rtol 1e-5 and every trainable within
     rtol 1e-4 / atol 1e-6 of the on-card run's (JAX's
     test_stream_grads_step_matches_plain bounds), bit-equality reported;
     (c) `cli.main` of recipes/finetune.args with --offload-opt-state
     --stream-grads 8 at Llama-3-8B + CLIP-L, full depth (seeded weights
     through --init-from a `save_hf_checkpoint` directory; 16 written
     single-turn records whose batches pad to T 4096; the whitespace
     tokenizer; --per-device-batch-size cut from 16 to 4, 3 steps; the final
     checkpoint of weights and moments recorded, not written): B1 64 / B2 32 /
     B3 32 / B4 0 a step, finite losses that change from step 2, the state
     page-locked, step ms, peak GiB, pinned GiB; one more step timed whole
     and its update on its own; B1-B3 at the run's batch shape against their
     plain versions and SDPA as in phase 3; then the same configuration
     without the levers must raise torch.OutOfMemoryError (where is
     printed). Phi3-mini stands in, with a line that says so, when
     MemAvailable is below the pinned state plus 10 GB; (d) `python -m
     visper_lm_tpu_torch.train.aot` (in-process through runpy) with --run at
     (c)'s settings on Phi3-mini (at Llama-3-8B it pinned the moments on the
     host again: 68.5 s): B1 64 / B2 32 / B3 32 a step over its 2 steps, and
     its static count of weights and on-card state within 5 % of the
     allocator's reading once its run had set them up (the breakdown counts
     no activations: the OOM of (c) is what shows the configuration without
     the levers does not fit).
 16. data parallelism and ZeRO (every record with the card's name and power
     limit; the kernels are built by phase 2, before any rank starts): the
     one-process PT step of config #1 (Phi3-mini-4k + CLIP-L, teachers in
     the step, B4 x T1024, save_gate, lr 1e-3 without warmup; its decoder
     cut to DP_LAYERS = 2 layers with the taps inside them, DP_TAPS, for
     time) from seeds,
     3 updates on 3 batches (update 1 has lr 0, as the schedule gives it;
     2 and 3 lr 1e-3, so the moments mix two batches' gradients and the
     last loss is taken after a real update); (a) the same step in a
     one-rank NCCL group (`init_distributed`, `make_train_step(mesh=...)`):
     losses within rtol 1e-5 and trainables within rtol 1e-4 / atol 1e-6 of
     the step without a group, bit-equality reported, B1 64 / B2 32 / B3 32
     / B4 48 a step; then the tolerance of two bf16 runs, from an f32 run of
     the student (plain attention, the port's AdamW in f32) from the same
     weights on the same batches: each loss's, the step-1 gradients' and
     the parameter moves' (p - p0) distance from the bf16 run, with two
     checks that the bounds below can fail (the last loss moves more than
     3 x its tolerance; the moves' bounds stay under 0.75, where a move of
     0 is at 1); (b) two ranks (`chip_smoke.py --phase16-rank`) share the
     card over gloo (it carries CUDA tensors by staging each collective
     through host memory; NCCL refuses two ranks on one GPU), each its 2
     rows of each global batch, as plain dp, zero_frozen and zero_params:
     each loss within 2 x the bf16-vs-f32 distance + 1e-4 relative of the
     one-process step's; the step-1 gradients as the optimizer's own
     `reduce_grads` leaves them (the ranks' reduce-scattered slices put
     side by side, an all-reduced leaf bit-equal on both ranks; a strided
     sample of 65,536 elements a tensor) at most 1e-2 farther from the f32
     ones than the one-process step's; the parameter moves after 3 updates
     within 2 x the one-process run's relative Frobenius distance from f32
     (+ 1e-3) of the f32 moves, and within 3 x it of the one-process moves
     (publish's all-gather and ZeRO-3's shard update are in them); B1 64 /
     B2 32 / B3 32 / B4 24 a rank and step, with zero_frozen 45-55 % of the
     decoder's bytes on each rank; each rank's peak GiB, parameter bytes
     held, launches and step ms; (c) IFT at Phi3-mini (3.8 B trainables, B4
     x T1024 full-length rows, 2 per rank, 3 batches) with ZeRO-2 moments on
     the two ranks against the one-process run (no f32 run of it fits
     beside: (b)'s f32 distances stand in): losses within 2 x (b)'s largest
     relative loss distance + 1e-4, plus a tenth of the last loss's move
     (which must exceed twice that bound); the reduced step-1 gradients
     (sampled) within 2 x (b)'s gradient distance + 1e-2 of the one-process
     ones; the sampled parameter moves within 3 x (b)'s move distance +
     1e-2; each rank's peak beside the one-process peak. Any rank that
     fails or does not finish within 420 s fails the phase.
 17. tensor parallelism (`--phase17-rank`, `--phase17c-rank`: gloo ranks
     sharing the card, dp 1; every record with the card's name and power
     limit): (a) the `Generator` at Phi3-mini-4k + CLIP-L, full width cut to
     TP_GEN_LAYERS = 8 layers (time), bf16, on phase 4's 8 x 768-token
     prompts, at tp 2: the prefill
     logits within 2 x the distance between the one-process bf16 logits
     and an f32 copy's on the plain path, of the one-process logits; the
     greedy tokens (8 a row) equal to the one-process Generator's through
     the first position where the one-process top-2 margin falls under
     that tolerance (printed); the two ranks' logits and tokens bit-equal;
     per rank B1 8 a prefill (one a layer), a cache of 16 kv heads, half the decoder's
     bytes (50-51 %), an init peak under the whole decoder's bytes, peak
     GiB, prefill ms and decode ms/token. (b) phase 16's PT step (config #1
     at 4 layers, its 3 global batches, 3 updates) at tp 2, plain and with
     shard_teachers: each loss, the reduced step-1 gradients and the
     parameter moves held to phase 16's one-process step and f32 run by
     phase 16's bounds; the replicated trainables bit-equal on both ranks;
     shard_teachers' losses equal to plain's, its teachers 45-60 % of their
     bytes a rank; B1 4 / B2 2 / B3 2 / B4 48 a rank and step; per rank
     peak GiB, the decoder's and the teachers' bytes, step ms. (c)
     `cli.main(["@recipes/pretrain_full.args", ...])` at Llama-3-8B widths
     cut to TP_RECIPE_LAYERS = 2 layers (taps DP_TAPS) on four ranks (--tp 4, the recipe's
     --zero-params --offload-opt-state --shard-teachers --stream-grads 8),
     2 steps on phase 12's PT records, the final checkpoint recorded, not
     written: every rank a quarter of the decoder (25-26 %), its init peak
     under the whole decoder's bytes (no rank held it), the same finite
     metrics on every rank, B1 4 / B2 2 / B3 2 / B4 24 a step, the pinned
     total under 57.99 GiB; per rank peak and pinned GiB and step ms. Inside
     (a)-(b)'s spawn, on (a)'s tp 2 model, each against the one-process
     run of the same code before the spawn: (d) the Generator with int4
     weights, AWQ-calibrated on phase 4's prompts through the rank's
     decoder: prefill logits within 2 x the one-process int4 logits'
     distance to (a)'s f32 logits, greedy tokens (8 a row) under (a)'s
     margin rule with that tolerance, both ranks bit-equal; B5 7 a layer
     plus the head a forward on each rank (57: no linear falls back to the
     dequantized product), B1 8 a prefill, 45-55 % of the int4 decoder's
     bytes, prefill ms and decode ms/token; (e) the Engine at
     bench_engine.py's settings with int8 KV + w8a16 on TP_ENGINE_REQUESTS
     = 8 of its workload's requests: tokens under (a)'s margin rule
     (margins along the one-process tokens by teacher forcing; the first
     divergence printed with its margin), B1 8 a prefill dispatch, a cache
     of 16 kv heads, steps and tokens/s a rank; (f) at batch 1 on a
     128-token prompt, TP_SPEC_TOKENS = 8 tokens: SpeculativeDecoder (the
     target's first half as the draft), PromptLookupDecoder and
     BeamSearchDecoder (2 beams), each under (a)'s margin rule on the
     one-process greedy path's margins; (g) the LoRA stage (r 64, phase
     12's) at Phi3-mini widths, DP_LAYERS layers, on phase 16's 3 IFT
     batches (B4 x T1024, save_gate): losses, reduced step-1 gradients and
     moves held to the one-process LoRA step and an f32 run by phase 16's
     bounds, the replicated factors bit-equal on both ranks, B1 4 / B2 2 /
     B3 2 a step, peak GiB a rank. (c)'s ranks start once (a) and (d)-(f)
     are timed (a file from (a)-(b)'s rank 0) and share the card with (b),
     (g) and the parent's checks, so (b)'s and (g)'s step times include
     (c)'s load. Any rank that fails or does not finish
     within 420 s fails the phase.
 18. sequence and pipeline parallelism (`--phase18-rank`, `--phase18c-rank`:
     gloo ranks sharing the card; every record with the card's name and
     power limit): (a) Llama-3-8B's attention (32 q / 8 kv heads, H128,
     causal, bf16, B1 x T8192, seeded) at sp 2, forward and backward with a
     fixed dout, through `ulysses_attention` (B1 on each rank's 16 heads
     over every row, B2/B3 in the backward: 1 / 1 / 1 a rank) and through
     `ring_attention` (the f32 recurrence in stock ops: no kernel), each
     rank's rows put together and held to the one-process B1/B2/B3 call
     (relative Frobenius <= 2e-2, bit-equality printed) and to an f32 plain
     run, one kv head's group at a time (<= 1e-2), out, dq, dk, dv; (b) the
     finetune step at Llama-3-8B widths cut to SP_LAYERS = 2 layers, B1 x
     T8192, save_gate, sp 2 (Ulysses: 32/8 heads divide 2), 2 updates
     (the first has lr 0) and the loss on the last batch after them,
     against the one-process step and an f32 run from the same seed (plain
     attention one kv group at a time, rematerialised; f32 AdamW): phase
     16's bounds on each loss, the step-1 gradients as the optimizer's
     reduce leaves them (sampled) and the parameter moves; B1 4 / B2 2 / B3
     2 a rank and step; (c) the finetune step at Phi3-mini widths cut to 4
     layers, B4 x T1024, pp 2 x tp 2 on four ranks (4 microbatches of 1,
     JAX's rule), held the same way (gradients and parameters gathered over
     tp, each stage's blocks from its ranks, the shared leaves bit-equal
     across the stages), B1 16 / B2 8 / B3 8 a rank and step, 4
     point-to-point sends a rank and step. Per rank: peak GiB, the
     decoder's bytes held, step ms. Inside the same spawns, the memory
     levers and LoRA under sp and pp: (b) and (c) again with
     `offload_opt_state=True, stream_grads=2` (every state tensor stays on
     the card: no spec covers 'seq' or 'pipe', JAX's plan; the streamed
     gradients go through pinned host memory), and the LoRA stage (r 64,
     alpha 16, seven targets) at (c)'s shape, its factors through the
     pipeline. Each is held by phase 16's bounds to an f32 run and to a
     reference step (the levers: the same ranks' plain step, and whether
     the losses, trainables and moments are bit-equal to it is printed;
     LoRA: the one-process LoRA step), with (b)'s / (c)'s launches a rank
     and step, peak GiB and pinned bytes a rank. The MoE decoder in the
     same spawns: (b) its finetune step at Phi3-mini widths with phase 19's
     MoE (4 experts, top-2, cf 1.25), SP_MOE_LAYERS = 2 layers, B2 x T8192,
     sp 2 (each rank's rows routed over the seq group: capacity, priority
     and aux of the global batch), and (c) the same at MOE_EP_LAYERS = 4
     layers, B4 x T1024, pp 2 x tp 2 (JAX's plain loop: no point-to-point
     send, each foreign block gathered before its forward and its backward,
     4 a rank and step), each held to a one-process step and an f32 run by
     phase 16's bounds (c's references are phase 19 (c)'s, made here once),
     B1 4 / B2 2 / B3 2 ((b)) and 8 / 4 / 4 ((c): every rank runs every
     layer; it starts once (b)'s ranks have ended: four MoE stages do not
     fit the card beside them) a rank and step, the first forward's routes agreeing with the
     one-process run's on >= 0.99 of the (token, k) routes a layer and the
     step-1 dropped share within 1e-3 (both printed, with whether they are
     equal). (c)'s ranks start once (a)'s attention timings are taken and
     share the card with (b)'s, so (b)'s and (c)'s step times include each
     other's load. Any rank that fails or does not finish within 420 s
     fails the phase.
 19. the MoE decoder and expert parallelism (every record with the card's
     name and power limit): the model is Phi3-mini-4k + CLIP-L with JAX's
     dry-run MoE (4 experts, top-2, capacity factor 1.25, aux weight 0.01:
     11.07 B decoder parameters, 22.1 GB of bf16 weights). (a) the
     `Generator` at full width and depth on phase 4's 8 x 768-token
     prompts, 16 greedy tokens: prefill ms, decode ms/token, peak GiB, the
     dropped share of the prefill and of each decode step (N 8: capacity
     5), B1 32 a prefill; an int4 prefill (B5 129 a forward: the four
     attention projections a layer and the head; the banks stay dense);
     the first 8 layers, bf16 with the kernels, held to the same weights in
     f32 on the plain path: the prefill logits within 0.05 x max |logit| of
     the f32 run fed the bf16 run's routes (the arithmetic alone), the f32
     run's own routes agreeing on >= 0.9 of the (token, k) routes of every
     layer on the prompts' tokens (pad rows apart: the kernel and the
     plain version differ there by design; flips counted and printed), the
     greedy tokens equal through phase 17's margin rule. (b) config #1's PT
     step (B4 x T1024, teachers in the step, save_gate) with the MoE
     decoder at full depth, a warm-up and 2 timed steps: ms a step, peak
     GiB, the MoE metrics, B1 64 / B2 32 / B3 32 / B4 48 a step; at 4
     layers (taps DP_TAPS) the bf16 step against the same student in f32
     over 3 updates: losses within 1e-2, step-1 gradients within 3e-2
     (relative Frobenius), and phase 16's two checks that the bounds can
     fail. (c) `--phase19-rank`: the finetune step at Phi3-mini widths cut to
     4 layers, B4 x T1024, ep 2 on two gloo ranks sharing the card (two
     experts a rank; they start and build their models while the f32 run,
     whose times are not read, holds the card where phase 18 did not make
     it, and step once it is over),
     held to the one-process step and an f32 run by phase 16's bounds (phase 18's `held_to_refs`), half the banks' bytes a rank,
     the routers and replicated parameters bit-equal across the ranks, B1
     8 / B2 4 / B3 4 a rank and step; then in the same ranks the step with
     offload_opt_state: JAX's plan puts every bank's mu and nu (the rank's
     two experts of them, 24 tensors) on the host and keeps the dense
     moments on the card, B1-B3 as the plain step, the losses, trainables
     and moments bit-equal to the plain ep 2 step's, pinned GiB a rank.
Phase 3 also holds B1-B3 at phase 12's recipe PT shape (Llama-3-8B, B4 x
T1024, GQA 32/8 H128, causal) against their plain versions, beside SDPA's
forward and backward and the bound, as at the training shape.

The ranks of phases 16-19 start at their phase's start, held: each imports
the port and opens its CUDA context, then waits for the parent's references
(DIR/start names the port). The profiles (phases 5-13) record the device's
activity only. Each phase writes a line `chip_smoke +T s: ...` to stderr.

The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}. Needs no network; builds into
visper_lm_tpu_torch/_build/.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 SIMT
L2_BYTES = 50e6                # H100: a rotation of weights must exceed it to find them cold

BATCH, PROMPT_LEN, NEW_TOKENS = 8, 768, 16     # new tokens cut for time
B6_DECODED = 32                # B6's decode case: the last of 32 decode steps (its measured shape)
TEXT_LENS = (155, 140, 121, 96, 77, 50, 31, 12)   # 13 sys + 600 image/task + text <= 768
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3    # bench.py's config #1 cell
# None: no remat, then every JAX policy (save_gate: bench.py's default)
REMAT_RUNS = (None, "none", "save_gate", "save_gate_flash", "save_flash", "save_mlp",
              "save_qkv_mlp", "save_mlp_q8")
REMAT_EXACT = REMAT_RUNS[1:-1]             # save_mlp_q8 changes the forward and its gradient
REMAT_STEPS = 1                            # timed steps per policy, after one warm-up
TRAINER_STEPS, TRAINER_ACCUM = 4, 2
SWIN_STAGES = ((512, 6), (128, 12), (32, 24), (8, 48))  # Swin-L at 768 px, micro-batch 2: (W, heads)
# bench_engine.py's defaults (int8 KV + w8a16 on top of these)
ENGINE = dict(num_slots=8, max_len=1536, decode_quantum=8, admit_group=8, admit_defer=4,
              prompt_bucket=128)
ENGINE_REQUESTS = 32
ENGINE_LAYERS = 2              # phase 9 runs phase 4's model cut in depth (time)
ENGINE_CHUNK = 256             # the chunked-prefill check's prefill_chunk
PROFILE_CHUNK = 4              # phases 5-6: tokens in a profiled decode chunk (time)
# phase 8b: the measurement tools
TOOLS_TEACHER_BATCH = 8        # bench_teacher_pattern's default batch (one timed pass)
TOOLS_SPEC_ITERS = 5           # speculative._bench's iterations (its default 20)
TOOLS_PIPELINE_IMAGES = 32     # bench_input_pipeline's --n (its default 192)
# phase 10: Llama-3-8B + CLIP-L through the user API
LLAMA3_KEYS = ("shape", "kernel", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
CHAT_IMAGES = ((480, 640), (336, 336), (768, 1024), (900, 200), (200, 900), (640, 480),
               (1024, 1024), (337, 509))                       # (H, W), uint8, seeded
CHAT_WORDS = (60, 44, 31, 75, 20, 52, 9, 68)                   # question lengths
LLAMA3_SPECIALS = {"<|begin_of_text|>": 128000, "<|start_header_id|>": 128006,
                   "<|end_header_id|>": 128007, "<|eot_id|>": 128009, "\n": 198}
VICUNA_SPECIALS = {"<s>": 1, "</s>": 2, "\n": 13}
FILE_LAYERS = 2                # the safetensors file round trip's depth (full width)
API_LAYERS = 4                 # phases 10-11's Llama-3-8B chat model, cut in depth (time)
VICUNA_LAYERS = 4              # Vicuna-7B at full width, cut in depth
# phase 11: anyres images (H, W) that select the grids 672x336, 336x672,
# 672x672 and 336x1008 of JAX's grid_pinpoints: base + 2, 2, 4, 3 tiles
ANYRES_IMAGES = ((500, 1000), (1000, 500), (900, 900), (1200, 400))
ANYRES_TILES = (3, 3, 5, 4)
# phase 12: training from the recipes
RECIPE_RECORDS, RECIPE_BATCH, RECIPE_STEPS = 16, 4, 3
RECIPE_GRAD_LAYER = 16          # the IFT layer whose weight gradients are held to the plain path
# phase 14: evaluation
EVAL_RECORDS, EVAL_BATCH, EVAL_NEW_TOKENS = 16, 8, 8   # per benchmark; chat batch; answer tokens
EVAL_LAYERS = 8                # phase 14's Llama-3-8B, cut in depth (time)
VIZ_TAPS = "d18-20_s10-18_g18-20"   # phase 13's tapped layers: gen at 3, not 9 (time)
VIZ_DEMO_STEPS = 5             # phase 13 (e): the packed gen bundle's denoise steps (time; (d) runs 25)
EVAL_IMAGES = ((480, 640), (336, 336), (600, 400), (256, 512))   # (H, W) of the records' PNGs
INCEPTION_IMAGES, INCEPTION_SIZE = 64, 512                       # FID features: the downscale path
# phase 15: the memory levers
MEM_LAYERS, MEM_BATCH, MEM_SEQ, MEM_STEPS = 2, 2, 1024, 3   # (b) parity at Llama-3-8B widths
MEM_RECORDS, MEM_WORDS = 16, (2900, 3200)   # (c) single-turn IFT records: a batch pads to T 4096
MEM_STREAM = 8                              # (c) --stream-grads segments
MEM_PROBE_BYTES = 1 << 30                   # (a) one copy of the bandwidth probe
MEM_HOST_MARGIN_GB = 10.0                   # (c) host memory beside the pinned state
# phase 16: data parallelism and ZeRO
DP_STEPS, DP_LR = 3, 1e-3      # a batch each; update 1 has lr 0 (warmup ratio 0), 2-3 DP_LR
DP_MODES = ("plain", "zero_frozen", "zero_params")   # (b)
DP_SAMPLE = 1 << 16            # elements of a tensor compared by sample (a fixed stride)
DP_LAYERS = 2                  # phases 16-17 (b): config #1 cut in depth (time)
DP_TAPS = "d1-2_s1-2_g1-2"     # its tapped layers (1-indexed, two a task), inside the cut
# phase 17: tensor parallelism
TP_NEW_TOKENS = 8              # (a) greedy tokens a row
TP_MODES = ("plain", "shard_teachers")   # (b)
TP_GEN_LAYERS = 8              # (a) Phi3-mini cut in depth (time)
TP_RECIPE_LAYERS, TP_RECIPE_STEPS = 2, 2   # (c) Llama-3-8B cut in depth, steps
TP_TIMEOUT = 420               # s for each spawn's whole run, from its release
HOLD_TIMEOUT = 900             # s a held rank waits for its release
TP_ENGINE_REQUESTS = 8         # (e) the first requests of bench_engine's request_mix
TP_SPEC_TOKENS, TP_BEAMS = 8, 2   # (f) new tokens at batch 1; beams
# phase 18: sequence and pipeline parallelism
SP_T, SP_LAYERS = 8192, 2      # (a)-(b): Llama-3-8B at B1 x T8192, sp 2; (b) cut in depth (time)
SP_STEPS = 2                   # (b)-(c): updates (the first has lr 0), then the loss after them
PP_LAYERS, PP_BATCH, PP_SEQ = 4, 4, 1024   # (c): Phi3-mini cut in depth, pp 2 x tp 2
SP_MOE_LAYERS, SP_MOE_BATCH = 2, 2   # (b): the MoE finetune step at Phi3-mini widths, B2 x SP_T
SP_PP_LEVERS = dict(offload_opt_state=True, stream_grads=2)   # (b)-(c) again with the levers
# phase 19: the MoE decoder (JAX's dry-run MoE on the bench model) and expert parallelism
MOE_EXPERTS, MOE_TOP_K = 4, 2
MOE_NEW_TOKENS = 16            # (a) greedy tokens a row at full depth
MOE_F32_LAYERS = 8             # (a) the depth held to an f32 run
MOE_PT_STEPS = 2               # (b) timed steps at full depth, after a warm-up
MOE_PT_LAYERS = 4              # (b) the depth held to an f32 run
MOE_EP_LAYERS = 4              # (c) Phi3-mini widths cut in depth, ep 2


T_START = time.perf_counter()


def progress(what: str) -> None:
    """One line on stderr with the seconds since this process started: a run
    stopped at its time limit shows how far it got."""
    sys.stdout.flush()
    print(f"chip_smoke +{time.perf_counter() - T_START:.1f} s: {what}", file=sys.stderr, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, reps: int) -> float:
    """Mean device time per call of the calls in fns, captured `reps` times
    over into one CUDA graph and replayed: no host time between launches."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()                                # warm-up on the capture stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            for fn in fns:
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def environment(build) -> str:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    if importlib.util.find_spec("triton") is not None:
        import triton

        print(f"triton {triton.__version__}")
    else:
        print("triton not installed")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout
    print("nvcc " + [ln for ln in nvcc.splitlines() if "release" in ln][0].strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    mem = host_memory()
    print(f"host memory: MemTotal {mem['mem_total_gb']:.1f} GB, MemAvailable "
          f"{mem['mem_available_gb']:.1f} GB, locked-memory limit (ulimit -l) {mem['memlock']}")
    return smi


def host_memory() -> dict:
    """/proc/meminfo's MemTotal and MemAvailable (GB) and RLIMIT_MEMLOCK."""
    import resource

    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            info[key] = int(val.split()[0]) * 1024
    soft, _ = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    return dict(mem_total_gb=info["MemTotal"] / 1e9, mem_available_gb=info["MemAvailable"] / 1e9,
                memlock="unlimited" if soft == resource.RLIM_INFINITY else f"{soft} bytes")


def main_path_batch(cfg):
    from visper_lm_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from visper_lm_tpu_torch.data.collate import build_splice_plan
    from visper_lm_tpu_torch.serve.generate import left_pad_plans

    rng = np.random.default_rng(0)
    vocab = cfg.decoder.vocab_size
    sys_ids = rng.integers(3, vocab, size=cfg.num_sys_tokens).tolist()
    plans = []
    for n in TEXT_LENS:
        ids = sys_ids + [IMAGE_TOKEN_INDEX] + rng.integers(3, vocab, size=n).tolist()
        plans.append(build_splice_plan(
            ids, None, PROMPT_LEN, num_image_tokens=cfg.num_image_tokens,
            num_task_tokens=cfg.distill.num_task_tokens,
            num_tasks=len(cfg.distill.task_order()),
        ))
    batch = left_pad_plans(plans, PROMPT_LEN)
    side = cfg.vision.image_size
    batch["images"] = rng.standard_normal((BATCH, side, side, 3)).astype(np.float32)
    return batch


def attention_pairs(b, t, causal, starts, lens) -> int:
    """Unmasked (query row, key) pairs per head this data needs: keys in
    [start, length) and, when causal, at or before the row."""
    rows = torch.arange(t)
    pairs = 0
    for i in range(b):
        hi = torch.clamp(rows + 1, max=lens[i]) if causal else torch.full((t,), lens[i])
        pairs += int(torch.clamp(hi - starts[i], min=0).sum())
    return pairs


def attention_flops(b, t, nq, h, causal, starts, lens) -> float:
    """Forward FLOPs this data needs: 4*H per unmasked pair and head (q.k, p.v)."""
    return 4.0 * h * nq * attention_pairs(b, t, causal, starts, lens)


def bound(nbytes: float, flops: float, dtype) -> dict:
    """The least time: bytes over the memory rate vs FLOPs over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def kernel_case(name, b, t, nq, nkv, h, dtype, causal, starts, lens, gen, fa, old=False):
    """Kernel vs plain version on one case; returns the measured record. With
    `old`, the mma.sync kernel is checked and timed beside the wgmma one."""
    dev = "cuda"
    q = torch.randn(b, t, nq, h, device=dev, generator=gen).to(dtype)
    k = torch.randn(b, t, nkv, h, device=dev, generator=gen).to(dtype)
    v = torch.randn(b, t, nkv, h, device=dev, generator=gen).to(dtype)
    st = torch.tensor(starts, device=dev)
    ln = torch.tensor(lens, device=dev)
    kw = dict(causal=causal, kv_starts=st, kv_lengths=ln)

    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = lse_err = 0.0
    for i in range(b):
        if starts[i] >= lens[i]:
            continue
        lo = starts[i] if causal else 0  # rows with at least one valid key
        err = max(err, (out[i, lo:].float() - ref[i, lo:]).abs().max().item())
        lse_err = max(lse_err, (lse[i, :, lo:] - lse_ref[i, :, lo:]).abs().max().item())
        if causal and lo > 0:
            check(bool(torch.all(out[i, :lo] == 0)), f"{name}: pad rows not zero")
            check(bool(torch.all(lse[i, :, :lo] == fa.NEG_INF)), f"{name}: pad lse not NEG_INF")
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    check(err <= tol, f"{name}: kernel vs plain max abs err {err} > {tol}")
    check(lse_err <= 1e-3, f"{name}: lse max abs err {lse_err} > 1e-3")

    def new_fn():
        return fa.flash_attention_fwd(q, k, v, **kw)

    def old_fn():
        return fa.flash_attention_fwd(q, k, v, kernel="mma_sync", **kw)

    extra = {}
    if old:
        out_o, lse_o = old_fn()
        torch.cuda.synchronize()
        err_o = max((out_o[i, (starts[i] if causal else 0):].float()
                     - ref[i, (starts[i] if causal else 0):]).abs().max().item()
                    for i in range(b) if starts[i] < lens[i])
        check(err_o <= tol, f"{name}: mma.sync kernel vs plain max abs err {err_o} > {tol}")
        old_a = cuda_ms(old_fn, 20)             # in turns: old, new, new, old
        ms = 0.5 * (cuda_ms(new_fn, 20) + cuda_ms(new_fn, 20))
        extra = dict(mma_sync_ms=0.5 * (old_a + cuda_ms(old_fn, 20)), mma_sync_max_abs_err=err_o)
    else:
        ms = cuda_ms(new_fn, 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v, **kw), 3)
    cols = torch.arange(t, device=dev)
    mask = (cols[None, :] >= st[:, None]) & (cols[None, :] < ln[:, None])
    mask = mask[:, None, None, :]
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=nq != nkv),
        20,
    )
    # least time: q, k, v read once, out and lse written once, vs this data's FLOPs
    flops = attention_flops(b, t, nq, h, causal, starts, lens)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + lse.numel() * 4
    rec = dict(
        case=name, shape=f"B{b} T{t} {nq}/{nkv} H{h} {str(dtype)[6:]} "
        f"{'causal' if causal else 'noncausal'}",
        kernel=fa.flash_fwd_kernel_for(dtype, h, t, causal), **extra,
        max_abs_err=err, lse_max_abs_err=lse_err, tol=tol, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(nbytes, flops, dtype),
        tflops=flops / ms * 1e-9, gbytes_s=nbytes / ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def bwd_case(name, b, t, nq, nkv, h, causal, starts, lens, gen, fa):
    """B2 (dq) and B3 (dk/dv) vs the plain backward in f32 on one bf16 case;
    returns the two measured records."""
    dev, dtype = "cuda", torch.bfloat16
    q, k, v = (torch.randn(b, t, n, h, device=dev, generator=gen).to(dtype) for n in (nq, nkv, nkv))
    dout = torch.randn(b, t, nq, h, device=dev, generator=gen).to(dtype)
    kw = dict(causal=causal, kv_starts=torch.tensor(starts, device=dev),
              kv_lengths=torch.tensor(lens, device=dev))
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    # the reference shares nothing with the kernels: its out and lse come
    # from the plain forward in f32
    qf, kf, vf = q.float(), k.float(), v.float()
    out_ref, lse_ref = fa.flash_attention_reference(qf, kf, vf, **kw)
    ref = fa.flash_attention_bwd_reference(qf, kf, vf, out_ref, lse_ref, dout.float(), **kw)
    del qf, kf, vf, out_ref, lse_ref
    err, mag, fro = {}, {}, {}
    dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    torch.cuda.synchronize()
    for gname, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        e = (got.float() - r).abs()
        err[gname] = e.max().item()
        mag[gname] = r.abs().max().item()
        fro[gname] = (e.norm() / r.norm()).item()
        excess = (e - (2e-2 + 1e-2 * r.abs())).max().item()
        print(f"bwd_case {name} {gname}: max abs err {err[gname]:.4g}, max |ref| "
              f"{mag[gname]:.4g}, relative Frobenius err {fro[gname]:.4g}")
        check(fro[gname] <= 1e-2, f"{name}: {gname} relative Frobenius err {fro[gname]} > 1e-2")
        check(excess <= 0, f"{name}: {gname} exceeds 2e-2 + 1e-2 x |ref| by {excess}")
    # every element is written once by one CTA: the same launch gives the same bytes
    for _ in range(20):
        check(torch.equal(fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw), dq),
              f"{name}: a repeated dq launch gave other bytes")
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        check(torch.equal(dk2, dk) and torch.equal(dv2, dv),
              f"{name}: a repeated dk/dv launch gave other bytes")
    del dq, dk, dv, ref

    def dq_fn():
        return fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, **kw)

    def dkv_fn():
        return fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, **kw)

    ms_dq, ms_dkv = cuda_ms(dq_fn, 10), cuda_ms(dkv_fn, 10)
    # the same launches as CUDA graphs: device time without the host between them
    device = {kname: graph_ms([fn], 10) for kname, fn in (("dq", dq_fn), ("dkv", dkv_fn))}
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, dout, **kw), 2)
    # yardstick: SDPA's backward with a boolean mask (dq, dk and dv in one call)
    cols = torch.arange(t, device=dev)
    mask = (cols[None, :] >= kw["kv_starts"][:, None]) & (cols[None, :] < kw["kv_lengths"][:, None])
    mask = mask[:, None, None, :]
    if causal:
        mask = mask & (cols[:, None] >= cols[None, :])[None, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=nq != nkv)
    go = dout.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), go, retain_graph=True), 10)
    del o
    # least time: inputs read once (q, k, v, dout, lse, delta), outputs written once,
    # vs 2*H FLOPs per product and unmasked pair: dq 3 products, dk/dv 4
    pairs = attention_pairs(b, t, causal, starts, lens) * nq
    e = q.element_size()
    in_bytes = (q.numel() + k.numel() + v.numel() + dout.numel()) * e + 2 * lse.numel() * 4
    shape = f"B{b} T{t} {nq}/{nkv} H{h} bf16 {'causal' if causal else 'noncausal'}"
    recs = []
    for kname, ms, nbytes, flops, errs in (
        ("dq", ms_dq, in_bytes + q.numel() * e, 6.0 * h * pairs, ("dq",)),
        ("dkv", ms_dkv, in_bytes + (k.numel() + v.numel()) * e, 8.0 * h * pairs, ("dk", "dv")),
    ):
        rec = dict(
            case=f"{name}_{kname}", shape=shape,
            kernel=fa.flash_bwd_kernel_for(dtype, h, t, t), max_abs_err=max(err[x] for x in errs),
            max_abs_ref=max(mag[x] for x in errs), rel_fro_err=max(fro[x] for x in errs),
            tol="rel Frobenius 1e-2, |err| <= 2e-2 + 1e-2 x |ref|", ms=ms,
            device_ms=device[kname], plain_ms=plain_ms, library_ms=library_ms,
            **bound(nbytes, flops, dtype), tflops=flops / ms * 1e-9,
        )
        print("kernel_case " + json.dumps(rec))
        recs.append(rec)
    return recs


def window_case(stage, w, heads, shifted, gen, wa, swin):
    """B4 vs its plain version at one Swin-L stage shape (N 144, D 32, bf16),
    q/k/v as the strided views of a packed projection the Swin block passes:
    within 2e-2 of the plain version, the same launch 20 times the same
    bytes. The kernel and SDPA are timed as CUDA graphs (a stage-3 or
    stage-4 launch is shorter than its host time), in turns: new, SDPA,
    SDPA, new."""
    dev, n, d, ws = "cuda", 144, 32, 12
    nw = w // 2                                  # windows per image (micro-batch 2)
    qkv = torch.randn(w, n, 3, heads, d, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn(heads, n, n, device=dev, generator=gen)
    mask = None
    if shifted:
        side = int(round(nw ** 0.5)) * ws
        mask = torch.as_tensor(swin._shift_attn_mask(side, side, ws, ws // 2), device=dev)
    scale = d ** -0.5
    name = f"window_stage{stage + 1}{'_shifted' if shifted else ''}"
    kernel = wa.window_attn_kernel_for(n, d)

    def new_fn():
        return wa.window_attention_kernel(q, k, v, bias, mask, scale)

    out = new_fn()
    ref = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    check(err <= 2e-2, f"{name}: max abs err {err} > 2e-2")
    # every output element is written once by one CTA: the same launch gives the same bytes
    for _ in range(20):
        check(torch.equal(new_fn(), out), f"{name}: a repeated launch gave other bytes")
    del out, ref
    # yardstick: SDPA with the float bias (+ shift mask tiled over the windows)
    attn = bias[None].expand(w, heads, n, n)
    if mask is not None:
        attn = attn + mask.repeat(w // nw, 1, 1)[:, None]
    attn = attn.to(torch.bfloat16).contiguous()

    def lib_fn():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=attn, scale=scale)

    t_new, t_lib = graph_ms([new_fn], 20), graph_ms([lib_fn], 20)
    t_lib2, t_new2 = graph_ms([lib_fn], 20), graph_ms([new_fn], 20)
    ms = 0.5 * (t_new + t_new2)
    eager_ms = cuda_ms(new_fn, 20)
    plain_ms = cuda_ms(lambda: wa.window_attention_plain(q, k, v, bias, mask, scale), 3)
    nbytes = 4 * q.numel() * 2 + bias.numel() * 4 + (0 if mask is None else mask.numel() * 4)
    flops = 4.0 * n * n * d * w * heads
    plan = wa.window_attn_plan(w, heads, n, d, nw if shifted else 0,
                               torch.cuda.get_device_properties(0).multi_processor_count)
    rec = dict(
        case=name, shape=f"W{w} heads{heads} N{n} D{d} bf16", kernel=kernel,
        plan=plan._asdict(), max_abs_err=err, tol=2e-2, ms=ms, eager_ms=eager_ms,
        plain_ms=plain_ms, library_ms=0.5 * (t_lib + t_lib2),
        library="SDPA, bf16 bias (+ mask) per window", timing="ms, library_ms: CUDA graphs",
        **bound(nbytes, flops, torch.bfloat16), gbytes_s=nbytes / ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def w4_case(name, m, din, dout, gen, qm, param, awq=False, group=128):
    """B5 vs its plain version at one linear's shape: weights drawn as the
    decoder's init (U(+-1/sqrt(din)), bf16) and quantized by the port's int4
    quantizer; with awq, the rows are AWQ-scaled and x takes q4_in_scale first,
    as the linear does."""
    dev = "cuda"
    bound_w = din ** -0.5
    w = ((torch.rand(din, dout, device=dev, generator=gen) * 2 - 1) * bound_w).to(torch.bfloat16)
    rms = torch.rand(din, device=dev, generator=gen) * 4 + 0.05 if awq else None
    qd = param.quantize_linear_int4(w, group, rms)
    pk, sc = qd["weight_q4p"], qd["q4_scale"]
    del w
    x = torch.randn(m, din, device=dev, generator=gen).to(torch.bfloat16)
    if awq:
        x = x * qd["q4_in_scale"].to(x.dtype)
    out = qm.w4_matmul(x, pk, sc, group)
    ref = qm.w4_matmul_reference(x.float(), pk, sc, group)
    torch.cuda.synchronize()
    e = (out.float() - ref).abs()
    err, mag, fro = e.max().item(), ref.abs().max().item(), (e.norm() / ref.norm()).item()
    del ref, e
    check(fro <= 1e-2, f"{name}: relative Frobenius err {fro} > 1e-2")
    check(err <= 2e-2 * mag, f"{name}: max abs err {err} > 2e-2 x {mag}")
    iters = 50 if m <= 16 else 10
    def new_fn():
        return qm.w4_matmul(x, pk, sc, group)

    def old_fn():
        return qm.w4_matmul(x, pk, sc, group, kernel="mma_sync")

    old_a = cuda_ms(old_fn, iters)              # in turns: old, new, new, old
    ms = 0.5 * (cuda_ms(new_fn, iters) + cuda_ms(new_fn, iters))
    mma_sync_ms = 0.5 * (old_a + cuda_ms(old_fn, iters))
    plain_ms = cuda_ms(lambda: qm.w4_matmul_reference(x, pk, sc, group), 2)
    # yardstick: one torch.matmul with the same weight already dequantized to
    # bf16 (four times the weight bytes)
    w_deq = (qm.unpack_int4(pk).to(torch.bfloat16).reshape(-1, group, dout)
             * sc[:, None, :].to(torch.bfloat16)).reshape(din, dout)
    library_ms = cuda_ms(lambda: torch.matmul(x, w_deq), iters)
    small = {}
    if m <= 16:
        # device times without the host between launches, warm and cold in L2
        copies = max(8, -(-3 * int(L2_BYTES) // pk.numel()))
        pks = [pk.clone() for _ in range(copies)]
        scs = [sc.clone() for _ in range(copies)]

        def cold(kern):
            return graph_ms([lambda a=a, b=b: qm.w4_matmul(x, a, b, group, kernel=kern)
                             for a, b in zip(pks, scs)], 2)

        small = dict(device_ms=graph_ms([new_fn], 20), cold_ms=cold(None),
                     mma_sync_device_ms=graph_ms([old_fn], 20), mma_sync_cold_ms=cold("mma_sync"),
                     library_device_ms=graph_ms([lambda: torch.matmul(x, w_deq)], 20))
        del pks, scs
        lib_copies = max(8, -(-3 * int(L2_BYTES) // (2 * w_deq.numel())))
        w_deqs = [w_deq.clone() for _ in range(lib_copies)]
        small["library_cold_ms"] = graph_ms([lambda w=w: torch.matmul(x, w) for w in w_deqs], 2)
        small["cold_copies"] = copies
        del w_deqs
        # the split-K sum runs in a fixed order: the same launch gives the same bytes
        first = new_fn()
        for _ in range(20):
            check(torch.equal(new_fn(), first), f"{name}: a repeated launch gave other bytes")
    del w_deq
    # least time: x, packed, scales read once, out written once, vs 2 M din dout
    nbytes = x.numel() * 2 + pk.numel() + sc.numel() * 4 + m * dout * 2
    flops = 2.0 * m * din * dout
    rec = dict(
        case=name, shape=f"M{m} din{din} dout{dout} group{group}{' awq' if awq else ''}",
        kernel=qm.w4_kernel_for(m, din, dout, group),
        max_abs_err=err, max_abs_ref=mag, rel_fro_err=fro,
        tol="rel Frobenius 1e-2, max abs 2e-2 x max|ref|", ms=ms, mma_sync_ms=mma_sync_ms,
        plain_ms=plain_ms, library_ms=library_ms,
        library="torch.matmul on the bf16-dequantized weight", **small,
        **bound(nbytes, flops, torch.bfloat16), tflops=flops / ms * 1e-9,
        gbytes_s=nbytes / small.get("cold_ms", ms) * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def decode_case(name, b, nq, nkv, h, s, quant, starts, lens, gen, da, quantize_head_vectors):
    """B6 vs its plain version on one single-token case: q (B, 1, Nq, H) bf16,
    a head-major (B, Nkv, S, H) cache in bf16 or int8 + per-vector scales."""
    dev = "cuda"
    q = torch.randn(b, 1, nq, h, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, nkv, s, h, device=dev, generator=gen)
    v = torch.randn(b, nkv, s, h, device=dev, generator=gen)
    if quant:
        (k, ks), (v, vs) = quantize_head_vectors(k), quantize_head_vectors(v)
        ks, vs = ks[..., 0], vs[..., 0]
        kd, vd = (k.float() * ks[..., None]).to(q.dtype), (v.float() * vs[..., None]).to(q.dtype)
    else:
        k, v, ks, vs = k.to(q.dtype), v.to(q.dtype), None, None
        kd, vd = k, v
    st = torch.tensor(starts, device=dev)
    ln = torch.tensor(lens, device=dev)
    kw = dict(kv_lengths=ln, kv_starts=st)
    ref = da.decode_attention_reference(q.float(), k, v, ks, vs, **kw)
    live = [i for i in range(b) if starts[i] < lens[i]]
    errs = {}
    for kern in ("split", "serial"):
        out = da.decode_attention(q, k, v, ks, vs, kernel=kern, **kw)
        torch.cuda.synchronize()
        e = out[live].float() - ref[live]
        errs[kern] = (e.abs().max().item(), (e.norm() / ref[live].norm()).item())
        check(errs[kern][1] <= 1e-2, f"{name}: {kern} relative Frobenius err {errs[kern][1]} > 1e-2")
        check(errs[kern][0] <= 5e-3, f"{name}: {kern} max abs err {errs[kern][0]} > 5e-3")
        for i in set(range(b)) - set(live):
            check(bool(torch.all(out[i] == 0)), f"{name}: {kern}: fully masked row {i} is not 0")
    err, fro = errs["split"]

    def new_fn():
        return da.decode_attention(q, k, v, ks, vs, **kw)

    # the splits merge in split order: the same launch gives the same bytes
    first = new_fn()
    for _ in range(20):
        check(torch.equal(new_fn(), first), f"{name}: a repeated launch gave other bytes")
    eager_ms = cuda_ms(new_fn, 100)
    plain_ms = cuda_ms(lambda: da.decode_attention_reference(q, k, v, ks, vs, **kw), 5)
    # yardstick: SDPA with a boolean mask over the bf16 (or dequantized) cache
    cols = torch.arange(s, device=dev)
    mask = ((cols[None, :] >= st[:, None]) & (cols[None, :] < ln[:, None]))[:, None, None, :]
    qt = q.transpose(1, 2)

    def sdpa(kc, vc):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask, enable_gqa=nq != nkv)

    # device times without the host between launches: warm (one cache) and
    # cold (in turn over copies that together exceed the L2), in turns:
    # serial, split, library, library, split, serial
    cache_bytes = 2 * k.numel() * k.element_size() + (2 * ks.numel() * 4 if quant else 0)
    copies = max(2, -(-3 * int(L2_BYTES) // cache_bytes))
    caches = [tuple(None if x is None else x.clone() for x in (k, v, ks, vs)) for _ in range(copies)]
    lib_copies = max(2, -(-3 * int(L2_BYTES) // (2 * kd.numel() * 2)))
    libs = [(kd.clone(), vd.clone()) for _ in range(lib_copies)]

    def timed(kern):
        warm = graph_ms([lambda: da.decode_attention(q, k, v, ks, vs, kernel=kern, **kw)], 20)
        cold = graph_ms([lambda c=c: da.decode_attention(q, *c, kernel=kern, **kw) for c in caches], 4)
        return warm, cold

    def timed_lib():
        return (graph_ms([lambda: sdpa(kd, vd)], 20),
                graph_ms([lambda c=c: sdpa(*c) for c in libs], 4))

    t_old, t_new, t_lib = timed("serial"), timed("split"), timed_lib()
    t_lib2, t_new2, t_old2 = timed_lib(), timed("split"), timed("serial")
    del caches, libs
    device_ms, cold_ms = 0.5 * (t_new[0] + t_new2[0]), 0.5 * (t_new[1] + t_new2[1])
    # least time: q read, out written, and the cache rows (and scales) of the
    # valid positions read once, which is all this data needs; 4H FLOPs per
    # query head and valid position
    valid = sum(max(min(lens[i], s) - max(starts[i], 0), 0) for i in range(b))
    nbytes = 2 * q.numel() * 2 + valid * nkv * h * k.element_size() * 2
    nbytes += valid * nkv * 8 if quant else 0
    flops = 4.0 * h * nq * valid
    span, splits, rnd = da.decode_split_plan(b, nkv, s, h, k.element_size())
    rec = dict(
        case=name, shape=f"B{b} {nq}/{nkv} H{h} S{s} {'int8' if quant else 'bf16'} cache",
        plan=dict(span=span, splits=splits, round=rnd, ctas=b * nkv * splits,
                  dynamic_smem_bytes=da.decode_split_smem_bytes(rnd, h, k.element_size(), nq // nkv)),
        max_abs_err=err, max_abs_ref=ref[live].abs().max().item(), rel_fro_err=fro,
        serial_max_abs_err=errs["serial"][0],
        tol="rel Frobenius 1e-2, max abs 5e-3", ms=cold_ms, cold_ms=cold_ms, device_ms=device_ms,
        eager_ms=eager_ms, serial_cold_ms=0.5 * (t_old[1] + t_old2[1]),
        serial_device_ms=0.5 * (t_old[0] + t_old2[0]), plain_ms=plain_ms,
        library_ms=0.5 * (t_lib[1] + t_lib2[1]), library_device_ms=0.5 * (t_lib[0] + t_lib2[0]),
        library="SDPA, boolean mask, bf16 (dequantized) cache", cold_copies=copies,
        **bound(nbytes, flops, torch.bfloat16), gbytes_s=nbytes / cold_ms * 1e-6,
    )
    print("kernel_case " + json.dumps(rec))
    return rec


def profile_window(name: str, fn, top: int = 10, match=()) -> dict:
    """Device time of one call of fn by kernel (torch.profiler), and the
    device's idle share of the same call's wall time timed without the
    profiler (the profiler slows the host). For each string in `match`, also
    the device time and launches of the kernels whose name contains it. The
    profiler records the device's activity only: recording every host op as
    well cost 37-53 s of host time for a decode chunk's 45,000-64,000
    launches; it records both only where that finds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_host = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile {name}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"idle share {1 - busy_us / wall_us:.3f}, {sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        print(f"profile {name}:   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:100]}")
    out = dict(wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3, idle_share=1 - busy_us / wall_us,
               kernels=sum(e.count for e in kernels))
    progress(f"profile {name}: {time.perf_counter() - t_host:.1f} s on the host")
    for key in match:
        hit = [e for e in kernels if key in e.key]
        out[key] = dict(ms=sum(e.self_device_time_total for e in hit) / 1e3,
                        launches=sum(e.count for e in hit))
        print(f"profile {name}: kernels matching '{key}': {out[key]['ms']:.3f} ms "
              f"in {out[key]['launches']} launches")
    return out


def short_chunk(generator, tokens: int = PROFILE_CHUNK):
    """A view of `generator` whose decode chunk is `tokens` long, for a
    profile: the profiler's host cost grows with the launches it records
    (15.9 / 22.1 s for phases 5-6's 16-token chunks on a slow host)."""
    import dataclasses

    view = copy.copy(generator)
    view.gen_cfg = dataclasses.replace(generator.gen_cfg, decode_chunk=tokens)
    return view


def loss_and_grads(loss_fn, model, batch, teachers, params):
    """One forward and backward without an update: (loss, grads of params)."""
    total, _ = loss_fn(model, batch, teachers)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return float(total.detach()), grads


def grad_agreement(names, grads_a, grads_b):
    """(min cosine, its tensor, tensors compared) over the gradients that are
    not zero on both sides."""
    min_cos, min_name, n_cmp = 1.0, None, 0
    for n, ga, gb in zip(names, grads_a, grads_b):
        if ga is None or gb is None:
            continue
        ga, gb = ga.float().flatten(), gb.float().flatten()
        if gb.norm() == 0 and ga.norm() == 0:
            continue
        cos = float(ga @ gb / (ga.norm() * gb.norm()).clamp(min=1e-30))
        n_cmp += 1
        if cos < min_cos:
            min_cos, min_name = cos, n
    return min_cos, min_name, n_cmp


def trainer_phase(cfg, model, teachers, tbatch, reset_counts, counts):
    """Phase 8: remat policies at B4 x T1024, trainer.train with accumulation,
    a checkpoint and a resume, the chunked cross-entropy at B8, master
    weights at B1. Returns the record printed as `trainer_path`."""
    import dataclasses
    import os
    import shutil

    from visper_lm_tpu_torch.models.decoder import REMAT_POLICIES
    from visper_lm_tpu_torch.models.teachers import make_teacher_fn
    from visper_lm_tpu_torch.tools.bench import bench_batch
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train import train_step as train_step_mod
    from visper_lm_tpu_torch.train.train_step import make_loss_fn, make_train_step, uses_chunked_ce
    from visper_lm_tpu_torch.train.trainer import TrainerConfig, train
    from visper_lm_tpu_torch.utils.diagnostics import decoder_params, teacher_flops, train_step_flops

    d = cfg.decoder
    tfn = make_teacher_fn(cfg)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=1000, stage="pretrain")
    n_swin = sum(teachers["swin"].cfg.depths)
    out = {}

    def expected(policy, micro_batches=1, batch=TRAIN_BATCH):
        # a launch per decoder layer, and the recompute runs the flash forward
        # again unless the policy keeps its output; B4 once per Swin block and
        # teacher micro-batch of 2
        fwd = 1 if policy is None or "flash_out" in REMAT_POLICIES[policy] else 2
        per = dict(flash_fwd=fwd * d.num_layers, flash_bwd_dq=d.num_layers,
                   flash_bwd_dkv=d.num_layers, window_attn=n_swin * batch // 2)
        return {k: v * micro_batches for k, v in per.items()}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # remat: no remat (phase 7's step), full remat, save_gate; at B4 x T1024
    remat = {}
    for policy in REMAT_RUNS:
        name = policy or "no_remat"
        step = make_train_step(cfg, opt_cfg, model, teacher_fn=tfn, teacher_params=teachers,
                               remat=policy is not None, remat_policy=policy)
        step(tbatch)                            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(REMAT_STEPS):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(tbatch)              # ends in a host read of the metrics
            ms.append((time.perf_counter() - t0) * 1e3)
            c = counts()
            check(c == expected(policy), f"remat {name} step {i + 2}: launches {c}, expected "
                  f"{expected(policy)}")
            check(math.isfinite(metrics["loss"]), f"remat {name}: loss {metrics['loss']}")
        remat[name] = dict(step_ms=ms, mean_step_ms=sum(ms) / len(ms),
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=c,
                           loss=metrics["loss"])
        print(f"remat {name}: {json.dumps(remat[name])}")
        if policy == "save_gate":               # a profile costs seconds: bench.py's default only
            prof = profile_window("train_step_save_gate", lambda: step(tbatch), top=15,
                                  match=("flash_fwd", "flash_bwd", "window_attn_stream"))
            remat[name].update(busy_ms=prof["busy_ms"], idle_share=prof["idle_share"])
        del step
        release()
    check(remat["save_gate"]["peak_gib"] < remat["no_remat"]["peak_gib"],
          f"save_gate's peak {remat['save_gate']['peak_gib']:.2f} GiB is not below no remat's "
          f"{remat['no_remat']['peak_gib']:.2f}")
    out["remat"] = remat

    # each exact policy's loss and gradients against the no-remat step's, at B1
    b1 = {k: torch.as_tensor(v[:1]).cuda() for k, v in tbatch.items()}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    ref_loss, ref_grads = loss_and_grads(make_loss_fn(cfg, teacher_fn=tfn, remat=False),
                                         model, b1, teachers, params)
    out["remat_parity"] = {}
    for policy in REMAT_EXACT:
        loss, grads = loss_and_grads(make_loss_fn(cfg, teacher_fn=tfn, remat=True, remat_policy=policy),
                                     model, b1, teachers, params)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        min_cos, min_name, n_cmp = grad_agreement(names, grads, ref_grads)
        out["remat_parity"][policy] = dict(loss=loss, no_remat_loss=ref_loss, rel=rel,
                                           min_grad_cosine=min_cos, tensors=n_cmp)
        print(f"remat {policy} vs no remat at B1: loss {loss:.6f} vs {ref_loss:.6f} (rel "
              f"{rel:.3g}), min grad cosine {min_cos:.6f} ({min_name}) over {n_cmp} tensors")
        check(rel <= 1e-3, f"remat {policy}: loss differs by {rel:.3g} > 1e-3")
        check(min_cos >= 0.999, f"remat {policy}: grad cosine {min_cos} < 0.999 for {min_name}")
        del grads
    del ref_grads
    release()

    # trainer.train: save_gate, accumulation 2, a checkpoint at step 2, then a
    # resume from it to step 4
    root = Path(__file__).resolve().parent / "tmp" / "chip_smoke_trainer"
    shutil.rmtree(root, ignore_errors=True)
    requested = []

    def data_iter(epoch, skip_batches=0):
        requested.append((epoch, skip_batches))
        for i in range(skip_batches, TRAINER_STEPS * TRAINER_ACCUM):
            yield bench_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, True, seed=100 + 2 * i)

    def records(run):
        with open(root / run / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    per_step = expected("save_gate", TRAINER_ACCUM)
    tcfg = TrainerConfig(output_dir=str(root / "full"), max_steps=TRAINER_STEPS, save_steps=2,
                         grad_accum_steps=TRAINER_ACCUM, remat_policy="save_gate", resume=False)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train(cfg, opt_cfg, tcfg, model, data_iter, teacher_fn=tfn, teacher_params=teachers)
        full_s = time.perf_counter() - t0
        launches = counts()
        want = {k: v * TRAINER_STEPS for k, v in per_step.items()}
        check(state.step == TRAINER_STEPS, f"trainer ran {state.step} steps")
        check(launches == want, f"trainer launches {launches}, expected {want}")
        full = records("full")
        check([r["step"] for r in full] == list(range(1, TRAINER_STEPS + 1)), f"logged {full}")
        del state
        release()
        resume_dir = root / "resume" / "checkpoints"
        resume_dir.mkdir(parents=True)
        shutil.copytree(root / "full" / "checkpoints" / "2", resume_dir / "2", copy_function=os.link)
        requested.clear()
        reset_counts()
        t0 = time.perf_counter()
        state = train(cfg, opt_cfg, dataclasses.replace(tcfg, output_dir=str(root / "resume"),
                                                        resume=True),
                      model, data_iter, teacher_fn=tfn, teacher_params=teachers)
        resume_s = time.perf_counter() - t0
        resumed_launches = counts()
        want = {k: v * (TRAINER_STEPS - 2) for k, v in per_step.items()}
        check(resumed_launches == want, f"resumed launches {resumed_launches}, expected {want}")
        check(requested == [(0, 2 * TRAINER_ACCUM)], f"the resume asked the stream for {requested}")
        resumed = records("resume")
        check([r["step"] for r in resumed] == [3, 4], f"the resume logged {resumed}")
        diffs = {}
        for r in resumed:
            ref = full[r["step"] - 1]["loss"]
            diffs[r["step"]] = abs(r["loss"] - ref) / abs(ref)
            print(f"trainer step {r['step']}: resumed loss {r['loss']:.7f}, uninterrupted "
                  f"{ref:.7f}, relative difference {diffs[r['step']]:.3g}")
            check(diffs[r["step"]] <= 1e-5, f"resumed step {r['step']} loss differs by "
                  f"{diffs[r['step']]:.3g} > 1e-5")
        del state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    # steps 2 and 4: no checkpoint is written inside their logged intervals
    sps = [full[i]["steps_per_sec"] for i in (1, 3)]
    examples = TRAIN_BATCH * TRAINER_ACCUM
    flops = train_step_flops(cfg, examples, TRAIN_SEQ) + teacher_flops(examples)
    # train_step_flops is JAX's nominal count: 6 P per token for the decoder.
    # In PT the decoder is frozen, so its weight gradients (2 P) never run.
    pt_flops = flops - 2.0 * decoder_params(cfg) * examples * TRAIN_SEQ
    mean_sps = sum(sps) / len(sps)
    out["trainer"] = dict(
        remat_policy="save_gate", grad_accum_steps=TRAINER_ACCUM, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAINER_STEPS, run_s=full_s, resume_run_s=resume_s, losses=[r["loss"] for r in full],
        resumed_losses=[r["loss"] for r in resumed], resumed_rel_diff=diffs,
        step_ms=[1e3 / x for x in sps], examples_per_s=examples * mean_sps,
        mfu=flops * mean_sps / PEAK_FLOPS[torch.bfloat16], flops_per_step=flops,
        mfu_pt=pt_flops * mean_sps / PEAK_FLOPS[torch.bfloat16], pt_flops_per_step=pt_flops,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
        launches_per_step=per_step, resumed_launches=resumed_launches,
    )
    print("trainer " + json.dumps(out["trainer"]))

    # the chunked cross-entropy: one step at B8 x T1024
    b8 = {k: torch.as_tensor(v).cuda()
          for k, v in bench_batch(cfg, 8, TRAIN_SEQ, True, seed=50).items()}
    check(uses_chunked_ce(cfg, 8, TRAIN_SEQ), "B8 x T1024 does not take the chunked cross-entropy")
    step = make_train_step(cfg, opt_cfg, model, teacher_fn=tfn, teacher_params=teachers,
                           remat_policy="save_gate")
    loss_c, grads_c = loss_and_grads(step.loss_fn, model, b8, teachers, params)
    # the reference: the same loss on the full f32 logits (JAX's switch turned off)
    switch = train_step_mod.uses_chunked_ce
    train_step_mod.uses_chunked_ce = lambda *a: False
    try:
        loss_f, grads_f = loss_and_grads(
            make_loss_fn(cfg, teacher_fn=tfn, remat_policy="save_gate"), model, b8, teachers, params)
    finally:
        train_step_mod.uses_chunked_ce = switch
    rel = abs(loss_c - loss_f) / abs(loss_f)
    min_cos, min_name, n_cmp = grad_agreement(names, grads_c, grads_f)
    del grads_c, grads_f
    release()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    metrics = step(b8)
    b8_ms = (time.perf_counter() - t0) * 1e3
    b8_launches = counts()
    check(b8_launches == expected("save_gate", batch=8),
          f"B8 step launches {b8_launches}, expected {expected('save_gate', batch=8)}")
    out["chunked_ce"] = dict(loss=loss_c, full_logits_loss=loss_f, rel=rel, min_grad_cosine=min_cos,
                             tensors=n_cmp, step_ms=b8_ms, step_loss=metrics["loss"],
                             launches=b8_launches,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print("chunked_ce " + json.dumps(out["chunked_ce"]))
    check(rel <= 1e-3, f"chunked CE loss differs from the full logits' by {rel:.3g} > 1e-3")
    check(min_cos >= 0.999, f"chunked CE grad cosine {min_cos} < 0.999 for {min_name}")
    check(math.isfinite(metrics["loss"]), f"B8 step loss {metrics['loss']}")
    del step, b8
    release()

    # f32 master weights at B1: after two updates (update 1 has lr 0) every
    # bf16 trainable is its master copy rounded
    opt_m = dataclasses.replace(opt_cfg, warmup_ratio=0.0, master_weights=True)
    step = make_train_step(cfg, opt_m, model, teacher_fn=tfn, teacher_params=teachers,
                           remat_policy="save_gate")
    before = {n: p.detach().clone() for n, p in step.trainable.items()}
    for _ in range(2):
        step(b1)
    master = step.optimizer.master
    off = sum(int((p != master[n].to(p.dtype)).sum()) for n, p in step.trainable.items())
    moved = sum(int((p != before[n]).sum()) for n, p in step.trainable.items())
    total = sum(p.numel() for p in step.trainable.values())
    out["master_weights"] = dict(params=total, moved=moved, off_rounded_master=off,
                                 dtypes=sorted({str(p.dtype) for p in step.trainable.values()}))
    print("master_weights " + json.dumps(out["master_weights"]))
    check(off == 0, f"{off} trainable values are not their master copy rounded")
    check(moved > 0, "no trainable moved in two updates")
    del step, before, master
    release()
    return out


def tools_phase(teachers, wa, smi: str) -> dict:
    """Phase 8b: `tools/bench_teacher_pattern` on phase 7's teachers (bf16:
    the per-image rows within ROW_BOUND of the batched rows, Swin-L's B4
    once a block a call), `serve/speculative._bench` at its full-width
    decoders with TOOLS_SPEC_ITERS iterations, `tools/bench_input_pipeline`
    on TOOLS_PIPELINE_IMAGES images. Returns their records."""
    from visper_lm_tpu_torch.serve import speculative
    from visper_lm_tpu_torch.tools import bench_input_pipeline
    from visper_lm_tpu_torch.tools import bench_teacher_pattern as pattern

    out = {}
    images = pattern.noise_images(TOOLS_TEACHER_BATCH)
    wa.launches = 0
    rec = pattern.measure(teachers, images, (336, 224, 768), iters=1)
    # a warm-up and one timed pass of each pattern: a launch a Swin-L block a call
    want = 2 * sum(teachers["swin"].cfg.depths) * (len(images) + 1)
    check(wa.launches == want, f"teacher pattern: B4 launched {wa.launches} times, expected {want}")
    bound = pattern.ROW_BOUND[torch.bfloat16]
    check(rec["max_rel_diff"] <= bound, f"teacher pattern: per-image rows differ from the batched "
          f"rows by {rec['max_rel_diff']:.4g} > {bound}")
    out["teacher_pattern"] = dict(rec, b4_launches=wa.launches, row_bound=bound)
    print("teacher_pattern " + json.dumps(out["teacher_pattern"]) + f" [{smi}]")
    release_cuda()
    spec = speculative._bench(["--iters", str(TOOLS_SPEC_ITERS)])
    check(all(math.isfinite(spec[k]) and spec[k] > 0 for k in
              ("draft_step_ms", "verify_chunk_ms", "target_step_ms"))
          and 0 <= spec["value"] < math.inf, f"speculative _bench: {spec}")
    out["speculative"] = spec
    release_cuda()
    pipe = bench_input_pipeline.main(["--n", str(TOOLS_PIPELINE_IMAGES)])
    check(pipe["value"] > 0 and math.isfinite(pipe["paced_achieved_ms"]),
          f"input pipeline: {pipe}")
    out["input_pipeline"] = pipe
    return out


def logits_close(name, got, ref):
    """Logits with the kernels vs the plain path: within 0.05 x max|ref|
    (bf16 through every layer); returns the measured difference and share."""
    diff = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"{name}: max abs diff {diff:.4g}, max |logit| {scale:.4g} (share {diff / scale:.4g}), "
          f"argmax agree {bool(got.argmax(-1).eq(ref.argmax(-1)).all())}")
    check(bool(torch.isfinite(got).all()), f"{name}: logits not finite")
    check(diff <= 0.05 * scale, f"{name}: logits differ by {diff} > 0.05 x {scale}")
    return dict(max_abs_diff=diff, max_abs_logit=scale, share=diff / scale)


def int_offset_decode(generator, cache, token, offsets, n: int) -> torch.Tensor:
    """Greedy decode of n tokens with a Python-int q_offset, as the decode
    chunk ran before its slot lived on the device: the reference the
    device-slot chunk must equal bit for bit."""
    dec = generator.decoder
    toks = []
    with torch.no_grad():
        for i in range(n):
            slot = generator.prompt_len + i
            out = dec(dec.embed_tokens(token[:, None]), positions=(slot - offsets)[:, None],
                      kv_starts=offsets, cache=cache, q_offset=slot)
            token = out["logits"][:, 0].argmax(-1)
            toks.append(token)
    return torch.stack(toks)


def cut_depth(model, cfg, act_rms, layers: int):
    """(model, cfg, act_rms) with the decoder's first `layers` blocks: a
    shallow copy sharing every parameter with `model` (nothing is copied)."""
    import dataclasses

    dcfg = dataclasses.replace(cfg.decoder, num_layers=layers)
    dec = copy.copy(model.decoder)
    dec._modules = dict(model.decoder._modules)
    dec.blocks = torch.nn.ModuleList(list(model.decoder.blocks)[:layers])
    dec.cfg = dcfg
    cut = copy.copy(model)
    cut._modules = dict(model._modules)
    cut.decoder = dec
    rms = {k: v[:layers] if v.dim() == 2 and v.shape[0] == cfg.decoder.num_layers else v
           for k, v in act_rms.items()}
    return cut, dataclasses.replace(cfg, decoder=dcfg), rms


def engine_phase(cfg, model, act_rms, fa, qm) -> dict:
    """Phase 9: the continuous-batching Engine at bench_engine.py's defaults
    (int8 KV + w8a16), the batch loop beside it, prefix caching, chunked
    prefill, the speculative engine, SpeculativeDecoder, BeamSearchDecoder
    and an int4 engine run. Returns the record printed as `engine_path`."""
    import dataclasses
    import warnings

    from visper_lm_tpu_torch.models.decoder import Decoder
    from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder
    from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator, left_pad_plans
    from visper_lm_tpu_torch.serve.speculative import SpeculativeDecoder
    from visper_lm_tpu_torch.tools.bench_engine import request_mix

    d = cfg.decoder
    ecfg = EngineConfig(**ENGINE, kv_quant=True, weight_quant=True)
    work = request_mix(cfg, np.random.default_rng(0), ENGINE_REQUESTS, ecfg.max_len)
    per_forward = 7 * d.num_layers + 1
    out = {}

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def requests(spec, arrivals=None):
        reqs = []
        for i, (plan, im, mn) in enumerate(spec):
            r = Request(plan=plan, images=im, max_new_tokens=mn, uid=i)
            if arrivals is not None:
                r.stream_callback = (lambda uid: lambda tok: arrivals.setdefault(
                    uid, time.perf_counter()))(i)
            reqs.append(r)
        return reqs

    # the main path: bench_engine.py's 32 requests through the engine, and
    # through the batch loop (bench_engine.py measurement 2: a Generator per
    # batch of 8, each batch decoding to its longest request), in turns:
    # engine, loop, loop, engine (both host-bound: one call, one card)
    t0 = time.perf_counter()
    eng = Engine(model, cfg, ecfg, device="cuda")
    longest = max(p.seq_length for p, _, _ in work)
    prompt_pad = -(-longest // 128) * 128
    g_cfg = GenerationConfig(max_new_tokens=127, decode_chunk=8, kv_quant=True, weight_quant=True)
    gen = Generator(model, cfg, g_cfg, ecfg.num_slots, prompt_pad, device="cuda")
    torch.cuda.synchronize()
    print(f"engine and batch-loop init (w8a16 copies of the decoder, {ecfg.num_slots} x "
          f"{ecfg.max_len} int8 cache) {time.perf_counter() - t0:.2f} s")
    out["prefill_logits"] = logits_close(
        "engine prefill logits kernels vs plain",
        eng.prefill_logits(requests(work[:1])[0]),
        eng.prefill_logits(requests(work[:1])[0], use_kernel=False))

    def engine_pass(spec_list):
        """One run of the engine over spec_list, checked; its record. torch's
        sync-debug warnings are counted by the call stack that raised them."""
        eng.stats = {k: 0 for k in eng.stats}
        fa.launches = 0
        arrivals = {}
        sites = collections.Counter()

        def on_warning(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" in str(message):
                stack = traceback.extract_stack()[:-1]
                where = "engine" if any(Path(f.filename).name == "engine.py" for f in stack) else "other"
                sites[where + ": " + " < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                                for f in reversed(stack[-3:]))] += 1

        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            done = eng.run(requests(spec_list, arrivals))
            run_s = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("default")
        st = dict(eng.stats)
        n = len(spec_list)
        check(len(done) == n, f"engine finished {len(done)} of {n}")
        by_uid = {r.uid: r for r in done}
        check(all(len(by_uid[i].output_ids) == spec_list[i][2] for i in range(n)),
              "an engine request did not get exactly its max_new_tokens")
        check(all(0 <= t < d.vocab_size for r in done for t in r.output_ids),
              "engine token out of vocab")
        check(all(r is None for r in eng.slot_req) and not eng.queue, "a slot stayed occupied")
        engine_syncs = sum(c for k, c in sites.items() if k.startswith("engine:"))
        check(st["host_syncs"] == st["steps"] == engine_syncs,
              f"engine synced {st['host_syncs']} times by its count and {engine_syncs} by "
              f"torch's over {st['steps']} quanta: {dict(sites)}")
        check(fa.launches == d.num_layers * st["admit_dispatches"],
              f"flash kernel launched {fa.launches} times over {st['admit_dispatches']} "
              "prefill dispatches")
        ttft = sorted((arrivals[r.uid] - r.submit_t) * 1e3 for r in done)
        n_tok = sum(len(r.output_ids) for r in done)
        return dict(
            seconds=run_s, requests_per_s=n / run_s, tokens=n_tok, tokens_per_s=n_tok / run_s,
            ttft_mean_ms=sum(ttft) / n, ttft_p90_ms=ttft[int(0.9 * (n - 1))],
            ms_per_step=run_s / st["steps"] * 1e3,
            occupancy=st["slot_steps"] / (st["steps"] * ecfg.num_slots * ecfg.decode_quantum),
            flash_launches=fa.launches, engine_sync_warnings=engine_syncs,
            sync_sites=dict(sites), stats=st,
        ), {r.uid: r.output_ids for r in done}

    def loop_pass(spec_list):
        """The batch loop over spec_list: (tokens, seconds)."""
        t0 = time.perf_counter()
        tokens = 0
        for i in range(0, len(spec_list), ecfg.num_slots):
            chunk = spec_list[i:i + ecfg.num_slots]
            tokens += sum(c[2] for c in chunk)
            chunk = chunk + chunk[-1:] * (ecfg.num_slots - len(chunk))
            batch = left_pad_plans([c[0] for c in chunk], prompt_pad)
            batch["images"] = np.concatenate([c[1] for c in chunk])
            logits, cache = gen.prefill(batch)
            token = logits.argmax(-1)
            offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
            rng = torch.Generator(device="cuda")
            step = torch.zeros((), dtype=torch.long, device="cuda")
            for _ in range(-(-(max(c[2] for c in chunk) - 1) // 8)):
                token = gen._decode_chunk(cache, token, step, offs, rng)[-1]
                step = step + 8
            token.cpu()
        return tokens, time.perf_counter() - t0

    warm = [(p, im, 8) for p, im, _ in work[: ecfg.num_slots]]
    eng.run(requests(warm))                                         # warm-ups
    loop_pass(warm)
    torch.cuda.reset_peak_memory_stats()
    runs = {"engine": [], "batch_loop": []}
    for turn in ("engine", "batch_loop", "batch_loop", "engine"):
        if turn == "engine":
            rec, plain_tokens = engine_pass(work)
            print("engine_main " + json.dumps(rec))
        else:
            tok, sec = loop_pass(work)
            rec = dict(seconds=sec, tokens=tok, tokens_per_s=tok / sec,
                       requests_per_s=ENGINE_REQUESTS / sec)
            print("batch_loop " + json.dumps(rec))
        runs[turn].append(rec)
    out["engine"] = dict(runs["engine"][0], requests=ENGINE_REQUESTS,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["turns"] = {k: [dict((m, r[m]) for m in ("seconds", "tokens_per_s", "requests_per_s"))
                        for r in v] for k, v in runs.items()}
    for rec in runs["engine"]:
        rec.pop("stats")
    out["engine_second"] = runs["engine"][1]
    out["batch_loop"] = dict(prompt_pad=prompt_pad, requests=ENGINE_REQUESTS)
    for k in ("tokens_per_s", "requests_per_s"):
        out["engine"][f"mean_{k}"] = sum(r[k] for r in runs["engine"]) / 2
        out["batch_loop"][f"mean_{k}"] = sum(r[k] for r in runs["batch_loop"]) / 2
    print("engine_vs_batch_loop " + json.dumps(out["turns"]))

    # where the time goes: an engine step with every slot busy (one quantum)
    # beside a decode chunk of the batch loop (8 tokens)
    for i, (p, im, _) in enumerate(work[: ecfg.num_slots]):
        eng.submit(Request(plan=p, images=im, max_new_tokens=10 ** 6, uid=("busy", i)))
    eng.step()                                  # admits them
    out["step_profile"] = profile_window("engine_step", eng.step)
    batch = left_pad_plans([c[0] for c in work[: ecfg.num_slots]], prompt_pad)
    batch["images"] = np.concatenate([c[1] for c in work[: ecfg.num_slots]])
    logits, cache = gen.prefill(batch)
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    out["loop_chunk_profile"] = profile_window("batch_loop_chunk", lambda: gen._decode_chunk(
        cache, logits.argmax(-1), torch.zeros((), dtype=torch.long, device="cuda"), offs,
        torch.Generator(device="cuda")))
    del gen, cache, logits
    release()

    # prefix caching and chunked prefill, on a one-slot bf16-cache engine
    side = Engine(model, cfg, EngineConfig(num_slots=1, max_len=ecfg.max_len,
                                           prompt_bucket=ecfg.prompt_bucket,
                                           prefill_chunk=ENGINE_CHUNK), device="cuda")
    plan, im, _ = work[0]
    head = eng._chunk_plan(plan, 0, plan.seq_length - 40)
    tail = eng._chunk_plan(plan, plan.seq_length - 40, plan.seq_length)
    full = side.prefill_logits(Request(plan=plan, images=im))
    fa.launches = 0
    handle = side.prefill_prefix(head, images=im)
    check(fa.launches == d.num_layers, f"prefill_prefix launched the flash kernel {fa.launches} times")
    suffix_logits, _, _ = side._run_suffix(handle, tail, None, None)
    out["prefix"] = logits_close("prefix handle + suffix vs full prefill", suffix_logits, full)
    req = Request(plan=plan, images=im)
    n_chunks = 0
    while side._needs_chunk(req):
        side._advance_chunk(req)
        n_chunks += 1
    check(n_chunks >= 1, f"a {plan.seq_length}-token prompt took no chunk of {ENGINE_CHUNK}")
    chunk_logits, _, _ = side._run_suffix(req.prefix, req.plan, None, req.image_features)
    out["chunked"] = dict(logits_close(f"chunked prefill ({n_chunks} chunks of {ENGINE_CHUNK}) vs "
                                       "single shot",
                                       chunk_logits, full), chunks=n_chunks)
    del side, handle, req, eng
    release()

    # the speculative engine against the plain engine's tokens
    sub = work[: ecfg.num_slots]
    spec = Engine(model, cfg, dataclasses.replace(ecfg, spec_k=4, spec_quantum=4), device="cuda")
    t0 = time.perf_counter()
    spec_done = spec.run(requests(sub))
    spec_s = time.perf_counter() - t0
    agree = sum(r.output_ids == plain_tokens[r.uid] for r in spec_done)
    same = sum(a == b for r in spec_done for a, b in zip(r.output_ids, plain_tokens[r.uid]))
    out["spec_engine"] = dict(
        requests=len(sub), seconds=spec_s, identical_requests=agree,
        token_agreement=same / sum(len(r.output_ids) for r in spec_done),
        proposed=spec.stats["spec_proposed"], accepted=spec.stats["spec_accepted"],
        steps=spec.stats["steps"], host_syncs=spec.stats["host_syncs"])
    print("engine_spec " + json.dumps(out["spec_engine"]))
    check(all(len(r.output_ids) == r.max_new_tokens for r in spec_done), "spec engine token counts")
    del spec
    release()

    # SpeculativeDecoder: Phi3's decoder as the target, its first half of the
    # blocks with the same embedding, norm and head as the draft; BeamSearchDecoder
    target = model.decoder
    with torch.device("meta"):
        draft = Decoder(dataclasses.replace(d, num_layers=d.num_layers // 2))
    draft.embed_tokens, draft.final_norm, draft.lm_head = (
        target.embed_tokens, target.final_norm, target.lm_head)
    draft.blocks = torch.nn.ModuleList(target.blocks[:d.num_layers // 2])
    prompt = np.random.default_rng(1).integers(3, d.vocab_size - 10, size=128).tolist()
    t0 = time.perf_counter()
    s_out, s_stats = SpeculativeDecoder(target, draft.eval(), k=4, max_len=512).generate(
        prompt, max_new_tokens=32)
    out["speculative"] = dict(seconds=time.perf_counter() - t0, tokens=len(s_out),
                              acceptance_rate=s_stats.acceptance_rate,
                              tokens_per_target_pass=s_stats.tokens_per_target_pass,
                              iterations=s_stats.iterations)
    check(len(s_out) == 32, f"SpeculativeDecoder gave {len(s_out)} tokens")
    t0 = time.perf_counter()
    b_out, b_score = BeamSearchDecoder(target, num_beams=4, max_len=512).generate(
        prompt, max_new_tokens=32)
    out["beam"] = dict(seconds=time.perf_counter() - t0, tokens=len(b_out), score=b_score)
    check(len(b_out) == 32 and math.isfinite(b_score), f"beam search: {len(b_out)} tokens, {b_score}")
    print("engine_decoders " + json.dumps(dict(speculative=out["speculative"], beam=out["beam"])))
    del draft
    release()

    # one engine run at int4 (AWQ calibration of phase 6): B5 in every linear
    q4 = Engine(model, cfg, dataclasses.replace(ecfg, weight_quant="int4", calibration=act_rms),
                device="cuda")
    qm.launches = 0
    t0 = time.perf_counter()
    q4_done = q4.run(requests(sub))
    q4_s = time.perf_counter() - t0
    st4 = q4.stats
    forwards = st4["admit_dispatches"] + st4["steps"] * ecfg.decode_quantum
    check(qm.launches == per_forward * forwards,
          f"w4 kernel launched {qm.launches} times in the int4 engine run, expected "
          f"{per_forward} x {forwards} forwards")
    check(all(len(r.output_ids) == r.max_new_tokens for r in q4_done), "int4 engine token counts")
    out["int4_engine"] = dict(requests=len(sub), seconds=q4_s, w4_launches=qm.launches,
                              forwards=forwards,
                              tokens_per_s=sum(len(r.output_ids) for r in q4_done) / q4_s)
    print("engine_int4 " + json.dumps(out["int4_engine"]))
    del q4
    release()
    return out


class WordTokenizer:
    """A whitespace tokenizer with the HF surface the api uses (the card has
    no `transformers`). Special strings and newlines are tokens of their own;
    a word "w<k>" is id k, which is how decode writes every other id, and any
    other word is a crc32 hash above the special range: decode then encode
    gives the ids back, so a chat session finds its cached history."""

    def __init__(self, vocab_size: int, specials: dict, bos: int, eos: int, first_word: int):
        import re

        self.vocab_size, self.first_word = vocab_size, first_word
        self.specials = dict(specials)
        self.bos_token_id, self.eos_token_id = bos, eos
        self._split = re.compile("(" + "|".join(map(re.escape, self.specials)) + ")")

    def __call__(self, text):
        import types
        import zlib

        ids = [self.bos_token_id]
        top = min([v for v in self.specials.values() if v >= self.first_word] + [self.vocab_size])
        for part in self._split.split(text):
            if part in self.specials:
                ids.append(self.specials[part])
                continue
            for w in part.split():
                if w[0] == "w" and w[1:].isdigit() and int(w[1:]) < self.vocab_size:
                    ids.append(int(w[1:]))
                else:
                    ids.append(self.first_word + zlib.crc32(w.encode()) % (top - self.first_word))
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=False):
        names = {v: k for k, v in self.specials.items()}
        return " ".join(
            ("" if skip_special_tokens and names[i] != "\n" else names[i]) if i in names
            else f"w{i}" for i in ids)


def api_phase(fa, qm, da, param, gen):
    """Phase 10: Llama-3-8B + CLIP-ViT-L/14-336 through the user API
    (visper_lm_tpu_torch/api.py) at full width and depth: the export/import
    round trip in memory, chat() four ways, serve(), a ChatSession, the
    safetensors file round trip at 2 layers, Vicuna-7B at 4 layers. Returns
    the record printed as `api_path` (with the B1 and B5 cases at Llama-3's
    shapes), and what phase 11 reuses: the model, its config, the tokenizer,
    the questions and the images."""
    import dataclasses
    import shutil

    from visper_lm_tpu_torch.api import VisperModel, config_from_hf_json
    from visper_lm_tpu_torch.checkpoint.hf_export import export_vlm, save_hf_checkpoint
    from visper_lm_tpu_torch.checkpoint.hf_import import import_vlm
    from visper_lm_tpu_torch.config import config_to_json, llama3_clip_vlm, vicuna_clip_vlm
    from visper_lm_tpu_torch.data.mm_utils import tokenizer_image_token
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.serve.engine import EngineConfig
    from visper_lm_tpu_torch.serve.generate import GenerationConfig
    from visper_lm_tpu_torch.tools.bench_decode import measure as decode_measure

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def bit_equal(a, b, what):
        check(sorted(a) == sorted(b), f"{what}: the tensor names differ")
        bad = [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
               or not torch.equal(a[k], b[k])]
        check(not bad, f"{what}: {len(bad)} tensors differ, e.g. {bad[:3]}")

    out = {}
    cfg = llama3_clip_vlm(distill=True, image_aspect_ratio="pad")   # LLaVA-1.5's padding
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=API_LAYERS))
    d = cfg.decoder
    per_forward = 7 * d.num_layers + 1
    tok = WordTokenizer(d.vocab_size, LLAMA3_SPECIALS, bos=128000, eos=128009, first_word=256)
    rng = np.random.default_rng(10)
    questions = [" ".join(f"w{i}" for i in rng.integers(256, 128000, size=n)) for n in CHAT_WORDS]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in CHAT_IMAGES]

    # the chat batch (host only: templates, tokenizer, image preprocessing)
    t0 = time.perf_counter()
    batch = VisperModel(cfg=cfg, model=None, tokenizer=tok).chat_batch(questions, images)
    out["chat_batch_s"] = time.perf_counter() - t0
    pad_to = batch["text_ids"].shape[1]
    offsets = batch["pad_offsets"].tolist()
    print(f"llama3 chat batch: {len(questions)} prompts padded to {pad_to}, offsets {offsets}, "
          f"{len(images)} images {CHAT_IMAGES} preprocessed in {out['chat_batch_s']:.2f} s")

    # B1 and B5 at the shapes Llama-3-8B gives them here
    out["b1"] = kernel_case("llama3_prefill", len(questions), pad_to, d.num_heads, d.num_kv_heads,
                            d.head_dim, torch.bfloat16, True, offsets, [pad_to] * len(questions),
                            gen, fa)
    out["b5"] = {f"{lname}_M{m}": w4_case(f"llama3_{lname}_M{m}", m, din, dout, gen, qm, param)
                 for lname, din, dout in (("gate_up", d.hidden_size, d.mlp_dim),
                                          ("down", d.mlp_dim, d.hidden_size))
                 for m in (len(questions), len(questions) * pad_to)}
    release()

    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=10)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama3 init_vlm {time.perf_counter() - t0:.1f} s, {n_params / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # 1. export_vlm -> import_vlm in memory: a renaming (CLIP's qkv split and
    # joined again): every tensor comes back bit-equal
    t0 = time.perf_counter()
    own = model.state_dict()
    bit_equal(import_vlm(export_vlm(model, cfg), cfg), own, "in-memory export -> import")
    out["memory_round_trip"] = dict(tensors=len(own), values=n_params,
                                    seconds=time.perf_counter() - t0)
    print(f"export_vlm -> import_vlm in memory: {len(own)} tensors bit-equal "
          f"({out['memory_round_trip']['seconds']:.2f} s)")
    del own
    release()

    # 2. chat(): bf16, the default (bf16 by JAX's rule: it quantizes by
    # itself only on a TPU), int8 KV + w8a16, int8 KV + int4
    chats, answers_by_mode = {}, {}
    for mode, kvq, wq in (("bf16", False, False), ("bf16_default", None, None),
                          ("int8", True, True), ("int4", True, "int4")):
        vm = VisperModel(cfg=cfg, model=model, tokenizer=tok)
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = qm.launches = 0
        t0 = time.perf_counter()
        answers = vm.chat(questions, images, max_new_tokens=NEW_TOKENS, kv_quant=kvq,
                          weight_quant=wq)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        b1, b5 = fa.launches, qm.launches
        generator = list(vm._gen_cache.values())[-1]
        forwards = b5 // per_forward
        check(b1 == d.num_layers, f"chat {mode}: B1 launched {b1} times, expected {d.num_layers}")
        if mode == "int4":
            check(b5 == per_forward * forwards and (forwards - 1) % generator.gen_cfg.decode_chunk == 0,
                  f"chat int4: B5 launched {b5} times, not {per_forward} per forward")
        else:
            check(b5 == 0, f"chat {mode}: B5 launched {b5} times")
        check(len(answers) == len(questions) and all(isinstance(a, str) for a in answers),
              f"chat {mode}: answers {answers}")
        answers_by_mode[mode] = answers
        if mode == "bf16_default":
            check(not generator.gen_cfg.kv_quant and answers == answers_by_mode["bf16"],
                  "chat with the default quantization is not the bf16 chat")
        timing = decode_measure(generator, batch, generator.gen_cfg.max_new_tokens, warm=False)
        logits_k = generator.prefill(batch)[0]
        logits_p = generator.prefill(batch, use_kernel=False)[0]
        close = logits_close(f"llama3 chat {mode} first-token logits kernels vs plain",
                             logits_k, logits_p)
        del logits_k, logits_p
        chats[mode] = dict(first_call_s=first_s, **timing, peak_gib=peak / 2**30,
                           resident_before_gib=resident / 2**30, b1_launches=b1,
                           b5_launches=b5, kernel_vs_plain=close, sample=answers[0][:80])
        if mode == "bf16":
            logits, cache = generator.prefill(batch)
            offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
            chats[mode]["profile"] = dict(
                prefill=profile_window("llama3_prefill", lambda: generator.prefill(batch)),
                decode_chunk=profile_window("llama3_decode_chunk", lambda: generator._decode_chunk(
                    cache, logits.argmax(-1), 0, offs, torch.Generator(device="cuda"))))
            del logits, cache
            square = VisperModel(cfg=dataclasses.replace(cfg, image_aspect_ratio="square"),
                                 model=model, tokenizer=tok)
            fa.launches = 0
            t0 = time.perf_counter()
            sq = square.chat(questions, images, max_new_tokens=NEW_TOKENS, kv_quant=False,
                             weight_quant=False)
            chats[mode]["square_s"] = time.perf_counter() - t0
            check(len(sq) == len(questions) and fa.launches == d.num_layers,
                  f"chat square: {len(sq)} answers, {fa.launches} B1 launches")
            del square
        print(f"chat_{mode} " + json.dumps(chats[mode]))
        del vm, generator
        release()
    out["chat"] = chats

    # 3. serve(): the same prompts through the engine (int8 KV + w8a16);
    # its prefill logits held against chat()'s Generator, row by row
    vm = VisperModel(cfg=cfg, model=model, tokenizer=tok)
    fa.launches = 0
    t0 = time.perf_counter()
    served = vm.serve(questions, images, max_new_tokens=NEW_TOKENS, kv_quant=True,
                      weight_quant=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(len(served) == len(questions) and fa.launches > 0 and fa.launches % d.num_layers == 0,
          f"serve: {len(served)} answers, {fa.launches} B1 launches")
    serve_rec = dict(seconds=serve_s, b1_launches=fa.launches,
                     prefill_dispatches=fa.launches // d.num_layers)
    chat_gen = vm._generator(GenerationConfig(kv_quant=True, weight_quant=True),
                             len(questions), pad_to)
    chat_logits = chat_gen.prefill(batch)[0]
    engine = vm.engine(EngineConfig(num_slots=1, max_len=pad_to, kv_quant=True), weight_quant=True)
    worst = None
    for i, req in enumerate(vm.requests(questions, images)):
        rec = logits_close(f"serve request {i} prefill logits vs chat's row", engine.prefill_logits(
            req)[0], chat_logits[i])
        worst = rec if worst is None or rec["share"] > worst["share"] else worst
    serve_rec["logits_vs_chat_worst"] = worst
    print("serve " + json.dumps(serve_rec))
    out["serve"] = serve_rec
    del engine, chat_gen, chat_logits
    release()

    # 4. ChatSession (int8 KV + w8a16): three turns on one image; turns 2
    # and 3 prefill only their own tokens (the engine's count)
    session = vm.chat_session(images[0], kv_quant=True, weight_quant=True)
    turns = []
    for i, q in enumerate((questions[1], "w17 w23 w99 w5", "w4242 w77")):
        conv = session.conv.copy()
        conv.append_message(conv.roles[0], q if i else "<image>\n" + q)
        conv.append_message(conv.roles[1], None)
        full = len(tokenizer_image_token(conv.get_prompt(), tok))
        before, cached = session.engine.stats["prefill_tokens"], len(session._ids)
        t0 = time.perf_counter()
        answer = session.ask(q, max_new_tokens=16)
        turn_s = time.perf_counter() - t0
        prefilled = session.engine.stats["prefill_tokens"] - before
        turns.append(dict(seconds=turn_s, prompt_tokens=full, prefilled=prefilled,
                          cached_before=cached, answer=answer[:60]))
        if i:
            check(prefilled == full - cached and prefilled < full,
                  f"session turn {i + 1} prefilled {prefilled} of {full} tokens "
                  f"({cached} cached)")
    print("chat_session " + json.dumps(turns))
    out["session"] = turns
    del session, vm
    release()

    # 5. the safetensors file round trip at full width and 2 layers, into
    # the repo's tmp/ (gitignored), removed after
    cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(d, num_layers=FILE_LAYERS))
    model2 = init_vlm(cfg2, device="cuda", seed=11)
    ckpt = Path(__file__).resolve().parent / "tmp" / "llama3_2layer"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_hf_checkpoint(str(ckpt), model2, cfg2)
        write_s = time.perf_counter() - t0
        size = (ckpt / "model.safetensors").stat().st_size
        t0 = time.perf_counter()
        loaded = VisperModel.from_hf_checkpoint(str(ckpt), tokenizer=tok, dtype=None,
                                                 device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        check(config_to_json(loaded.cfg) == config_to_json(cfg2), "file round trip: config differs")
        bit_equal(loaded.model.state_dict(), model2.state_dict(), "file round trip")
        del loaded
        # a LLaVA-style config.json: the HF fields, no visper_config
        hand = dict(architectures=["LlavaLlamaForCausalLM"], model_type="llava_llama",
                    vocab_size=d.vocab_size, hidden_size=d.hidden_size,
                    intermediate_size=d.mlp_dim, num_hidden_layers=FILE_LAYERS,
                    num_attention_heads=d.num_heads, num_key_value_heads=d.num_kv_heads,
                    rope_theta=d.rope_theta, rms_norm_eps=d.norm_eps,
                    max_position_embeddings=8192, max_sequence_length=4096,
                    mm_vision_tower="openai/clip-vit-large-patch14-336", mm_hidden_size=1024,
                    mm_projector_type="mlp2x_gelu", image_aspect_ratio="pad",
                    mm_patch_merge_type="flat", mm_use_im_patch_token=False,
                    mm_use_im_start_end=False, torch_dtype="bfloat16")
        (ckpt / "config.json").write_text(json.dumps(hand, indent=1))
        plain = dataclasses.replace(cfg2, distill=None)
        check(config_to_json(config_from_hf_json(hand)) == config_to_json(plain),
              "config_from_hf_json of the LLaVA-style config.json differs")
        llava = VisperModel.from_hf_checkpoint(str(ckpt), tokenizer=tok, dtype=None,
                                                 device="cuda")
        ref = model2.state_dict()
        bit_equal(llava.model.state_dict(), {k: ref[k] for k in llava.model.state_dict()},
                  "LLaVA-style load")
        del llava, ref
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["file_round_trip"] = dict(layers=FILE_LAYERS, bytes=size, write_s=write_s, read_s=read_s,
                                  write_gb_s=size / write_s / 1e9, read_gb_s=size / read_s / 1e9)
    print("file_round_trip " + json.dumps(out["file_round_trip"]))
    del model2
    release()

    # 6. Vicuna-7B at full width, 4 layers: the vicuna_v1 template
    vcfg = vicuna_clip_vlm(image_aspect_ratio="pad")
    vcfg = dataclasses.replace(vcfg, decoder=dataclasses.replace(vcfg.decoder,
                                                                 num_layers=VICUNA_LAYERS))
    vtok = WordTokenizer(vcfg.decoder.vocab_size, VICUNA_SPECIALS, bos=1, eos=2, first_word=259)
    vvm = VisperModel(cfg=vcfg, model=init_vlm(vcfg, device="cuda", seed=12), tokenizer=vtok)
    prompt = vvm.build_prompt(questions[0])
    check(prompt.startswith("A chat between a curious user") and prompt.endswith(" ASSISTANT:")
          and vvm.stop_strings() == ["</s>"], f"vicuna prompt {prompt[:80]!r}")
    fa.launches = 0
    t0 = time.perf_counter()
    vans = vvm.chat(questions[:2], images[:2], max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    check(len(vans) == 2 and fa.launches == VICUNA_LAYERS,
          f"vicuna chat: {len(vans)} answers, {fa.launches} B1 launches")
    out["vicuna"] = dict(layers=VICUNA_LAYERS, seconds=time.perf_counter() - t0,
                         b1_launches=fa.launches, eos_ids=vvm._eos_ids(), sample=vans[0][:60])
    print("vicuna " + json.dumps(out["vicuna"]))
    del vvm
    release()
    return out, dict(model=model, cfg=cfg, tok=tok, questions=questions, images=images)


def swap_vision(model, cfg, seed: int):
    """A VLM of `cfg` on the card sharing `model`'s decoder, task tokens, heads
    and logit scales (the Llama-3-8B weights are made once): a ConvNeXt
    config gets a seeded trunk (every block's gamma from N(0, 0.1^2), so each
    block's branch counts in bf16) and projector; otherwise the CLIP tower
    and projector are shared too. image_newline, where the config has one,
    is drawn from N(0, 0.02^2)."""
    from visper_lm_tpu_torch.models.convnext import init_convnext_
    from visper_lm_tpu_torch.models.vlm import VLM
    from visper_lm_tpu_torch.utils.param import init_weights_

    with torch.device("meta"):
        view = VLM(cfg)
    for name in ("decoder", "special_tokens", "heads", "logit_scales"):
        setattr(view, name, getattr(model, name))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.use_convnext_tower:
        view.vision_tower = init_convnext_(view.vision_tower.to_empty(device="cuda"), gen)
        view.mm_projector = view.mm_projector.to_empty(device="cuda")
        init_weights_(view.mm_projector, gen)
        with torch.no_grad():
            for stage in view.vision_tower.stages:
                for block in stage.blocks:
                    block.gamma.normal_(0.0, 0.1, generator=gen)
    else:
        view.vision_tower, view.mm_projector = model.vision_tower, model.mm_projector
    if view.image_newline is not None:
        drawn = torch.randn(cfg.decoder.hidden_size, device="cuda", generator=gen)
        view.image_newline = torch.nn.Parameter(
            (0.02 * drawn).to(model.decoder.embed_tokens.weight.dtype))
    return view.eval()


def vision_phase(api_state, fa, qm, wa, gen, smi: str) -> dict:
    """Phase 11: the vision side at Llama-3-8B through the user API (phase
    10's decoder, tokenizer, questions and images): the ConvNeXt-XXL tower at
    768 px (tower output shape, bf16 against f32 on the same weights), a
    ConvNeXt chat and an anyres chat (tiles padded to the batch's most,
    spatial_unpad, JAX's grid_pinpoints), B1 at both chats' prefill shapes
    against its plain version, one S2 tower call at CLIP-L; then, with the
    Llama-3 model released, one PT step of bench.py's --tower convnext cell
    (Phi3-mini, config #1, B4 x T1024, teachers, save_gate). Returns the
    record printed as `vision_path`."""
    import dataclasses

    from visper_lm_tpu_torch.api import VisperModel
    from visper_lm_tpu_torch.config import llama3_clip_vlm, phi3_clip_vlm, with_convnext_tower
    from visper_lm_tpu_torch.models.convnext import convnext_tower_features
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vit import clip_tower_features_s2
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.tools.bench import bench_batch
    from visper_lm_tpu_torch.tools.bench_decode import measure as decode_measure
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_train_step
    from visper_lm_tpu_torch.utils.diagnostics import convnext_flops

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    model, tok = api_state["model"], api_state["tok"]
    questions, images = api_state["questions"], api_state["images"]
    d = model.cfg.decoder
    out = dict(card=smi)

    def chat_run(name, vm, qs, ims):
        """One chat in bf16 with B1's launches counted, timed warm after, and
        its first-token logits with the kernels against the plain path."""
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = qm.launches = 0
        t0 = time.perf_counter()
        answers = vm.chat(qs, ims, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        b1, b5 = fa.launches, qm.launches
        peak = torch.cuda.max_memory_allocated()
        check(b1 == d.num_layers and b5 == 0, f"{name}: B1 {b1} launches (want {d.num_layers}), "
              f"B5 {b5}")
        check(len(answers) == len(qs) and all(isinstance(a, str) for a in answers),
              f"{name}: answers {answers}")
        generator = list(vm._gen_cache.values())[-1]
        check(not generator.gen_cfg.kv_quant and not generator.gen_cfg.weight_quant,
              f"{name}: the default chat is not bf16")
        batch = vm.chat_batch(qs, ims)
        timing = decode_measure(generator, batch, generator.gen_cfg.max_new_tokens, warm=False)
        logits_k = generator.prefill(batch)[0]
        logits_p = generator.prefill(batch, use_kernel=False)[0]
        close = logits_close(f"{name} first-token logits kernels vs plain", logits_k, logits_p)
        del logits_k, logits_p, generator
        vm._gen_cache.clear()
        rec = dict(first_call_s=first_s, **timing, peak_gib=peak / 2**30,
                   resident_before_gib=resident / 2**30, b1_launches=b1,
                   prompt_len=int(batch["text_ids"].shape[1]), kernel_vs_plain=close,
                   sample=answers[0][:80], card=smi)
        return rec, batch

    # 1. ConvNeXt-XXL at 768 px with the Llama-3-8B decoder
    t_phase = time.perf_counter()
    cx_cfg = with_convnext_tower(llama3_clip_vlm(distill=True))
    t0 = time.perf_counter()
    cx = swap_vision(model, cx_cfg, seed=21)
    torch.cuda.synchronize()
    tower_params = sum(p.numel() for p in cx.vision_tower.parameters())
    print(f"convnext tower on the card {time.perf_counter() - t0:.1f} s, "
          f"{tower_params / 1e6:.1f} M params (bf16) [{smi}]")
    check(abs(tower_params - 843.4e6) < 1e6, f"ConvNeXt-XXL has {tower_params} params")
    vm = VisperModel(cfg=cx_cfg, model=cx, tokenizer=tok)
    t0 = time.perf_counter()
    pixels = torch.from_numpy(vm.chat_batch(questions, images)["images"]).cuda()
    prep_s = time.perf_counter() - t0
    check(tuple(pixels.shape) == (len(images), 768, 768, 3), f"convnext pixels {pixels.shape}")
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        feats = convnext_tower_features(cx.vision_tower, pixels)
        tower_peak = torch.cuda.max_memory_allocated() - resident
        tower_ms = cuda_ms(lambda: convnext_tower_features(cx.vision_tower, pixels), 3)
        tower32 = copy.deepcopy(cx.vision_tower).float()
        feats32 = convnext_tower_features(tower32, pixels)
    check(tuple(feats.shape) == (len(images), 576, 3072) and feats.dtype == torch.bfloat16,
          f"convnext tower output {tuple(feats.shape)} {feats.dtype}")
    check(bool(torch.isfinite(feats).all()), "convnext tower output not finite")
    rel = float((feats.float() - feats32).norm() / feats32.norm())
    del tower32, feats32
    flops = convnext_flops(cx_cfg.convnext) * len(images)
    # where the trunk's time goes: depthwise convs, GEMMs, the elementwise rest
    with torch.no_grad():
        prof = profile_window("convnext_tower", lambda: convnext_tower_features(
            cx.vision_tower, pixels), top=12, match=("conv", "nvjet", "gemm", "elementwise"))
    out["convnext_tower"] = dict(
        params=tower_params, shape=list(feats.shape), bf16_vs_f32_rel_frobenius=rel,
        ms=tower_ms, tflops=flops / tower_ms * 1e-9, transient_gib=tower_peak / 2**30,
        preprocess_s=prep_s, profile=prof, card=smi)
    print("convnext_tower " + json.dumps(out["convnext_tower"]))
    check(rel <= 2e-2, f"convnext tower bf16 vs f32: relative Frobenius {rel} > 2e-2")
    del feats, pixels
    release()
    out["convnext_chat"], cx_batch = chat_run("convnext chat", vm, questions, images)
    print("convnext_chat " + json.dumps(out["convnext_chat"]))
    cx_offsets = cx_batch["pad_offsets"].tolist()
    t = int(cx_batch["text_ids"].shape[1])
    out["b1_convnext"] = kernel_case("llama3_convnext_prefill", len(questions), t, d.num_heads,
                                     d.num_kv_heads, d.head_dim, torch.bfloat16, True, cx_offsets,
                                     [t] * len(questions), gen, fa)
    del vm, cx, cx_batch
    release()
    out["convnext_s"] = time.perf_counter() - t_phase

    # 2. anyres chat: CLIP-L tiles, spatial_unpad, JAX's grid_pinpoints; four
    # images that select four grids, so tile counts differ and pad + remap run
    t_phase = time.perf_counter()
    ar_cfg = dataclasses.replace(model.cfg, image_aspect_ratio="anyres",
                                 mm_patch_merge_type="spatial_unpad")
    ar = swap_vision(model, ar_cfg, seed=22)
    vm = VisperModel(cfg=ar_cfg, model=ar, tokenizer=tok)
    rng = np.random.default_rng(11)
    ar_images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ANYRES_IMAGES]
    ar_questions = questions[: len(ar_images)]
    tiles, own = vm.anyres_inputs(ar_images)
    n_tiles = [int(x.shape[0]) for x in tiles]
    n_tokens = [int(len(i)) for i in own]
    check(n_tiles == list(ANYRES_TILES), f"anyres tiles {n_tiles}, want {ANYRES_TILES}")
    print(f"anyres images (H, W) {ANYRES_IMAGES}: tiles {n_tiles}, image tokens {n_tokens} [{smi}]")
    out["anyres_chat"], ar_batch = chat_run("anyres chat", vm, ar_questions, ar_images)
    out["anyres_chat"].update(tiles=n_tiles, image_tokens=n_tokens)
    check(ar_batch["images"].shape[:2] == (len(ar_images), max(n_tiles)),
          f"anyres pixels {ar_batch['images'].shape}")
    print("anyres_chat " + json.dumps(out["anyres_chat"]))
    t = int(ar_batch["text_ids"].shape[1])
    out["b1_anyres"] = kernel_case("llama3_anyres_prefill", len(ar_images), t, d.num_heads,
                                   d.num_kv_heads, d.head_dim, torch.bfloat16, True,
                                   ar_batch["pad_offsets"].tolist(), [t] * len(ar_images), gen, fa)
    del vm, ar, ar_batch, tiles
    release()
    out["anyres_s"] = time.perf_counter() - t_phase

    # 3. one S2 call at CLIP-L full width: batch 2, scales (336, 1008)
    t_phase = time.perf_counter()
    s2_in = torch.randn(2, 1008, 1008, 3, device="cuda", generator=gen)
    with torch.no_grad():
        s2 = clip_tower_features_s2(model.vision_tower, s2_in, (336, 1008))
        s2_ms = cuda_ms(lambda: clip_tower_features_s2(model.vision_tower, s2_in, (336, 1008)), 2)
    check(tuple(s2.shape) == (2, 576, 2048) and bool(torch.isfinite(s2).all()),
          f"S2 features {tuple(s2.shape)}, finite {bool(torch.isfinite(s2).all())}")
    out["s2"] = dict(shape=list(s2.shape), ms=s2_ms, card=smi,
                     seconds=time.perf_counter() - t_phase)
    print("s2 " + json.dumps(out["s2"]))
    del s2, s2_in
    api_state.clear()
    del model
    release()

    # 4. one PT step of bench.py's --tower convnext cell: Phi3-mini, config
    # #1, B4 x T1024, the three teachers, save_gate (bench.py's default)
    t_phase = time.perf_counter()
    pt_cfg = with_convnext_tower(phi3_clip_vlm(distill=True))
    pt = init_vlm(pt_cfg, device="cuda", seed=23)
    teachers = init_teachers(pt_cfg, device="cuda", seed=7)
    step = make_train_step(pt_cfg, OptimizerConfig(learning_rate=1e-3, total_steps=1000,
                                                   stage="pretrain"),
                           pt, teacher_fn=make_teacher_fn(pt_cfg), teacher_params=teachers,
                           remat_policy="save_gate")
    tbatch = bench_batch(pt_cfg, TRAIN_BATCH, TRAIN_SEQ, True)
    check(tbatch["images"].shape[1:] == (768, 768, 3), f"PT images {tbatch['images'].shape}")
    tower = dict(pt.vision_tower.named_parameters())
    check(not any(n.startswith("vision_tower.") for n in step.trainable)
          and not any(p.requires_grad for p in tower.values()), "the ConvNeXt tower trains")
    watch = {n: tower[n].detach().clone() for n in ("stem_conv.weight",
                                                    "stages.2.blocks.29.fc1.weight")}
    metrics = step(tbatch)                      # warm-up: update 1, lr 0
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(tbatch)
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)
    peak = torch.cuda.max_memory_allocated()
    n_layers = pt_cfg.decoder.num_layers
    check(launches == dict(flash_fwd=2 * n_layers, flash_bwd_dq=n_layers, flash_bwd_dkv=n_layers,
                           window_attn=sum(teachers["swin"].cfg.depths) * TRAIN_BATCH // 2),
          f"convnext PT step launches {launches}")
    check(math.isfinite(metrics["loss"]) and math.isfinite(metrics["grad_norm"]),
          f"convnext PT step metrics {metrics}")
    _, grads = step.loss_and_grads(tbatch)
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    check(not bad, f"convnext PT step: non-finite gradients in {bad[:3]}")
    check(all(p.grad is None for p in tower.values()), "the ConvNeXt tower got a gradient")
    check(all(torch.equal(tower[n], w) for n, w in watch.items()), "the ConvNeXt tower changed")
    out["convnext_pt_step"] = dict(
        step_ms=step_ms, peak_gib=peak / 2**30, resident_before_gib=resident / 2**30,
        launches=launches, loss=metrics["loss"],
        grad_norm=metrics["grad_norm"], trainable=len(grads), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        card=smi, seconds=time.perf_counter() - t_phase)
    print("convnext_pt_step " + json.dumps(out["convnext_pt_step"]))
    del step, pt, teachers, grads, tower, watch
    release()
    return out


def recipe_dataset(root: Path) -> dict:
    """Phase 12's data under `root`: 16 PNG images of phase 10's sizes
    (seeded uint8, the port's PNG writer), 16 LLaVA-Pretrain-style records
    (<image> + a question, a 20-60-word answer) and 16 IFT-style multi-turn
    ones, a quarter of them text-only."""
    from visper_lm_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(12)
    images = root / "images"
    images.mkdir(parents=True)

    def words(lo, hi):
        n = int(rng.integers(lo, hi + 1))
        return " ".join(f"w{int(x)}" for x in rng.integers(0, 5000, size=n))

    for i in range(RECIPE_RECORDS):
        h, w = CHAT_IMAGES[i % len(CHAT_IMAGES)]
        write_png(str(images / f"{i:04d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    pt = [{"id": f"pt{i}", "image": f"{i:04d}.png", "conversations": [
        {"from": "human", "value": "<image>\n" + words(5, 15)},
        {"from": "gpt", "value": words(20, 60)}]} for i in range(RECIPE_RECORDS)]
    ift = []
    for i in range(RECIPE_RECORDS):
        # half the image records multi-turn: under the Phi3 (and Vicuna)
        # templates the whitespace tokenizer's round lengths miss the
        # template's arithmetic, and the reference then masks the whole record
        # (JAX's preprocess alike); the single-turn ones carry the supervision
        multi = i % 2 == 0 and i % 4 != 3
        turns = []
        for _ in range(int(rng.integers(2, 4)) if multi else 1):
            turns += [{"from": "human", "value": words(5, 10)},
                      {"from": "gpt", "value": words(5, 15) if multi else words(30, 60)}]
        rec = {"id": f"ift{i}", "conversations": turns}
        if i % 4 != 3:
            rec["image"] = f"{i:04d}.png"
            turns[0]["value"] = "<image>\n" + turns[0]["value"]
        ift.append(rec)
    (root / "pt.json").write_text(json.dumps(pt))
    (root / "ift.json").write_text(json.dumps(ift))
    return dict(images=str(images), pt=str(root / "pt.json"), ift=str(root / "ift.json"))


def recipe_phase(fa, wa, smi: str) -> dict:
    """Phase 12: training from the recipes through the port's CLI (see the
    module docstring). Returns the record printed as `recipe_path`."""
    import dataclasses
    import os
    import shutil
    from unittest import mock

    from visper_lm_tpu_torch import native
    from visper_lm_tpu_torch.checkpoint.hf_export import save_hf_checkpoint
    from visper_lm_tpu_torch.config import LoraConfig
    from visper_lm_tpu_torch.constants import IGNORE_INDEX
    from visper_lm_tpu_torch.data.dataset import RAW_IMAGES, BatchIterator, DataConfig, SupervisedDataset
    from visper_lm_tpu_torch.data.image_io import load_image
    from visper_lm_tpu_torch.data.mm_utils import process_images
    from visper_lm_tpu_torch.models.lora import init_lora
    from visper_lm_tpu_torch.models.teachers import teacher_batch
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train import cli
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_loss_fn
    from visper_lm_tpu_torch.train.trainer import TrainerConfig, train

    repo = Path(__file__).resolve().parent
    root = repo / "tmp" / "chip_smoke_recipes"
    shutil.rmtree(root, ignore_errors=True)
    out = dict(card=smi)

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def reset_counts():
        fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0

    def counts():
        return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)

    def per_step(fwd, window, steps=RECIPE_STEPS):
        return dict(flash_fwd=fwd * steps, flash_bwd_dq=32 * steps, flash_bwd_dkv=32 * steps,
                    window_attn=window * steps)

    def rows(run_dir):
        with open(Path(run_dir) / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    def step_record(recs, batch=RECIPE_BATCH):
        # each row's steps_per_sec spans its own step; step 1 carries the warm-up
        ms = [1e3 / r["steps_per_sec"] for r in recs]
        warm = ms[1:] or ms
        mean = sum(warm) / len(warm)
        return dict(step_ms=ms, mean_step_ms_after_first=mean,
                    examples_per_s=batch / (mean / 1e3), losses=[r["loss"] for r in recs])

    def args(recipe, data_path, run, *extra):
        return [f"@{repo / 'recipes' / recipe}", "--data-path", data_path,
                "--image-folder", data["images"], "--tokenizer", "fake-whitespace",
                "--output-dir", str(root / run), "--per-device-batch-size", str(RECIPE_BATCH),
                "--max-steps", str(RECIPE_STEPS), *extra]

    try:
        t_phase = time.perf_counter()
        data = recipe_dataset(root)
        print(f"recipe dataset written in {time.perf_counter() - t_phase:.1f} s [{smi}]")
        t0 = time.perf_counter()
        native.load()
        out["native_build_s"] = native.build_seconds
        out["native_load_s"] = time.perf_counter() - t0
        out["native_flags"] = " ".join(native.flags())
        print(f"native preprocessing library: g++ {native.build_seconds} s ({out['native_flags']}), "
              f"load {out['native_load_s']:.2f} s")

        # the host pipeline per PT batch, inline, in the CLI's order
        pt_args = cli.build_argparser().parse_args(args("pretrain.args", data["pt"], "pt"))
        pt_cfg = cli.build_vlm_config(pt_args)
        tok = cli.load_tokenizer("fake-whitespace")
        ds = SupervisedDataset(DataConfig(data["pt"], data["images"], pt_args.image_aspect_ratio,
                                          pt_cfg.vision.image_size), tok, pt_cfg)
        order = BatchIterator(ds, RECIPE_BATCH, seed=0).order()
        host = collections.defaultdict(list)
        for b in range(len(order) // RECIPE_BATCH):
            recs = [ds.records[i] for i in order[b * RECIPE_BATCH:(b + 1) * RECIPE_BATCH]]
            t0 = time.perf_counter()
            arrays = [load_image(os.path.join(data["images"], r["image"])) for r in recs]
            t1 = time.perf_counter()
            process_images(arrays, image_aspect_ratio="square", image_size=pt_cfg.vision.image_size)
            t2 = time.perf_counter()
            teacher_batch(pt_cfg, arrays, workers=pt_args.dataloader_num_workers)
            t3 = time.perf_counter()
            host["decode_ms"].append((t1 - t0) * 1e3)
            host["tower_pixels_ms"].append((t2 - t1) * 1e3)
            host["teacher_batch_ms"].append((t3 - t2) * 1e3)
            t0 = time.perf_counter()
            next(iter(BatchIterator(ds, RECIPE_BATCH, seed=0, skip_batches=b,
                                    num_workers=pt_args.dataloader_num_workers)))
            host["batch_iterator_4_workers_ms"].append((time.perf_counter() - t0) * 1e3)
        out["host_per_pt_batch"] = {k: dict(ms=v, mean_ms=sum(v) / len(v)) for k, v in host.items()}
        print("recipe host ms per PT batch " + json.dumps(
            {k: round(v["mean_ms"], 1) for k, v in out["host_per_pt_batch"].items()}))

        # (a) PT at Llama-3-8B + CLIP-L from recipes/pretrain.args
        t_a = time.perf_counter()
        argv = args("pretrain.args", data["pt"], "pt", "--save-steps", "2")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_a
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        n_swin = 0 if state.teacher_params is None else sum(state.teacher_params["swin"].cfg.depths)
        want = per_step(64, n_swin * RECIPE_BATCH // 2)
        check(launches == want, f"recipe PT launches {launches}, expected {want}")
        recs = rows(root / "pt")
        check([r["step"] for r in recs] == [1, 2, 3] and all(math.isfinite(r["loss"]) for r in recs),
              f"recipe PT metrics {recs}")
        check((root / "pt" / "checkpoints" / "2" / "state.pt").exists(), "no step-2 checkpoint")
        fresh = dict(init_vlm(state.model.cfg, device="cuda", seed=0).named_parameters())
        moved, frozen_changed = [], []
        for n, p in state.model.named_parameters():
            same = torch.equal(p.detach(), fresh[n].detach())
            if n in state.trainable:
                moved += [] if same else [n]
            elif not same:
                frozen_changed.append(n)
        check(not frozen_changed, f"recipe PT: frozen weights changed: {frozen_changed[:3]}")
        check(any(n.startswith("mm_projector.") for n in moved)
              and any(n.startswith("heads.") for n in moved)
              and any(n.startswith("special_tokens.") for n in moved),
              f"recipe PT: trainables that moved {moved[:5]}")
        del fresh
        release()
        batch = next(iter(cli_batches(pt_cfg, pt_args, ds, teacher_batch)))
        prof = profile_window("recipe_pt_step", lambda: state(batch), top=12,
                              match=("flash_fwd", "flash_bwd", "window_attn_stream"))
        # the logged interval of step 3 holds the step-2 checkpoint's write: the
        # profiled step's wall time is the step's
        out["pt"] = dict(step_record(recs), step_wall_ms=prof["wall_ms"],
                         examples_per_s_wall=RECIPE_BATCH / (prof["wall_ms"] / 1e3),
                         run_s=run_s, peak_gib=peak / 2**30, launches=launches,
                         launches_per_step={k: v // RECIPE_STEPS for k, v in launches.items()},
                         trainable=len(state.trainable), trainables_moved=len(moved),
                         busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                         idle_share=prof["idle_share"], card=smi)
        del state, batch
        release()
        # resume onto the same data order from the step-2 checkpoint
        res = root / "pt_resume" / "checkpoints"
        res.mkdir(parents=True)
        shutil.copytree(root / "pt" / "checkpoints" / "2", res / "2", copy_function=os.link)
        t0 = time.perf_counter()
        state = cli.main(args("pretrain.args", data["pt"], "pt_resume", "--save-steps", "2"))
        resumed = rows(root / "pt_resume")
        check([r["step"] for r in resumed] == [3], f"the resume logged {resumed}")
        rel = abs(resumed[0]["loss"] - recs[2]["loss"]) / abs(recs[2]["loss"])
        print(f"recipe PT resume: step 3 loss {resumed[0]['loss']:.7f}, uninterrupted "
              f"{recs[2]['loss']:.7f}, relative difference {rel:.3g}")
        check(rel <= 1e-5, f"recipe PT resume: step 3 loss differs by {rel:.3g} > 1e-5")
        out["pt"].update(resume_rel_diff=rel, resume_s=time.perf_counter() - t0,
                         seconds=time.perf_counter() - t_a)
        print("recipe_pt " + json.dumps(out["pt"]))
        del state
        release()

        # (b) IFT at Phi3-mini from recipes/finetune.args with --init-from
        t_b = time.perf_counter()
        ckpt = root / "phi3_init"
        ift_extra = ["--model", "phi3", "--version", "llava_phi_3", "--init-from", str(ckpt),
                     "--remat-policy", "save_gate"]
        ift_argv = args("finetune.args", data["ift"], "ift", *ift_extra)
        ift_args = cli.build_argparser().parse_args(ift_argv)
        ift_cfg = cli.build_vlm_config(ift_args)
        src = init_vlm(ift_cfg, device="cuda", seed=31)
        t0 = time.perf_counter()
        save_hf_checkpoint(str(ckpt), src, ift_cfg)
        save_s = time.perf_counter() - t0
        tower_src = {n: p.detach().clone() for n, p in src.vision_tower.named_parameters()}
        del src
        release()
        saves = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(CheckpointManager, "save",
                               lambda self, step, *a, **k: saves.append(step)):
            state = cli.main(ift_argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        want = per_step(64, 0)
        check(launches == want, f"recipe IFT launches {launches}, expected {want}")
        recs = rows(root / "ift")
        check([r["step"] for r in recs] == [1, 2, 3]
              and all(math.isfinite(r["loss"]) and r["loss"] > 0 for r in recs),
              f"recipe IFT metrics {recs}")
        check(saves == [RECIPE_STEPS], f"recipe IFT saves {saves}")
        model = state.model
        n_dec = sum(1 for n in state.trainable if n.startswith("decoder."))
        check(n_dec == sum(1 for n, _ in model.decoder.named_parameters())
              and not any(n.startswith("vision_tower.") for n in state.trainable),
              "recipe IFT: the decoder is not wholly trainable, or the tower trains")
        for n, p in model.vision_tower.named_parameters():
            check(torch.equal(p.detach(), tower_src[n]), f"recipe IFT: tower {n} is not the checkpoint's")
        del tower_src
        trained = sum(p.numel() for p in state.trainable.values())
        # one layer's weight gradients: the kernels (B1-B3) against the plain
        # path, both in bf16, and each against the plain path on an f32 copy
        # of the same weights. At full depth two bf16 paths differ by the bf16
        # rounding of 32 layers: the plain bf16 path is itself 1-2.4 % from the
        # f32 one on an H100 (PERF.md), so the kernels are held to add at most
        # 1e-2 to the plain path's own distance from f32, and to phase 7's
        # kernel-vs-plain gradient cosine (>= 0.999)
        ift_ds = SupervisedDataset(DataConfig(data["ift"], data["images"], ift_args.image_aspect_ratio,
                                              ift_cfg.vision.image_size,
                                              group_by_modality_length=True), tok, ift_cfg)
        # the batch with the most supervised tokens
        gbatch = max(BatchIterator(ift_ds, RECIPE_BATCH, seed=0, seq_buckets=(1024, 2048, 4096)),
                     key=lambda b: int((b["labels"] != IGNORE_INDEX).sum()))
        check(int((gbatch["labels"] != IGNORE_INDEX).sum()) > 0, "no IFT batch has a supervised token")
        gbatch = state.to_device({k: v for k, v in gbatch.items() if k != RAW_IMAGES})
        del state
        release()
        names = [f"decoder.blocks.{RECIPE_GRAD_LAYER}.{w}.weight" for w in (
            "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")]

        def layer_grads(m, use_kernel):
            batch_m = {k: v.float() if v.is_floating_point() else v for k, v in gbatch.items()}
            loss_fn = make_loss_fn(ift_cfg, remat=True, remat_policy="save_gate",
                                   use_kernel=use_kernel)
            params = dict(m.named_parameters())
            loss, g = loss_and_grads(loss_fn, m, batch_m, None, [params[n] for n in names])
            return loss, [x.float() for x in g]

        def rel(a, b):
            return float((a - b).norm() / b.norm())

        loss_k, g_k = layer_grads(model, None)
        loss_p, g_p = layer_grads(model, False)
        m32 = copy.deepcopy(model).float()
        loss_32, g_32 = layer_grads(m32, False)
        del m32
        release()
        short = [n.split(".")[-2] for n in names]
        rel_fro = {w: rel(a, b) for w, a, b in zip(short, g_k, g_p)}
        kernel_f32 = {w: rel(a, b) for w, a, b in zip(short, g_k, g_32)}
        plain_f32 = {w: rel(a, b) for w, a, b in zip(short, g_p, g_32)}
        min_cos, min_name, _ = grad_agreement(short, g_k, g_p)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        print(f"recipe IFT layer {RECIPE_GRAD_LAYER} weight gradients (relative Frobenius): "
              f"kernels vs plain {json.dumps({k: round(v, 5) for k, v in rel_fro.items()})}; "
              f"kernels vs f32 {json.dumps({k: round(v, 5) for k, v in kernel_f32.items()})}; "
              f"plain bf16 vs f32 {json.dumps({k: round(v, 5) for k, v in plain_f32.items()})}; "
              f"min cosine kernels vs plain {min_cos:.6f} ({min_name}); losses {loss_k:.6f} / "
              f"{loss_p:.6f} / {loss_32:.6f}")
        check(min_cos >= 0.999, f"recipe IFT gradient cosine {min_cos} < 0.999 for {min_name}")
        for w in short:
            check(kernel_f32[w] <= plain_f32[w] + 1e-2,
                  f"recipe IFT {w}: the kernels' gradient is {kernel_f32[w]:.4f} from f32, the "
                  f"plain path's {plain_f32[w]:.4f}")
        del g_k, g_p, g_32, gbatch
        out["ift"] = dict(step_record(recs), run_s=run_s, checkpoint_write_s=save_s,
                          peak_gib=peak / 2**30, launches=launches,
                          launches_per_step={k: v // RECIPE_STEPS for k, v in launches.items()},
                          trainable_params=trained, grad_rel_frobenius=rel_fro,
                          grad_kernel_vs_f32=kernel_f32, grad_plain_vs_f32=plain_f32,
                          grad_min_cosine=min_cos, grad_loss_rel=loss_rel, card=smi)
        shutil.rmtree(ckpt, ignore_errors=True)
        out["ift"]["seconds"] = time.perf_counter() - t_b
        print("recipe_ift " + json.dumps(out["ift"]))

        # (c) bench.py's --stage lora and --stage vision_tower on (b)'s model
        t_c = time.perf_counter()

        def ift_iter(epoch, skip_batches=0):
            return iter(BatchIterator(ift_ds, RECIPE_BATCH, seed=epoch, skip_batches=skip_batches,
                                      num_workers=4, seq_buckets=(1024, 2048, 4096)))

        dec_before = {n: p.detach().clone() for n, p in model.decoder.named_parameters()}
        lora_cfg = dataclasses.replace(ift_cfg, lora=LoraConfig())
        model.lora = init_lora(ift_cfg.decoder, lora_cfg.lora, device="cuda", seed=41)
        check(all(float(f.b.detach().abs().max()) == 0.0 for f in model.lora.values()),
              "LoRA's B is not 0")
        b0 = {k: torch.as_tensor(v).cuda() for k, v in next(ift_iter(0)).items() if k != RAW_IMAGES}
        with torch.no_grad():
            base_loss = make_loss_fn(ift_cfg, remat=False)(model, b0)[0]
            lora_loss = make_loss_fn(lora_cfg, remat=False)(model, b0)[0]
        check(torch.equal(base_loss, lora_loss), f"LoRA at B = 0: loss {float(lora_loss)} vs "
              f"the base model's {float(base_loss)}")
        del b0
        stages = {}
        for stage, cfg_s in (("lora", lora_cfg), ("vision_tower", ift_cfg)):
            if stage == "vision_tower":
                model.lora = None
            watch = {n: p.detach().clone() for n, p in model.named_parameters()
                     if not n.startswith("decoder.")}
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            st = train(cfg_s, OptimizerConfig(learning_rate=2e-5, total_steps=RECIPE_STEPS,
                                              stage=stage),
                       TrainerConfig(output_dir=str(root / stage), max_steps=RECIPE_STEPS,
                                     save_steps=1000, remat_policy="save_gate", device="cuda"),
                       model, ift_iter)
            torch.cuda.synchronize()
            launches = counts()
            check(launches == per_step(64, 0), f"{stage} launches {launches}")
            recs = rows(root / stage)
            check(all(math.isfinite(r["loss"]) for r in recs) and len(recs) == RECIPE_STEPS,
                  f"{stage} metrics {recs}")
            for n, p in model.decoder.named_parameters():
                check(torch.equal(p.detach(), dec_before[n]), f"{stage}: decoder {n} changed")
            moved = sorted({n.split(".")[0] for n, p in model.named_parameters()
                            if n in watch and not torch.equal(p.detach(), watch[n])})
            want_moved = ["lora", "mm_projector"] if stage == "lora" else ["mm_projector", "vision_tower"]
            check(moved == want_moved, f"{stage}: moved {moved}, expected {want_moved}")
            if stage == "lora":
                check(all(float(f.b.detach().abs().max()) > 0 for f in model.lora.values()),
                      "LoRA's B stayed 0")
            stages[stage] = dict(step_record(recs), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                                 launches=launches, trainable_params=sum(
                                     p.numel() for p in st.trainable.values()),
                                 moved=moved, seconds=time.perf_counter() - t0, card=smi)
            print(f"recipe_{stage} " + json.dumps(stages[stage]))
            del st, watch
            release()
        out.update(stages)
        out["stages_s"] = time.perf_counter() - t_c
        del model, dec_before
        release()
        out["seconds"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def viz_phase(fa, wa, smi: str) -> dict:
    """Phase 13: visual interpretations at Llama-3-8B + CLIP-L through the
    user API (see the module docstring). Returns the record printed as
    `viz_path`."""
    import dataclasses
    import shutil

    from visper_lm_tpu_torch import demo
    from visper_lm_tpu_torch.api import VisperModel
    from visper_lm_tpu_torch.checkpoint import delta, teacher_bundles
    from visper_lm_tpu_torch.config import llama3_clip_vlm, make_distill_config
    from visper_lm_tpu_torch.data.collate import build_splice_plan, collate_plans
    from visper_lm_tpu_torch.data.image_io import read_png, write_png
    from visper_lm_tpu_torch.data.mm_utils import (
        IMAGENET_MEAN, IMAGENET_STD, process_images, resize_bicubic, tokenizer_image_token)
    from visper_lm_tpu_torch.models import genpipe
    from visper_lm_tpu_torch.models.genpipe.clip_text import clip_text_forward, empty_prompt_ids
    from visper_lm_tpu_torch.models.genpipe.unet import unet_forward
    from visper_lm_tpu_torch.models.genpipe.vae import vae_decode
    from visper_lm_tpu_torch.models.teachers import oneformer
    from visper_lm_tpu_torch.models.teachers import swin as swin_lib
    from visper_lm_tpu_torch.models.teachers.dpt import init_dpt_head, normalized_depth
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.viz import DistillVizHook

    import contextlib
    import io
    import os

    repo = Path(__file__).resolve().parent
    root = repo / "tmp" / "chip_smoke_viz"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = dict(card=smi)

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def within(name, got, ref, share=0.05):
        got, ref = torch.as_tensor(got).float(), torch.as_tensor(ref).float()
        diff, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{name}: not finite")
        check(diff <= share * scale, f"{name}: kernels vs plain {diff} > {share} x {scale}")
        return dict(max_abs_diff=diff, max_abs_ref=scale, share=diff / max(scale, 1e-30))

    try:
        # (a) the tap forward and the heads, as phase 10 builds the model, its
        # gen task tapped at 3 layers, not 9 (time: the demo renders each)
        cfg = llama3_clip_vlm(distill=True, image_aspect_ratio="pad")
        cfg = dataclasses.replace(cfg, distill=make_distill_config(layer_indices=VIZ_TAPS))
        d = cfg.decoder
        tok = WordTokenizer(d.vocab_size, LLAMA3_SPECIALS, bos=128000, eos=128009, first_word=256)
        t0 = time.perf_counter()
        vm = VisperModel(cfg=cfg, model=init_vlm(cfg, device="cuda", seed=13), tokenizer=tok)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        rng = np.random.default_rng(13)
        image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        question = " ".join(f"w{i}" for i in rng.integers(256, 128000, size=40))
        fa.launches = 0
        interp, first_ms = synced_ms(lambda: vm.get_visual_interpretations(question, image))
        b1 = fa.launches
        check(b1 == d.num_layers, f"get_visual_interpretations: B1 {b1} launches, want {d.num_layers}")
        _, warm_ms = synced_ms(lambda: vm.get_visual_interpretations(question, image))
        plain = vm.get_visual_interpretations(question, image, use_kernel=False)
        shares = {}
        for tcfg in cfg.distill.tasks:
            for layer in tcfg.layer_indices:
                got = interp[tcfg.task][layer]
                want = (1, tcfg.head.num_tokens, tcfg.head.output_dim)
                check(got.shape == want, f"{tcfg.task}/{layer}: shape {got.shape}, want {want}")
                shares[f"{tcfg.task}/{layer}"] = within(f"{tcfg.task}/{layer}", got,
                                                        plain[tcfg.task][layer])
        prompt_len = -(-(len(tokenizer_image_token(vm.build_prompt(question), tok))
                         + cfg.num_image_tokens + cfg.distill.num_task_tokens * 3) // 128) * 128
        prof = profile_window("viz tap forward", lambda: vm.get_visual_interpretations(question, image),
                              match=("flash",))
        out["tap_forward"] = dict(b1_launches=b1, first_ms=first_ms, ms=warm_ms, prompt_len=prompt_len,
                                  kernels_vs_plain=shares, profile=prof, card=smi)
        print("viz tap_forward " + json.dumps(out["tap_forward"]))
        gen = torch.Generator(device="cuda").manual_seed(13)

        # (b) depth through DPT at DAv2-L's widths
        dpt = init_dpt_head(1024, generator=gen, device="cuda")
        depth_ms = {}
        for layer, emb in interp["depth"].items():
            m, depth_ms[layer] = synced_ms(
                lambda: normalized_depth(dpt, demo._depth_pyramid(vm, layer, emb)))
            check(tuple(m.shape) == (1, 336, 336) and bool(torch.isfinite(m).all())
                  and float(m.min()) >= 0.0 and float(m.max()) <= 1.0,
                  f"depth layer {layer}: map {tuple(m.shape)} [{float(m.min())}, {float(m.max())}]")
        out["depth"] = dict(ms=depth_ms, card=smi)
        print("viz depth " + json.dumps(out["depth"]))

        # (c) segmentation: OneFormer (COCO) over Swin-L at 768 px, the seg head's
        # prediction substituted for the last stage
        swin = swin_lib.SwinBackbone(swin_lib.SWIN_L, device="cuda", dtype=torch.bfloat16)
        swin_lib.init_swin_(swin, gen)
        swin = swin.requires_grad_(False).eval()
        dec = oneformer.init_oneformer(oneformer.ONEFORMER_COCO, generator=gen, device="cuda")
        px = resize_bicubic(image, (768, 768)).astype(np.float32)[None] / 255.0
        px = torch.as_tensor(((px - np.asarray(IMAGENET_MEAN)) / np.asarray(IMAGENET_STD))
                             .astype(np.float32), device="cuda")
        task = torch.zeros(1, 77, device="cuda")
        layer = cfg.distill.get_task("seg").layer_indices[-1]
        sub = torch.as_tensor(interp["seg"][layer], device="cuda").reshape(1, 24, 24, 1536)

        def masks(use_kernel):
            return oneformer.get_masks(dec, oneformer.ONEFORMER_COCO, swin, px, task,
                                       backbone_last_feature=sub, use_kernel=use_kernel)

        wa.launches = 0
        res_k, first_seg_ms = synced_ms(lambda: masks(None))
        b4 = wa.launches
        want_b4 = sum(swin_lib.SWIN_L.depths)   # swin_forward launches once a block
        print(f"viz seg: B4 launches {b4} for one 768-px image (Swin-L blocks {want_b4}) [{smi}]")
        check(b4 == want_b4, f"get_masks: B4 {b4} launches, want {want_b4}")
        _, seg_ms = synced_ms(lambda: masks(None))
        res_p = masks(False)
        seg_rec = {k: within(f"oneformer {k}", res_k[k], res_p[k])
                   for k in ("class_queries_logits", "masks_queries_logits")}
        sem_k = oneformer.semantic_segmentation(res_k["class_queries_logits"],
                                                res_k["masks_queries_logits"], (480, 640))
        sem_p = oneformer.semantic_segmentation(res_p["class_queries_logits"],
                                                res_p["masks_queries_logits"], (480, 640))
        agree = float((sem_k == sem_p).float().mean())
        check(agree >= 0.99, f"semantic maps kernels vs plain agree on {agree:.4f} of pixels")
        prof = profile_window("viz get_masks", lambda: masks(None), match=("window",))
        out["seg"] = dict(b4_launches=b4, first_ms=first_seg_ms, ms=seg_ms, map_agree=agree, profile=prof,
                          shapes={k: list(v.shape) for k, v in res_k.items()}, **seg_rec, card=smi)
        print("viz seg " + json.dumps(out["seg"]))
        del res_k, res_p

        # (d) generation: the unCLIP pipeline at SD21_UNCLIP's widths, bf16
        gcfg = genpipe.SD21_UNCLIP
        pipe, init_ms = synced_ms(lambda: genpipe.init_genpipe(gcfg, device="cuda",
                                                               dtype=torch.bfloat16, seed=13))
        emb = interp["gen"][cfg.distill.get_task("gen").layer_indices[0]]
        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True    # the seed, not the algorithm, sets the bytes
        torch.cuda.reset_peak_memory_stats()
        img1, gen_ms = synced_ms(lambda: genpipe.generate_from_embeds(
            pipe, gcfg, emb, num_inference_steps=25, seed=0))
        peak = torch.cuda.max_memory_allocated()
        img2 = genpipe.generate_from_embeds(pipe, gcfg, emb, num_inference_steps=25, seed=0)
        torch.backends.cudnn.deterministic = cudnn_det
        check(img1.shape == (1, 768, 768, 3) and np.isfinite(img1).all() and img1.min() >= 0.0
              and img1.max() <= 1.0, f"generated image {img1.shape} [{img1.min()}, {img1.max()}]")
        check(img1.tobytes() == img2.tobytes(), "the same seed gave other image bytes")
        # one denoise step (the UNet on the CFG batch of 2) and the VAE, timed alone
        lat = torch.randn(2, 96, 96, 4, generator=gen, device="cuda")
        text = clip_text_forward(pipe.text, gcfg.text, empty_prompt_ids(gcfg.text, "cuda")).expand(2, -1, -1)
        noise = torch.randn(1, gcfg.embed_dim, generator=gen, device="cuda")
        cond = genpipe.noise_image_embeddings(pipe, gcfg, torch.as_tensor(emb, device="cuda")[:, 0],
                                              0, noise)
        labels = torch.cat([torch.zeros_like(cond), cond]).to(torch.bfloat16)
        t500 = torch.tensor(500, device="cuda")
        with torch.no_grad():
            step_ms = cuda_ms(lambda: unet_forward(pipe.unet, gcfg.unet, lat, t500, text, labels), 5)
            step_prof = profile_window(
                "viz unet step", lambda: unet_forward(pipe.unet, gcfg.unet, lat, t500, text, labels),
                match=("softmax", "gemm", "conv", "elementwise"))
            vae_ms = cuda_ms(lambda: vae_decode(pipe.vae, gcfg.vae, lat[:1]), 3)
            ref_unet = copy.deepcopy(pipe.unet).float()
            got = unet_forward(pipe.unet, gcfg.unet, lat, t500, text, labels).float()
            ref = unet_forward(ref_unet, gcfg.unet, lat, t500, text.float(), labels.float())
            rel = ((got - ref).norm() / ref.norm()).item()
            del ref_unet, got, ref
        check(rel <= 2e-2, f"UNet bf16 vs f32 relative Frobenius {rel} > 2e-2")
        n_unet = sum(p.numel() for p in pipe.unet.parameters())
        out["gen"] = dict(unet_params=n_unet, init_ms=init_ms, generate_ms=gen_ms,
                          step_ms=step_ms, step_profile=step_prof, vae_ms=vae_ms, steps=25,
                          guidance=gcfg.guidance_scale,
                          peak_gib=peak / 2**30, unet_bf16_vs_f32_rel_fro=rel,
                          image_mean=float(img1.mean()), card=smi)
        print("viz gen " + json.dumps(out["gen"]))
        release_cuda()

        # (e) the tools: bundles, the demo one-shot, the viz hook, deltas
        t0 = time.perf_counter()
        teachers = root / "teachers"
        packed = teacher_bundles.pack_modules(
            str(teachers), dpt=dpt,
            oneformer=dict(decoder=dec, cfg=oneformer.ONEFORMER_COCO, swin=swin,
                           swin_cfg=swin_lib.SWIN_L, image_size=768),
            genpipe=dict(pipe=pipe, cfg=gcfg, num_inference_steps=VIZ_DEMO_STEPS))
        pack_s = time.perf_counter() - t0
        sizes = {k: os.path.getsize(v) / 2**30 for k, v in packed.items()}
        del pipe
        release_cuda()
        write_png(str(root / "in.png"), image)
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            demo.main(["--image", str(root / "in.png"), "--question", question, "--viz",
                       "--teachers", str(teachers), "--out-dir", str(root / "out")], model=vm)
        demo_s = time.perf_counter() - t0
        text_out = printed.getvalue()
        manifest = json.loads(text_out[text_out.index("{"):])
        pngs = {}
        for tcfg in cfg.distill.tasks:
            for layer in tcfg.layer_indices:
                key = f"{tcfg.task}/{layer + 1}" + ("_sem" if tcfg.task == "seg" else "_png")
                check(key in manifest, f"demo: no {key} in the manifest {sorted(manifest)}")
                arr = read_png(manifest[key])
                want = {"depth": (336, 336, 3), "seg": (480, 640, 3), "gen": (768, 768, 3)}[tcfg.task]
                check(arr is not None and arr.shape == want, f"demo: {key} reads back as "
                      f"{None if arr is None else arr.shape}, want {want}")
                pngs[key] = list(arr.shape)
        # the viz hook, called directly on the model and a one-image batch
        plan = build_splice_plan(tokenizer_image_token(vm.build_prompt(question), tok), None,
                                 prompt_len, num_image_tokens=cfg.num_image_tokens,
                                 num_task_tokens=cfg.distill.num_task_tokens, num_tasks=3)
        batch = collate_plans([plan], images=np.asarray(
            process_images([image], image_aspect_ratio="square", image_size=336), np.float32))
        hook = DistillVizHook(cfg, str(root / "hook"), dpt, every=1)
        state = type("State", (), {"model": vm.model})()
        maps = hook(1, state, batch)
        n_depth = len(cfg.distill.get_task("depth").layer_indices)
        check(maps is not None and maps.shape == (n_depth, 1, 336, 336) and np.isfinite(maps).all(),
              f"viz hook maps {None if maps is None else maps.shape}")
        hook_files = sorted(os.listdir(root / "hook" / "viz"))
        check(hook_files == [f"depth_l{i}_step1.png" for i in range(n_depth)],
              f"viz hook files {hook_files}")
        for f in hook_files:
            check(read_png(str(root / "hook" / "viz" / f)).shape == (336, 336, 3), f"hook {f}")
        # a checkpoint delta of the heads round-trips bit for bit (bf16)
        target = copy.deepcopy(vm.model.heads)
        with torch.no_grad():
            for p in target.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype))
        back = delta.apply_delta(vm.model.heads, delta.make_delta(vm.model.heads, target))
        want = delta.flat(target)
        check(sorted(back) == sorted(want) and all(np.array_equal(back[k], want[k]) for k in want),
              "delta: the heads did not round-trip bit for bit")
        out["tools"] = dict(pack_s=pack_s, bundle_gib=sizes, demo_s=demo_s, pngs=pngs,
                            hook_files=hook_files, delta_tensors=len(want), card=smi)
        print("viz tools " + json.dumps(out["tools"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def eval_phase(fa, smi: str) -> dict:
    """Phase 14: evaluation at Llama-3-8B + CLIP-L through the port's eval
    package (see the module docstring). Returns the record printed as
    `eval_path`."""
    import contextlib
    import dataclasses
    import io
    import runpy
    import shutil

    from visper_lm_tpu_torch.api import VisperModel
    from visper_lm_tpu_torch.checkpoint.hf_export import save_hf_checkpoint
    from visper_lm_tpu_torch.config import llama3_clip_vlm
    from visper_lm_tpu_torch.data.image_io import load_image, write_png
    from visper_lm_tpu_torch.eval import cvbench, harness, inception, lmms_tasks, mmstar
    from visper_lm_tpu_torch.eval.lmms_adapter import VisperLmms
    from visper_lm_tpu_torch.eval.olympiad import OlympiadBenchEvaluator
    from visper_lm_tpu_torch.models.vlm import init_vlm

    import sympy

    repo = Path(__file__).resolve().parent
    root = repo / "tmp" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = dict(card=smi, sympy=sympy.__version__, transformers=None,
               pil=importlib.util.find_spec("PIL") is not None)
    if importlib.util.find_spec("transformers") is not None:
        import transformers

        out["transformers"] = transformers.__version__

    def synced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def words(n):
        return " ".join(f"w{k}" for k in rng.integers(256, 128000, size=n))

    try:
        # the host scorers on the card's Python: sympy (torch's dependency) for OlympiadBench
        check(OlympiadBenchEvaluator().judge("\\boxed{\\frac{\\sqrt{2}}{2}}", "0.7071", 1e-3),
              "OlympiadBench's sympy judge failed")
        check(len(lmms_tasks.task_builders()) == 39, "lmms_tasks registry")
        cfg = llama3_clip_vlm(distill=True, image_aspect_ratio="pad")
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                   num_layers=EVAL_LAYERS))
        d = cfg.decoder
        tok = WordTokenizer(d.vocab_size, LLAMA3_SPECIALS, bos=128000, eos=128009, first_word=256)
        t0 = time.perf_counter()
        vm = VisperModel(cfg=cfg, model=init_vlm(cfg, device="cuda", seed=14), tokenizer=tok)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0

        # (a) 16 CV-Bench records (test.jsonl + PNGs) and 16 MMStar records, seeded
        rng = np.random.default_rng(14)
        cv_dir = root / "cvbench"
        cv_dir.mkdir()
        sources, tasks = ("ADE20K", "COCO", "Omni3D"), ("Count", "Relation", "Depth", "Distance")
        l2 = [(cat, sub) for cat, subs in mmstar.MMSTAR_L2.items() for sub in subs]
        mm_path = root / "mmstar.jsonl"
        with open(cv_dir / "test.jsonl", "w") as fc, open(mm_path, "w") as fm:
            for i in range(EVAL_RECORDS):
                h, w = EVAL_IMAGES[i % len(EVAL_IMAGES)]
                write_png(str(cv_dir / f"{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
                fc.write(json.dumps({"filename": f"{i}.png", "prompt": f"{words(10 + 3 * i)} (A) w11 (B) w12",
                                     "answer": "(A)" if i % 2 else "(B)", "task": tasks[i % 4],
                                     "source": sources[i % 3]}) + "\n")
                png = root / f"mm{i}.png"
                write_png(str(png), rng.integers(0, 256, (w, h, 3), dtype=np.uint8))
                cat, sub = l2[i % len(l2)]
                fm.write(json.dumps({"image": str(png), "question": f"{words(8 + 2 * i)}\nA. w21\nB. w22"
                                     + mmstar.PROMPT_SUFFIX, "answer": "AB"[i % 2], "category": cat,
                                     "l2_category": sub}) + "\n")
        cv_data = cvbench.prepare_cvbench(str(cv_dir))
        mm_data = cvbench.load_jsonl(str(mm_path))
        launches = {}

        # (b) the batched benchmark runs: a chat prefill (B1 32) per batch of 8
        for name, run, data in (("cvbench", cvbench.run_cvbench, cv_data),
                                ("mmstar", mmstar.run_mmstar, mm_data)):
            answers = root / f"{name}_answers.jsonl"
            fa.launches = 0
            scores, ms = synced_ms(lambda: run(vm, data, batch_size=EVAL_BATCH,
                                               max_new_tokens=EVAL_NEW_TOKENS,
                                               output_path=str(answers)))
            prefills = -(-len(data) // EVAL_BATCH)
            check(fa.launches == d.num_layers * prefills,
                  f"run_{name}: B1 {fa.launches} launches, want {d.num_layers} x {prefills}")
            check(all(0.0 <= v <= 1.0 for v in scores.values()), f"run_{name} scores {scores}")
            check(len(cvbench.load_jsonl(str(answers))) == len(data), f"run_{name}: answer file")
            launches[f"run_{name}"] = fa.launches
            out[name] = dict(ms=ms, records=len(data), prefills=prefills, b1_launches=fa.launches,
                             scores=scores, card=smi)
            print(f"eval {name} " + json.dumps(out[name]))

        # (c) the harness through the lmms adapter: generate_until over 8 CV-Bench
        # docs (one chat; the task asks for 128 new tokens), then loglikelihood
        # and loglikelihood_rolling
        lm = VisperLmms(vm, batch_size=EVAL_BATCH, max_new_tokens=EVAL_NEW_TOKENS)
        fa.launches = 0
        res, ms = synced_ms(lambda: harness.evaluate(lm, [harness.cvbench_task(cv_data[:EVAL_BATCH])]))
        check(lm.errors == [], f"generate_until caught {lm.errors}")
        check(fa.launches == d.num_layers,
              f"evaluate: B1 {fa.launches} launches, want {d.num_layers}")
        check(set(res) == {"cvbench"} and "exact_match" in res["cvbench"]
              and 0.0 <= harness.cvbench_overall(res["cvbench"]) <= 1.0, f"evaluate {res}")
        launches["evaluate"] = fa.launches
        out["evaluate"] = dict(ms=ms, docs=EVAL_BATCH, b1_launches=fa.launches, results=res, card=smi)
        print("eval evaluate " + json.dumps(out["evaluate"]))
        lm.task_dict = {}
        conts = [" (A)", " (B)", " w11 w12 w13", " A", " the answer is (A)", " w5", " B .", " (A) w11"]
        reqs = [harness.Instance(args=(cv_data[i]["question"], conts[i],
                                       lambda _, p=cv_data[i]["image"]: [load_image(p)], i,
                                       "cvbench", "test")) for i in range(EVAL_BATCH)]
        fa.launches = 0
        ll, ll_ms = synced_ms(lambda: lm.loglikelihood(reqs))
        check(fa.launches == len(reqs) * d.num_layers,
              f"loglikelihood: B1 {fa.launches} launches for {len(reqs)} requests, want "
              f"{d.num_layers} each")
        check(all(np.isfinite(lp) and lp < 0 for lp, _ in ll), f"loglikelihood {ll}")
        launches["loglikelihood"] = fa.launches
        texts = [words(n) for n in (30, 120, 250)]     # T 128, 128, 256
        fa.launches = 0
        rolling, roll_ms = synced_ms(lambda: lm.loglikelihood_rolling(
            [harness.Instance(args=(t,)) for t in texts]))
        check(fa.launches == len(texts) * d.num_layers,
              f"loglikelihood_rolling: B1 {fa.launches} launches for {len(texts)} requests, want "
              f"{d.num_layers} each")
        check(all(np.isfinite(s) and s < 0 for s in rolling), f"loglikelihood_rolling {rolling}")
        launches["loglikelihood_rolling"] = fa.launches
        check(lm.errors == [], f"the adapter caught {lm.errors}")

        # (d) B1's log-probs against an f32 run of the same weights: both bf16
        # paths (kernel, plain) drift from f32 over 32 layers; the kernel may
        # add at most 1e-2 to the plain path's relative distance (phase 12's form)
        lp_k = lm.continuation_logprobs(reqs)
        lp_p = VisperLmms(vm, use_kernel=False).continuation_logprobs(reqs)
        m32 = copy.deepcopy(vm.model).float()
        lp_32 = VisperLmms(dataclasses.replace(vm, model=m32), use_kernel=False).continuation_logprobs(reqs)
        del m32
        release_cuda()

        def flat(x):
            return np.concatenate([lps for lps, _ in x])

        ref = flat(lp_32)
        kernel_f32 = float(np.linalg.norm(flat(lp_k) - ref) / np.linalg.norm(ref))
        plain_f32 = float(np.linalg.norm(flat(lp_p) - ref) / np.linalg.norm(ref))
        kernel_plain = float(np.abs(flat(lp_k) - flat(lp_p)).max())
        check(kernel_f32 <= plain_f32 + 1e-2,
              f"loglikelihood: the kernel's log-probs are {kernel_f32:.4g} from f32, the plain path's {plain_f32:.4g}")
        out["loglikelihood"] = dict(
            ms=ll_ms, requests=len(reqs), tokens=int(ref.size), b1_launches=launches["loglikelihood"],
            sums=[lp for lp, _ in ll], greedy=[g for _, g in ll], kernel_vs_f32=kernel_f32,
            plain_vs_f32=plain_f32, kernel_vs_plain_max_abs=kernel_plain,
            greedy_f32=[g for _, g in lp_32], rolling_ms=roll_ms, rolling_tokens=[len(tok(t).input_ids)
                                                                              for t in texts],
            rolling=rolling, rolling_b1_launches=launches["loglikelihood_rolling"], card=smi)
        print("eval loglikelihood " + json.dumps(out["loglikelihood"]))
        del vm, lm
        release_cuda()

        # (e) FID-Inception on the card: 64 seeded 512-px images (the
        # antialiased downscale to 299) against the CPU run of the same weights
        shapes = inception.conv_shapes()
        sd = {}
        for mod, brs in inception.module_branches().items():
            for br in brs:
                full = mod if br == "" else f"{mod}.{br}"
                cin, cout, kh, kw = shapes[full]
                sd[f"{full}.conv.weight"] = (rng.standard_normal((cout, cin, kh, kw)) * 0.05).astype(np.float32)
                sd[f"{full}.bn.weight"] = np.abs(rng.standard_normal(cout)).astype(np.float32)
                sd[f"{full}.bn.bias"] = rng.standard_normal(cout).astype(np.float32)
                sd[f"{full}.bn.running_mean"] = rng.standard_normal(cout).astype(np.float32)
                sd[f"{full}.bn.running_var"] = (np.abs(rng.standard_normal(cout)) + 0.5).astype(np.float32)
        images = rng.uniform(0, 1, (INCEPTION_IMAGES, INCEPTION_SIZE, INCEPTION_SIZE, 3)).astype(np.float32)
        fn_gpu = inception.inception_feature_fn(inception.import_inception(sd, device="cuda"),
                                                batch_size=INCEPTION_IMAGES)
        fn_gpu(images[:2])                                              # cuDNN's algorithm choice
        feats, inc_ms = synced_ms(lambda: fn_gpu(images))
        t0 = time.perf_counter()
        feats_cpu = inception.inception_feature_fn(inception.import_inception(sd, device="cpu"),
                                                   batch_size=16)(images)
        cpu_s = time.perf_counter() - t0
        rel = float(np.linalg.norm(feats - feats_cpu) / np.linalg.norm(feats_cpu))
        worst = float(np.abs(feats - feats_cpu).max() / np.abs(feats_cpu).max())
        check(feats.shape == (INCEPTION_IMAGES, 2048) and np.isfinite(feats).all(), f"features {feats.shape}")
        # f32 sums in other orders: ~1e-6; TF32 convolutions would give ~1e-3
        check(rel <= 1e-4, f"inception card vs CPU relative Frobenius {rel} > 1e-4")
        out["inception"] = dict(images=INCEPTION_IMAGES, size=INCEPTION_SIZE, ms=inc_ms, cpu_s=cpu_s,
                                rel_fro_vs_cpu=rel, max_abs_share_vs_cpu=worst, card=smi)
        print("eval inception " + json.dumps(out["inception"]))

        # (f) the validation CLI, as `python -m visper_lm_tpu_torch.eval.validate`,
        # on a full-width 2-layer checkpoint written by save_hf_checkpoint
        cfg2 = dataclasses.replace(cfg, decoder=dataclasses.replace(d, num_layers=FILE_LAYERS))
        ckpt = root / "llama3_2layer"
        model2 = init_vlm(cfg2, device="cuda", seed=15)
        t0 = time.perf_counter()
        save_hf_checkpoint(str(ckpt), model2, cfg2)
        write_s = time.perf_counter() - t0
        del model2
        release_cuda()
        report_path = root / "report" / "scores.json"
        argv = ["validate", "--ckpt", str(ckpt), "--tasks", "cvbench,mmstar",
                "--cvbench-path", str(cv_dir), "--mmstar-path", str(mm_path),
                "--tokenizer", "fake-whitespace", "--device", "cuda", "--limit", str(EVAL_BATCH),
                "--batch-size", str(EVAL_BATCH), "--max-new-tokens", "4", "--out", str(report_path)]
        saved_argv, sys.argv = sys.argv, argv
        err = io.StringIO()
        fa.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err):
                runpy.run_module("visper_lm_tpu_torch.eval.validate", run_name="__main__", alter_sys=True)
            code = None
        except SystemExit as e:
            code = e.code
        finally:
            sys.argv = saved_argv
        cli_s = time.perf_counter() - t0
        check(code == 0, f"validate exited with {code}: {err.getvalue()[-2000:]}")
        with open(report_path) as f:
            report = json.load(f)
        check({"Overall", "2D", "3D"} <= set(report["cvbench"]) and "final score" in report["mmstar"],
              f"validate report {report}")
        if importlib.util.find_spec("transformers") is None:
            check("logit_parity" not in report and "parity gate skipped" in err.getvalue(),
                  "validate without transformers: the parity gate must print its skip")
        check(fa.launches == 2 * FILE_LAYERS, f"validate: B1 {fa.launches} launches, want 2 x {FILE_LAYERS}")
        check((root / "report" / "cvbench_answers.jsonl").exists(), "validate: no answer file")
        launches["validate"] = fa.launches
        out["validate"] = dict(layers=FILE_LAYERS, checkpoint_write_s=write_s, cli_s=cli_s,
                               b1_launches=fa.launches, cvbench=report["cvbench"]["Overall"],
                               mmstar=report["mmstar"]["final score"],
                               parity="logit_parity" in report, card=smi)
        print("eval validate " + json.dumps(out["validate"]))
        out["b1_launches"] = launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def memory_dataset(root: Path) -> dict:
    """Phase 15's data under `root`: 16 PNG images of phase 10's sizes and 16
    single-turn IFT records (<image> + a question, a 2,900-3,200-word answer:
    with the image's 576 tokens every batch pads to the 4,096 bucket)."""
    from visper_lm_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(15)
    images = root / "images"
    images.mkdir(parents=True)
    recs = []
    for i in range(MEM_RECORDS):
        h, w = CHAT_IMAGES[i % len(CHAT_IMAGES)]
        write_png(str(images / f"{i:04d}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        words = lambda n: " ".join(f"w{int(x)}" for x in rng.integers(0, 5000, size=n))  # noqa: E731
        recs.append({"id": f"mem{i}", "image": f"{i:04d}.png", "conversations": [
            {"from": "human", "value": "<image>\n" + words(8)},
            {"from": "gpt", "value": words(int(rng.integers(*MEM_WORDS)))}]})
    (root / "ift.json").write_text(json.dumps(recs))
    return dict(images=str(images), ift=str(root / "ift.json"))


def bandwidth_probe() -> dict:
    """(a) One GiB between page-locked host memory (`HostPool`, as the
    offloaded state and streamed gradients use it) and the card, each way
    and both at once on two streams: GB/s, the staged update's bound."""
    from visper_lm_tpu_torch.device import HostPool

    pool = HostPool(2 * MEM_PROBE_BYTES, "cuda")
    host = [pool.take((MEM_PROBE_BYTES,), torch.uint8) for _ in range(2)]
    check(all(h.is_pinned() for h in host), "the probe's host buffers are not page-locked")
    dev = [torch.empty(MEM_PROBE_BYTES, dtype=torch.uint8, device="cuda") for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]

    def timed(copies, reps=3):
        best = float("inf")
        for _ in range(reps):
            cur = torch.cuda.current_stream()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(cur)
            for (dst, src), st in zip(copies, streams):
                st.wait_stream(cur)
                with torch.cuda.stream(st):
                    dst.copy_(src, non_blocking=True)
            for st in streams[:len(copies)]:
                cur.wait_stream(st)
            end.record(cur)
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return len(copies) * MEM_PROBE_BYTES / (best / 1e3) / 1e9, best

    h2d, h2d_ms = timed([(dev[0], host[0])])
    d2h, d2h_ms = timed([(host[1], dev[1])])
    both, both_ms = timed([(dev[0], host[0]), (host[1], dev[1])])
    dev[0].fill_(7)
    host[1].copy_(dev[0])
    check(bool(host[1][:: 1 << 20].eq(7).all()), "the probe's device-to-host copy lost bytes")
    out = dict(bytes=MEM_PROBE_BYTES, h2d_gb_per_s=h2d, d2h_gb_per_s=d2h, both_gb_per_s=both,
               h2d_ms=h2d_ms, d2h_ms=d2h_ms, both_ms=both_ms)
    print("memory bandwidth " + json.dumps(out))
    del host, dev, pool
    return out


def memory_phase(fa, wa, smi: str) -> dict:
    """Phase 15: the memory levers (see the module docstring). Returns the
    record printed as `memory_path`; its "b1".."b3" are the kernel records at
    (c)'s shape."""
    import dataclasses
    import os
    import runpy
    import shutil
    from unittest import mock

    from visper_lm_tpu_torch.checkpoint.hf_export import save_hf_checkpoint
    from visper_lm_tpu_torch.config import llama3_clip_vlm, phi3_clip_vlm
    from visper_lm_tpu_torch.data.dataset import RAW_IMAGES, BatchIterator, DataConfig, SupervisedDataset
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train import aot, cli
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_train_step

    repo = Path(__file__).resolve().parent
    root = repo / "tmp" / "chip_smoke_memory"
    shutil.rmtree(root, ignore_errors=True)
    out = dict(card=smi)
    gen = torch.Generator(device="cuda").manual_seed(15)

    def reset_counts():
        fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0

    def counts():
        return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)

    def per_step(layers, steps):
        return dict(flash_fwd=2 * layers * steps, flash_bwd_dq=layers * steps,
                    flash_bwd_dkv=layers * steps, window_attn=0)

    try:
        # (a) the host link
        out["bandwidth"] = bandwidth_probe()
        release_cuda()

        progress("phase 15 (b)")
        # (b) parity at Llama-3-8B widths, MEM_LAYERS layers: on-card AdamW, offloaded, offloaded + streamed
        t0 = time.perf_counter()
        cfg4 = llama3_clip_vlm(distill=False)
        cfg4 = dataclasses.replace(cfg4, decoder=dataclasses.replace(cfg4.decoder, num_layers=MEM_LAYERS))
        base = init_vlm(cfg4, device="cuda", seed=15)
        batch = aot.full_length_batch(cfg4, MEM_BATCH, MEM_SEQ, with_teachers=False)
        opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=10, stage="finetune")
        runs = {}
        for run, kw in (("on_card", {}), ("offload", dict(offload_opt_state=True)),
                        ("offload_stream", dict(offload_opt_state=True, stream_grads=2))):
            model = copy.deepcopy(base)
            step = make_train_step(cfg4, opt_cfg, model, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            losses = [step(batch)["loss"] for _ in range(MEM_STEPS)]
            torch.cuda.synchronize()
            launches = counts()
            check(launches == per_step(MEM_LAYERS, MEM_STEPS),
                  f"parity {run}: launches {launches}, expected {per_step(MEM_LAYERS, MEM_STEPS)}")
            check(all(math.isfinite(x) for x in losses) and losses[2] != losses[1],
                  f"parity {run}: losses {losses}")
            host = getattr(step.optimizer, "host_bytes", 0)
            check((host > 0) == ("offload_opt_state" in kw), f"parity {run}: {host} host bytes")
            if step.grad_stream is not None:
                check(len(step.grad_stream.ranges) == 2, f"parity {run}: segments {step.grad_stream.ranges}")
                step.grad_stream.close()
            runs[run] = dict(losses=losses, update_ms=step.update_ms(),
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                             host_gib=host / 2**30,
                             launches_per_step={k: v // MEM_STEPS for k, v in launches.items()},
                             params={n: p.detach().clone() for n, p in step.trainable.items()})
            del step, model
            release_cuda()
        ref = runs["on_card"]
        for run in ("offload", "offload_stream"):
            r = runs[run]
            np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5,
                                       err_msg=f"parity {run}: losses")
            bit = r["losses"] == ref["losses"]
            worst = 0.0
            for n, p in r["params"].items():
                a, b = p.float(), ref["params"][n].float()
                excess = ((a - b).abs() - (1e-6 + 1e-4 * b.abs())).max().item()
                check(excess <= 0, f"parity {run}: {n} beyond rtol 1e-4 / atol 1e-6 by {excess}")
                worst = max(worst, (a - b).abs().max().item())
                bit = bit and torch.equal(p, ref["params"][n])
            r.update(bit_equal=bit, max_abs_param_diff=worst)
        moved = sum(int(not torch.equal(p, dict(base.named_parameters())[n]))
                    for n, p in ref["params"].items())
        check(moved > 0, "parity: no trainable moved")
        out["parity"] = {k: {kk: vv for kk, vv in v.items() if kk != "params"} for k, v in runs.items()}
        out["parity"]["seconds"] = time.perf_counter() - t0
        out["parity"]["trainables_moved"] = moved
        print("memory parity " + json.dumps(out["parity"]))
        del runs, ref, base
        release_cuda()

        progress("phase 15 (c)")
        # (c) IFT from recipes/finetune.args with the levers, at full depth
        data = memory_dataset(root)
        mem = host_memory()
        sizes = aot.static_breakdown(llama3_clip_vlm(distill=False), stage="finetune",
                                     batch_size=RECIPE_BATCH, seq_len=4096, offload_opt_state=True,
                                     stream_grads=MEM_STREAM)
        need_gb = (sizes["opt_state_host"] + sizes["grads_host"]) / 1e9 + MEM_HOST_MARGIN_GB
        model_name = "llama3" if mem["mem_available_gb"] >= need_gb else "phi3"
        if model_name != "llama3":
            print(f"memory phase: the host has {mem['mem_available_gb']:.1f} GB available, "
                  f"Llama-3-8B's levers need {need_gb:.1f} GB: running Phi3-mini instead")
        out["host"] = dict(mem, need_gb=need_gb, model=model_name)
        extra = [] if model_name == "llama3" else ["--model", "phi3", "--version", "llava_phi_3"]
        argv = [f"@{repo / 'recipes' / 'finetune.args'}", "--offload-opt-state",
                "--stream-grads", str(MEM_STREAM), "--data-path", data["ift"],
                "--image-folder", data["images"], "--tokenizer", "fake-whitespace",
                "--output-dir", str(root / "ift"), "--per-device-batch-size", str(RECIPE_BATCH),
                "--max-steps", str(RECIPE_STEPS), "--init-from", str(root / "init"), *extra]
        args = cli.build_argparser().parse_args(argv)
        cfg = cli.build_vlm_config(args)
        tok = cli.load_tokenizer("fake-whitespace")
        ds = SupervisedDataset(DataConfig(data["ift"], data["images"], args.image_aspect_ratio,
                                          cfg.vision.image_size, group_by_modality_length=True), tok, cfg)
        first = next(iter(BatchIterator(ds, RECIPE_BATCH, seed=0, seq_buckets=(1024, 2048, 4096))))
        seq = first["labels"].shape[1]
        lens = first["seq_lengths"].tolist()
        check(seq == 4096, f"memory IFT batch pads to T {seq}, not 4096")
        print(f"memory IFT batch seq_lengths {lens}")

        # B1-B3 at this batch's shape against their plain versions, SDPA the yardstick
        d = cfg.decoder
        out["b1"] = kernel_case("ift_t4096", RECIPE_BATCH, seq, d.num_heads, d.num_kv_heads,
                                d.head_dim, torch.bfloat16, True, [0] * RECIPE_BATCH, lens, gen, fa)
        out["b2"], out["b3"] = bwd_case("ift_t4096", RECIPE_BATCH, seq, d.num_heads, d.num_kv_heads,
                                        d.head_dim, True, [0] * RECIPE_BATCH, lens, gen, fa)
        release_cuda()

        progress("phase 15 (c) init checkpoint")
        src = init_vlm(cfg, device="cuda", seed=15)
        t0 = time.perf_counter()
        save_hf_checkpoint(str(root / "init"), src, cfg)
        save_s = time.perf_counter() - t0
        del src
        release_cuda()
        progress("phase 15 (c) cli.main")
        saves = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with mock.patch.object(CheckpointManager, "save",
                               lambda self, step, *a, **k: saves.append(step)):
            state = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        check(launches == per_step(d.num_layers, RECIPE_STEPS),
              f"memory IFT launches {launches}, expected {per_step(d.num_layers, RECIPE_STEPS)}")
        with open(root / "ift" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs]
        check([r["step"] for r in recs] == [1, 2, 3] and all(math.isfinite(x) for x in losses)
              and losses[2] != losses[1], f"memory IFT metrics {recs}")
        check(saves == [RECIPE_STEPS], f"memory IFT saves {saves}")
        opt, stream = state.optimizer, state.grad_stream
        check(type(opt).__name__ == "OffloadedAdamW" and stream is not None
              and len(stream.ranges) == MEM_STREAM, "memory IFT: the levers are not on")
        check(all(t.is_pinned() for k, t in opt.state_tensors().items() if t.device.type == "cpu"),
              "memory IFT: host state not page-locked")
        # one more step on a batch of the run, timed whole, with the update's own time
        dbatch = {k: v for k, v in first.items() if k != RAW_IMAGES}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        extra_loss = state(dbatch)["loss"]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
        update_ms = state.update_ms()
        check(math.isfinite(extra_loss), f"memory IFT: step 4 loss {extra_loss}")
        out["ift"] = dict(
            model=model_name, batch=RECIPE_BATCH, seq=seq, stream_grads=MEM_STREAM,
            losses=losses, step_ms=[1e3 / r["steps_per_sec"] for r in recs],
            timed_step_ms=step_ms, update_ms=update_ms, forward_backward_ms=step_ms - update_ms,
            run_s=run_s, init_checkpoint_write_s=save_s, peak_gib=peak / 2**30,
            pinned_gib=(opt.host_bytes + stream.host_bytes) / 2**30,
            launches_per_step={k: v // RECIPE_STEPS for k, v in launches.items()},
            trainable_params=sum(p.numel() for p in state.trainable.values()),
            card=smi)
        print("memory ift " + json.dumps(out["ift"]))

        progress("phase 15 (c) without the levers")
        # the same configuration without the levers
        stream.close()
        model = state.model
        del state, opt, stream
        release_cuda()
        where = None
        try:
            where = "optimizer state"
            plain = make_train_step(cfg, OptimizerConfig(learning_rate=2e-5, total_steps=RECIPE_STEPS,
                                                         stage="finetune"), model)
            where = "step"
            plain(dbatch)
            where = None
        except torch.OutOfMemoryError as e:
            out["without_levers"] = dict(
                fits=False, raised="torch.OutOfMemoryError", at=where,
                allocated_gib=torch.cuda.memory_allocated() / 2**30, message=str(e).splitlines()[0])
        check(where is not None, "memory IFT: the configuration without the levers fit on the card")
        print("memory without levers " + json.dumps(out["without_levers"]))
        for p in model.parameters():
            p.grad = None
        plain = model = None
        release_cuda()

        progress("phase 15 (d)")
        # (d) train/aot.py at (c)'s settings, through its command line, on
        # Phi3-mini: at Llama-3-8B its run pinned the moments on the host
        # once more (68.5 s of the script's 1,200)
        aot_out = root / "aot.jsonl"
        aot_layers = phi3_clip_vlm(distill=False).decoder.num_layers
        aot_argv = ["aot", "--model", "phi3", "--stage", "finetune", "--batch", str(RECIPE_BATCH),
                    "--seq", str(seq), "--offload-opt", "--stream-grads", str(MEM_STREAM), "--run",
                    "--out", str(aot_out)]
        reset_counts()
        saved_argv = sys.argv
        sys.argv = aot_argv
        sys.modules.pop("visper_lm_tpu_torch.train.aot", None)   # run as `python -m` would
        try:
            runpy.run_module("visper_lm_tpu_torch.train.aot", run_name="__main__")
        except SystemExit as e:
            check(e.code in (0, None), f"train.aot exited {e.code}")
        finally:
            sys.argv = saved_argv
        rep = json.loads(aot_out.read_text().strip().splitlines()[-1])
        aot_launches = counts()
        check(aot_launches == per_step(aot_layers, 2),
              f"train.aot --run launches {aot_launches}, expected {per_step(aot_layers, 2)}")
        # the static count of weights and on-card state, from the shapes, against
        # the allocator's reading once the run had set them up
        static = (rep["params_gib_per_chip"] + rep["frozen_gib_per_chip"]
                  + rep["opt_state_device_gib"])
        share = abs(static - rep["resident_hbm_gib"]) / rep["resident_hbm_gib"]
        check(share <= 0.05, f"train.aot's static {static:.3f} GiB on the card is {share:.3f} off "
                             f"the allocator's {rep['resident_hbm_gib']:.3f} GiB")
        check(all(math.isfinite(x) for x in rep["losses"]), f"train.aot --run losses {rep['losses']}")
        out["aot"] = dict(rep, static_resident_gib=static, static_vs_allocator_share=share,
                          launches=aot_launches)
        print("memory aot " + json.dumps(out["aot"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        release_cuda()
    return out


def dp_opt_cfg(stage: str):
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig

    return OptimizerConfig(learning_rate=DP_LR, warmup_ratio=0.0, total_steps=1000, stage=stage)


def dp_sample(t: torch.Tensor) -> torch.Tensor:
    """A fixed strided sample of a tensor's elements, f32 on the host."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // DP_SAMPLE)][:DP_SAMPLE].float().cpu()


def rel_fro(got: dict, ref: dict) -> float:
    """Relative Frobenius distance of two {name: tensor} sets as one vector."""
    num = sum(float((got[k].float() - r.float()).square().sum()) for k, r in ref.items())
    den = sum(float(r.float().square().sum()) for r in ref.values())
    return math.sqrt(num / den)


def deltas(after: dict, before: dict) -> dict:
    """{name: after - before} in f32: what the updates moved."""
    return {n: after[n].float() - b.float() for n, b in before.items()}


def delta_record(got: dict, ref: dict, f32, lr: float) -> dict:
    """One run's parameter moves against the one-process run's (and the f32
    run's, where there is one): relative Frobenius distances, the RMS
    difference per element in units of lr, the share of elements moved
    exactly alike."""
    n = sum(r.numel() for r in ref.values())
    sq = sum(float((got[k] - r).square().sum()) for k, r in ref.items())
    same = sum(int((got[k] == r).sum()) for k, r in ref.items())
    out = dict(rel_frobenius=rel_fro(got, ref), rms_over_lr=math.sqrt(sq / n) / lr,
               bit_equal_share=same / n)
    if f32 is not None:
        out["rel_frobenius_to_f32"] = rel_fro(got, f32)
    return out


def dp_grads(step) -> dict:
    """Arm `step` to keep, from its next update, each trainable's gradient
    as the optimizer's own `reduce_grads` leaves it (summed over the ranks:
    this rank's slice, or the whole leaf where it is replicated; in one
    process the gradient): {name: (sharded, dp_sample of the leaf with
    zeros outside this rank's slice)}, filled by that update."""
    opt, kept = step.optimizer, {}

    def reduce_grads(names, grads, reduced=()):
        del opt.reduce_grads                  # once: the class's method again
        opt.reduce_grads(names, grads, reduced)
        for n in names:
            pl = None if opt.zero is None else opt.zero.moments[n]
            if pl is None or not pl.sharded:
                kept[n] = (False, dp_sample(grads[n]))
                continue
            full = torch.zeros(opt.params[n].shape, dtype=grads[n].dtype, device=grads[n].device)
            mine = pl.local(full, opt.zero.rank)
            mine.copy_(grads[n].reshape(mine.shape))
            kept[n] = (True, dp_sample(full))

    opt.reduce_grads = reduce_grads
    return kept


def dp_reduced(per_rank: list) -> tuple:
    """The ranks' `dp_grads` as one {name: sample}: a sharded leaf's slices
    added, a replicated leaf from rank 0; and whether each replicated leaf
    came out bit-equal on every rank."""
    out, same = {}, True
    for n, (sharded, s) in per_rank[0].items():
        if sharded:
            out[n] = sum(kept[n][1] for kept in per_rank)
        else:
            out[n] = s
            same &= all(torch.equal(kept[n][1], s) for kept in per_rank[1:])
    return out, same


def dp_counters():
    from visper_lm_tpu_torch.ops import flash_attention as fa
    from visper_lm_tpu_torch.ops import window_attention as wa

    def reset():
        fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0

    def read():
        return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)

    return reset, read


def dp_steps(step, batches, reset, read) -> dict:
    """One update on each batch: each step's loss, ms (host clock to a
    synchronise), B1-B4 launches and (a MoE decoder) dropped share."""
    losses, ms, launches, dropped = [], [], [], []
    for batch in batches:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch)
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read())
        dropped.append(metrics.get("moe_dropped_frac"))
    return dict(losses=losses, step_ms=ms, launches=launches, dropped=dropped)


@torch.no_grad()
def dp_loss_at(step, batch) -> float:
    """The step's loss on `batch` at its current parameters, no update."""
    total, _ = step.loss_fn(step.model, step.to_device(batch), step.teacher_params)
    return float(total)


def dp_expected(layers: int, n_swin: int, batch: int) -> dict:
    """B1-B4 launches a save_gate step: the recompute runs the flash forward
    again; B4 once per Swin block and teacher micro-batch of 2."""
    return dict(flash_fwd=2 * layers, flash_bwd_dq=layers, flash_bwd_dkv=layers,
                window_attn=n_swin * batch // 2)


def dp_batches(cfg, pt: bool) -> list:
    """DP_STEPS global batches of B TRAIN_BATCH x T TRAIN_SEQ, one a step
    (seeds 0, 1, ...): config #1's PT batches, or full-length IFT rows."""
    from visper_lm_tpu_torch.tools.bench import bench_batch
    from visper_lm_tpu_torch.train import aot

    if pt:
        return [bench_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, True, seed=s) for s in range(DP_STEPS)]
    return [aot.full_length_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, with_teachers=False, seed=s)
            for s in range(DP_STEPS)]


def dp_rank(argv) -> int:
    """One of phase 16's two ranks (`chip_smoke.py --phase16-rank R PORT DIR`):
    both share the card over gloo (collectives staged through host memory).
    (b) the PT step of config #1 on its 2 rows of each global batch, as
    plain dp, zero_frozen and zero_params; (c) IFT at Phi3-mini with ZeRO-2
    moments. Writes what it measured to DIR/rank<R>.pt."""
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.train.train_step import make_train_step

    rank, port, root = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    D.init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0], device="cuda",
                       backend="gloo")
    mesh = D.make_global_mesh()
    lb = D.local_batch_size(TRAIN_BATCH)
    rows = slice(rank * lb, (rank + 1) * lb)
    dev = torch.device("cuda", 0)
    reset, read = dp_counters()
    out = dict(backend=str(torch.distributed.get_backend()), start_s=time.perf_counter() - t_start)

    def shards(batches):
        return [D.shard_batch_multihost({k: v[rows] for k, v in b.items()}, mesh, device=dev)
                for b in batches]

    def held(model, sharded, prefix=""):
        """Bytes of the parameters under `prefix` this rank keeps."""
        n = sum(p.untyped_storage().nbytes() for name, p in model.named_parameters()
                if name.startswith(prefix))
        if sharded is not None:
            n += sum(t.numel() * t.element_size() for name, t in sharded.shards.items()
                     if name.startswith(prefix))
        return n

    cfg = dp_config(distill=True)
    local = shards(dp_batches(cfg, pt=True))
    teachers = init_teachers(cfg, device=dev, seed=7)
    tfn = make_teacher_fn(cfg)
    for mode in DP_MODES:
        t0 = time.perf_counter()
        model = init_vlm(cfg, device=dev, seed=0)
        step = make_train_step(cfg, dp_opt_cfg("pretrain"), model, teacher_fn=tfn,
                               teacher_params=teachers, remat_policy="save_gate", mesh=mesh,
                               **({} if mode == "plain" else {mode: True}))
        rec = dict(persistent_gib=held(model, step.sharded) / 2**30,
                   decoder_gib=held(model, step.sharded, "decoder.") / 2**30,
                   sharded=0 if step.sharded is None else len(step.sharded.shards))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["grads"] = dp_grads(step)
        rec.update(dp_steps(step, local, reset, read))
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # collective under zero_params: every rank gathers, rank 0 keeps
        trained = {n: step.full_param(n).detach().cpu() for n in step.trainable}
        rec["trainables"] = trained if rank == 0 else None
        rec["seconds"] = time.perf_counter() - t0
        out[mode] = rec
        del step, model, trained
        release_cuda()
    del teachers
    release_cuda()

    # (c) IFT at Phi3-mini, ZeRO-2 moments
    t0 = time.perf_counter()
    cfg = dp_config(distill=False)
    local = shards(dp_batches(cfg, pt=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = init_vlm(cfg, device=dev, seed=0)
    step = make_train_step(cfg, dp_opt_cfg("finetune"), model, remat_policy="save_gate", mesh=mesh)
    opt = step.optimizer
    rec = dict(moments_gib=sum(t.numel() * t.element_size() for t in opt.state_tensors().values())
               / 2**30, sharded_moments=sum(pl.sharded for pl in step.zero.moments.values()),
               trainables=len(step.trainable))
    rec["init"] = {n: dp_sample(p) for n, p in step.trainable.items()} if rank == 0 else None
    rec["grads"] = dp_grads(step)
    rec.update(dp_steps(step, local, reset, read))
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["samples"] = {n: dp_sample(p) for n, p in step.trainable.items()} if rank == 0 else None
    rec["seconds"] = time.perf_counter() - t0
    out["ift"] = rec
    del step, model, opt
    release_cuda()
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, root / f"rank{rank}.pt")
    D.barrier()
    D.shutdown()
    return 0


def dp_config(distill: bool):
    """Phases 16-17's Phi3-mini + CLIP-L (config #1 with distill), cut to
    DP_LAYERS layers with its taps inside them (DP_TAPS)."""
    import dataclasses

    from visper_lm_tpu_torch.config import make_distill_config, phi3_clip_vlm

    cfg = phi3_clip_vlm(distill=distill)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=DP_LAYERS))
    if distill:
        cfg = dataclasses.replace(cfg, distill=make_distill_config(layer_indices=DP_TAPS))
    return cfg


def f32_student(cfg, model, names, batches, stage, teachers=None, tfn=None) -> tuple:
    """The tolerance run of phases 16-17: `model` cast to f32 in place, the
    plain path, AdamW on `names` over the batches. Returns (losses, step-1
    gradients' dp_sample, the trainables after the updates on the host)."""
    from visper_lm_tpu_torch.train.optimizer import AdamW
    from visper_lm_tpu_torch.train.train_step import make_loss_fn

    model.float()
    loss_fn = make_loss_fn(cfg, teacher_fn=tfn, use_kernel=False)
    params = dict(model.named_parameters())
    opt_f = AdamW(((n, params[n]) for n in names), dp_opt_cfg(stage))
    losses_f, g_f = [], None
    dev = next(model.parameters()).device
    for batch in batches:
        dbatch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(loss_fn, model, dbatch, teachers,
                                     [params[n] for n in names])
        # a trainable the loss does not reach has a zero gradient, as the step gives it
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        if g_f is None:
            g_f = {n: dp_sample(g) for n, g in grads.items()}
        opt_f.step(grads)
        losses_f.append(loss)
        del grads, dbatch
    return losses_f, g_f, {n: params[n].detach().cpu() for n in names}


def lora_references(reset, read) -> dict:
    """Phase 17 (g)'s references: the one-process LoRA step (save_gate) on
    phase 16's IFT batches, and the f32 run from the same weights."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.train_step import make_train_step

    cfg = tp_lora_config()
    batches = dp_batches(cfg, pt=False)
    model = init_vlm(cfg, device="cuda", seed=0)
    step = make_train_step(cfg, dp_opt_cfg("lora"), model, remat_policy="save_gate")
    names = list(step.trainable)
    p0 = {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in step.trainable.items()}
    still = dp_loss_at(step, batches[-1])
    kept = dp_grads(step)
    torch.cuda.reset_peak_memory_stats()
    one = dp_steps(step, batches, reset, read)
    one["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    p_1 = {n: p.detach().to("cpu", copy=True) for n, p in step.trainable.items()}
    with torch.no_grad():
        for n, p in step.trainable.items():
            p.copy_(p0[n])
    del step
    losses_f, g_f, p_f = f32_student(cfg, model, names, batches, "lora")
    move_1, move_f = deltas(p_1, p0), deltas(p_f, p0)
    ref = dict(losses=one["losses"], losses_f=losses_f, step_ms=one["step_ms"],
               peak_gib=one["peak_gib"], still=still, p0=p0, move_1=move_1, move_f=move_f,
               e_1=rel_fro(move_1, move_f), g_f=g_f, launches=one["launches"],
               d_grad=rel_fro({n: s for n, (_, s) in kept.items()}, g_f),
               trainables=sum(v.numel() for v in p0.values()))
    del model
    release_cuda()
    return ref


def dp_phase(smi: str, keep=None) -> dict:
    """Phase 16: data parallelism and ZeRO on the card (see the module
    docstring). Returns the record printed as `dp_path`; `keep` gets the
    one-process PT step's references (phase 17 (b) holds its ranks to them)."""
    import shutil

    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.train.train_step import make_train_step

    root = Path(__file__).resolve().parent / "tmp" / "chip_smoke_dp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    reset, read = dp_counters()
    out = dict(card=smi)
    cfg = dp_config(distill=True)
    batches = dp_batches(cfg, pt=True)
    # (b)-(c)'s two ranks start now and wait for the references below
    held = start_ranks("--phase16-rank", 2, root, hold=True)
    try:
        # the one-process PT step of config #1 (phase 8's, save_gate), from seeds
        t0 = time.perf_counter()
        model = init_vlm(cfg, device="cuda", seed=0)
        teachers = init_teachers(cfg, device="cuda", seed=7)
        n_swin = sum(teachers["swin"].cfg.depths)
        tfn = make_teacher_fn(cfg)

        def pt_step(**kw):
            return make_train_step(cfg, dp_opt_cfg("pretrain"), model, teacher_fn=tfn,
                                   teacher_params=teachers, remat_policy="save_gate", **kw)

        step = pt_step()
        names = list(step.trainable)
        init = {n: p.detach().clone() for n, p in step.trainable.items()}
        p0 = {n: p.float().cpu() for n, p in init.items()}

        def restore():
            params = dict(model.named_parameters())
            with torch.no_grad():
                for n in names:
                    params[n].copy_(init[n])

        # the last batch's loss before any update: how far the updates move it
        still = dp_loss_at(step, batches[-1])
        kept = dp_grads(step)
        torch.cuda.reset_peak_memory_stats()
        one = dp_steps(step, batches, reset, read)
        one["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        g_1 = {n: s for n, (_, s) in kept.items()}
        p_1 = {n: p.detach().cpu() for n, p in step.trainable.items()}
        want = dp_expected(cfg.decoder.num_layers, n_swin, TRAIN_BATCH)
        check(all(c == want for c in one["launches"]),
              f"one-process PT step launches {one['launches']}, expected {want} a step")

        # (a) a one-rank NCCL group: the same step, its collectives on the card
        restore()
        D.init_distributed(f"localhost:{free_port()}", 1, 0, device="cuda")
        backend_a = str(torch.distributed.get_backend())
        check(backend_a == "nccl", f"phase 16 (a): backend {backend_a}, expected nccl")
        del step
        step = pt_step(mesh=D.make_global_mesh())
        check(step.zero is not None and step.zero.size == 1, "phase 16 (a): no data-parallel step")
        grp = dp_steps(step, batches, reset, read)
        p_a = {n: p.detach().cpu() for n, p in step.trainable.items()}
        D.shutdown()
        check(all(c == want for c in grp["launches"]),
              f"phase 16 (a) launches {grp['launches']}, expected {want} a step")
        same = grp["losses"] == one["losses"] and all(torch.equal(p_a[n], p_1[n]) for n in names)
        for a, b in zip(grp["losses"], one["losses"]):
            check(abs(a - b) <= 1e-5 * abs(b), f"phase 16 (a): loss {a} vs {b} without a group")
        for n in names:
            check(torch.allclose(p_a[n].float(), p_1[n].float(), rtol=1e-4, atol=1e-6),
                  f"phase 16 (a): {n} differs from the step without a group")
        out["a"] = dict(backend=backend_a, losses=grp["losses"], losses_no_group=one["losses"],
                        bit_equal=same, step_ms=grp["step_ms"], step_ms_no_group=one["step_ms"],
                        launches_per_step=grp["launches"][-1])
        print(f"phase 16 (a) one-rank {backend_a} group: losses {grp['losses']} (no group "
              f"{one['losses']}), bit-equal {same}, step ms {grp['step_ms'][-1]:.1f} (no group "
              f"{one['step_ms'][-1]:.1f}), B1-B4 a step {grp['launches'][-1]} [{smi}]")
        del p_a, step

        # the tolerance of two bf16 runs, from an f32 run of the student
        # (plain attention) from the same weights on the same batches: its
        # losses, step-1 gradients and parameter moves against the bf16
        # one-process run's
        restore()
        losses_f, g_f, p_f = f32_student(cfg, model, names, batches, "pretrain", teachers, tfn)
        move_1, move_f = deltas(p_1, p0), deltas(p_f, p0)
        d_loss = [abs(a - f) / abs(f) for a, f in zip(one["losses"], losses_f)]
        d_grad = rel_fro(g_1, g_f)
        e_1 = rel_fro(move_1, move_f)
        out["f32"] = dict(losses=losses_f, losses_bf16=one["losses"], loss_rel=d_loss,
                          grads_rel_frobenius=d_grad, moves_rel_frobenius=e_1)
        print(f"phase 16 f32 student: losses {losses_f}, bf16 one-process {one['losses']} (rel "
              f"{', '.join(f'{x:.3g}' for x in d_loss)}); step-1 gradients rel Frobenius "
              f"{d_grad:.4g}; parameter moves after {DP_STEPS} updates rel Frobenius {e_1:.4g}")
        # the bounds below must tell a wrong update from a right one: the
        # last batch's loss moves well beyond its tolerance, and a move of
        # 0 (at distance 1) stays outside the moves' bounds
        tol_last = 2 * abs(one["losses"][-1] - losses_f[-1]) + 1e-4 * abs(one["losses"][-1])
        moved = abs(one["losses"][-1] - still)
        check(moved > 3 * tol_last, f"phase 16: the updates move the last loss {moved:.3g}, "
              f"not beyond 3 x its tolerance {tol_last:.3g}")
        check(3 * e_1 + 1e-2 <= 0.75, f"phase 16: bf16 moves {e_1:.3g} from f32, too far to "
              f"tell an update from none")
        if keep is not None:
            keep.update(cfg=cfg, batches=batches, losses=one["losses"], losses_f=losses_f,
                        p0=p0, move_1=move_1, move_f=move_f, e_1=e_1, g_f=g_f, d_grad=d_grad,
                        launches=want)
        del model, teachers, init
        release_cuda()
        pt_s = time.perf_counter() - t0

        # the one-process IFT step at Phi3-mini: (c)'s reference
        t0 = time.perf_counter()
        cfg_i = dp_config(distill=False)
        batches_i = dp_batches(cfg_i, pt=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = init_vlm(cfg_i, device="cuda", seed=0)
        step = make_train_step(cfg_i, dp_opt_cfg("finetune"), model, remat_policy="save_gate")
        s_0 = {n: dp_sample(p) for n, p in step.trainable.items()}
        still_i = dp_loss_at(step, batches_i[-1])
        kept = dp_grads(step)
        ift_1 = dp_steps(step, batches_i, reset, read)
        ift_1["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        g_i1 = {n: s for n, (_, s) in kept.items()}
        move_i1 = deltas({n: dp_sample(p) for n, p in step.trainable.items()}, s_0)
        trainables_i = sum(p.numel() for p in step.trainable.values())
        del step, model, kept
        release_cuda()
        ift_s = time.perf_counter() - t0

        # (b) and (c): two ranks share the card
        t0 = time.perf_counter()
        ranks = wait_ranks(held, "phase 16")
        ranks_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks), "phase 16: the ranks did not run gloo")

        # (b): each mode held to the one-process step and to the f32 run
        want_r = dp_expected(cfg.decoder.num_layers, n_swin, TRAIN_BATCH // 2)
        b = {}
        for mode in DP_MODES:
            recs = [r[mode] for r in ranks]
            check(recs[0]["losses"] == recs[1]["losses"],
                  f"phase 16 (b) {mode}: the ranks' losses differ {recs[0]['losses']} "
                  f"{recs[1]['losses']}")
            for rr in recs:
                check(all(c == want_r for c in rr["launches"]),
                      f"phase 16 (b) {mode}: launches {rr['launches']}, expected {want_r}")
            for a, c, f in zip(recs[0]["losses"], one["losses"], losses_f):
                check(abs(a - c) <= 2 * abs(c - f) + 1e-4 * abs(c),
                      f"phase 16 (b) {mode}: loss {a} vs one process {c} (f32 {f})")
            g_m, replicas_equal = dp_reduced([rr["grads"] for rr in recs])
            check(replicas_equal, f"phase 16 (b) {mode}: a replicated gradient differs between "
                  "the ranks")
            d_grad_m = rel_fro(g_m, g_f)
            check(d_grad_m <= d_grad + 1e-2,
                  f"phase 16 (b) {mode}: reduced gradients {d_grad_m:.4g} from f32 (one process "
                  f"{d_grad:.4g})")
            moves = delta_record(deltas(recs[0]["trainables"], p0), move_1, move_f, DP_LR)
            check(moves["rel_frobenius_to_f32"] <= 2 * e_1 + 1e-3 and
                  moves["rel_frobenius"] <= 3 * e_1 + 1e-3,
                  f"phase 16 (b) {mode}: parameter moves {moves} (one process {e_1:.4g} from f32)")
            b[mode] = dict(
                losses=recs[0]["losses"], grads_rel_frobenius_to_f32=d_grad_m, moves=moves,
                ranks=[dict(peak_gib=rr["peak_gib"], persistent_gib=rr["persistent_gib"],
                            decoder_gib=rr["decoder_gib"], sharded=rr["sharded"],
                            launches_per_step=rr["launches"][-1], step_ms=rr["step_ms"],
                            seconds=rr["seconds"]) for rr in recs])
            for r, rr in enumerate(b[mode]["ranks"]):
                print(f"phase 16 (b) {mode} rank {r}: peak {rr['peak_gib']:.2f} GiB, parameters "
                      f"held {rr['persistent_gib']:.3f} GiB (decoder {rr['decoder_gib']:.3f}), "
                      f"B1-B4 a step {rr['launches_per_step']}, step ms "
                      f"{', '.join(f'{x:.1f}' for x in rr['step_ms'])} [{smi}]")
            print(f"phase 16 (b) {mode}: losses {recs[0]['losses']} (one process {one['losses']}); "
                  f"reduced step-1 gradients rel Frobenius to f32 {d_grad_m:.4g} (one process "
                  f"{d_grad:.4g}, bound + 1e-2); parameter moves {json.dumps(moves)} (bounds "
                  f"{2 * e_1 + 1e-3:.4g} to f32, {3 * e_1 + 1e-3:.4g} to one process)")
        dec_plain = b["plain"]["ranks"][0]["decoder_gib"]
        for r in range(2):
            share = b["zero_frozen"]["ranks"][r]["decoder_gib"] / dec_plain
            check(0.45 <= share <= 0.55, f"phase 16 (b): zero_frozen keeps {share:.3f} of the decoder")
        out["b"] = b
        out["one_process_pt"] = dict(losses=one["losses"], loss_before_updates=still,
                                     step_ms=one["step_ms"], peak_gib=one["peak_gib"])

        # (c): IFT at Phi3-mini, dp 2, ZeRO-2 moments. No f32 run fits beside
        # it: its bounds take (b)'s f32 distances (the same bf16 decoder), with
        # 1e-2 of room for the backward through all of it, and a tenth of the
        # loss's move
        recs = [r["ift"] for r in ranks]
        check(recs[0]["losses"] == recs[1]["losses"], "phase 16 (c): the ranks' losses differ")
        want_i = dp_expected(cfg_i.decoder.num_layers, 0, 0)
        for rr in recs + [ift_1]:
            check(all(c == want_i for c in rr["launches"]),
                  f"phase 16 (c): launches {rr['launches']}, expected {want_i}")
        check(all(torch.equal(recs[0]["init"][n], s) for n, s in s_0.items()),
              "phase 16 (c): the ranks start from other weights")
        moved_i = abs(ift_1["losses"][-1] - still_i)
        tol_i = [(2 * max(d_loss) + 1e-4) * abs(c) + 0.1 * moved_i for c in ift_1["losses"]]
        check(tol_i[-1] < 0.5 * moved_i, f"phase 16 (c): the updates move the last loss "
              f"{moved_i:.3g}, not beyond twice its tolerance {tol_i[-1]:.3g}")
        for a, c, t in zip(recs[0]["losses"], ift_1["losses"], tol_i):
            check(abs(a - c) <= t, f"phase 16 (c): loss {a} vs one process {c} (bound {t:.3g})")
        g_c, replicas_equal = dp_reduced([rr["grads"] for rr in recs])
        check(replicas_equal, "phase 16 (c): a replicated gradient differs between the ranks")
        d_grad_c = rel_fro(g_c, g_i1)
        check(d_grad_c <= 2 * d_grad + 1e-2,
              f"phase 16 (c): reduced gradients {d_grad_c:.4g} from the one-process run's")
        moves_c = delta_record(deltas(recs[0]["samples"], recs[0]["init"]), move_i1, None, DP_LR)
        check(moves_c["rel_frobenius"] <= 3 * e_1 + 1e-2,
              f"phase 16 (c): parameter moves {moves_c} (bound {3 * e_1 + 1e-2:.4g})")
        out["c"] = dict(trainables=trainables_i, losses=recs[0]["losses"],
                        losses_one_process=ift_1["losses"], loss_before_updates=still_i,
                        grads_rel_frobenius=d_grad_c, moves=moves_c,
                        one_process=dict(peak_gib=ift_1["peak_gib"], step_ms=ift_1["step_ms"]),
                        ranks=[dict(peak_gib=rr["peak_gib"], moments_gib=rr["moments_gib"],
                                    sharded_moments=rr["sharded_moments"], step_ms=rr["step_ms"],
                                    launches_per_step=rr["launches"][-1]) for rr in recs])
        for r, rr in enumerate(out["c"]["ranks"]):
            print(f"phase 16 (c) IFT rank {r}: peak {rr['peak_gib']:.2f} GiB (one process "
                  f"{ift_1['peak_gib']:.2f}), moments {rr['moments_gib']:.2f} GiB, step ms "
                  f"{', '.join(f'{x:.1f}' for x in rr['step_ms'])}, B1-B3 a step "
                  f"{rr['launches_per_step']} [{smi}]")
        print(f"phase 16 (c): losses {recs[0]['losses']} (one process {ift_1['losses']}; last "
              f"batch before the updates {still_i:.6f}), {trainables_i / 1e9:.3f} B trainables, "
              f"reduced step-1 gradients rel Frobenius {d_grad_c:.4g} (bound "
              f"{2 * d_grad + 1e-2:.4g}), sampled parameter moves {json.dumps(moves_c)} (bound "
              f"{3 * e_1 + 1e-2:.4g})")
        out["seconds_by_part"] = dict(pt_one_process_a_f32=pt_s, ift_one_process=ift_s,
                                      ranks=ranks_s, rank_start=[r["start_s"] for r in ranks])
    finally:
        stop_ranks(held)
        D.shutdown()
        shutil.rmtree(root, ignore_errors=True)
        release_cuda()
    return out


@torch.no_grad()
def greedy_margins(generator, batch, n: int, use_kernel=None):
    """Greedy decoding of `n` tokens a row through the Generator's prefill
    (use_kernel=False: plain attention) and its decoder (a step at a time),
    with each step's top-2 logit margin: ((n, B) tokens, (n, B) margins) on
    the host."""
    logits, cache = generator.prefill(batch, use_kernel=use_kernel)
    offsets = torch.as_tensor(batch["pad_offsets"], device=generator.device).long()
    b = offsets.shape[0]
    tokens, margins = [], []
    for i in range(n):
        top = logits.topk(2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).float().cpu())
        token = logits.argmax(-1)
        tokens.append(token.cpu())
        if i + 1 == n:
            break
        slot = torch.full((), generator.prompt_len + i, dtype=torch.long, device=generator.device)
        dec = generator.decoder
        out = dec(dec.embed(token[:, None]), positions=(slot - offsets)[:, None],
                  kv_lengths=(slot + 1).expand(b), kv_starts=offsets, cache=cache, q_offset=slot)
        logits = out["logits"][:, 0]
    return torch.stack(tokens), torch.stack(margins)


def decoder_bytes(model) -> int:
    """Bytes of the decoder's parameters this process holds."""
    return sum(p.numel() * p.element_size() for p in model.decoder.parameters())


def held_bytes(params) -> int:
    """Bytes of the storage behind `params` (a freed ZeRO / teacher slice holds 0)."""
    return sum(p.untyped_storage().nbytes() for p in params)


def tp_gen_config():
    """Phase 17 (a)'s Phi3-mini + CLIP-L, cut to TP_GEN_LAYERS layers (time)."""
    import dataclasses

    from visper_lm_tpu_torch.config import phi3_clip_vlm

    cfg = phi3_clip_vlm(distill=True)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                                num_layers=TP_GEN_LAYERS))


def tp_lora_config():
    """Phase 17 (g)'s Phi3-mini + CLIP-L at DP_LAYERS layers with phase 12's
    LoRA adapters (r 64, alpha 16, all seven targets)."""
    import dataclasses

    from visper_lm_tpu_torch.config import LoraConfig

    return dataclasses.replace(dp_config(distill=False), lora=LoraConfig())


def margin_rule(name: str, got: list, want: list, margins: list, tol: float) -> tuple:
    """Phase 17's rule for greedy tokens that ran in other arithmetic: each
    row of `got` equals `want` through the first position where the
    one-process top-2 logit margin (`margins`, a list a row) falls under
    `tol`. Fails the phase otherwise. Returns (agree, first_low): per row
    the first position that differs and the first low-margin position."""
    first_low = [next((j for j, m in enumerate(row) if m < tol), len(row)) for row in margins]
    agree = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), len(w))
             for g, w in zip(got, want)]
    check(all(a >= f for a, f in zip(agree, first_low)),
          f"{name}: tokens differ at {agree} before the first position where the one-process "
          f"top-2 margin falls under {tol:.4g} ({first_low})")
    return agree, first_low


def divergence_note(agree: list, margins: list) -> str:
    """The first differing position of each row that differs, with the
    one-process margin there."""
    notes = [f"row {i} at {a} (margin {margins[i][a]:.4g})"
             for i, a in enumerate(agree) if a < len(margins[i])]
    return "; ".join(notes) or "none"


@torch.no_grad()
def forced_margins(generator, batch, forced: list) -> list:
    """The top-2 logit margins along given token rows (teacher forcing
    through the Generator's prefill and decoder, a step at a time): a list
    a row of len(forced[i]) margins, position j's taken before token j."""
    logits, cache = generator.prefill(batch)
    offsets = torch.as_tensor(batch["pad_offsets"], device=generator.device).long()
    b, n = offsets.shape[0], max(len(f) for f in forced)
    rows = torch.tensor([f + [0] * (n - len(f)) for f in forced], device=generator.device)
    margins = []
    dec = generator.decoder
    for i in range(n):
        top = logits.topk(2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).float().cpu())
        if i + 1 == n:
            break
        slot = torch.full((), generator.prompt_len + i, dtype=torch.long, device=generator.device)
        out = dec(dec.embed(rows[:, i:i + 1]), positions=(slot - offsets)[:, None],
                  kv_lengths=(slot + 1).expand(b), kv_starts=offsets, cache=cache, q_offset=slot)
        logits = out["logits"][:, 0]
    m = torch.stack(margins)
    return [m[:len(f), r].tolist() for r, f in enumerate(forced)]


@torch.no_grad()
def batch1_greedy_margins(decoder, prompt: list, n: int) -> tuple:
    """Greedy decoding of one prompt, a token at a time through the cache
    route (as the speculative and beam decoders run): (tokens, margins)."""
    from visper_lm_tpu_torch.models.decoder import init_kv_cache
    from visper_lm_tpu_torch.serve.speculative import _chunk_forward

    cache = init_kv_cache(decoder.cfg, 1, 512, device=decoder.embed_tokens.weight.device,
                          tp=decoder.tp_size)
    logits, p, tokens, margins = _chunk_forward(decoder, prompt, cache, 0)[-1], len(prompt), [], []
    for _ in range(n):
        top = logits.topk(2).values
        margins.append(float(top[0] - top[1]))
        tokens.append(int(logits.argmax()))
        logits = _chunk_forward(decoder, tokens[-1:], cache, p)[-1]
        p += 1
    return tokens, margins


def half_draft(target):
    """Phase 9's draft: the target's first half of the blocks with its
    embedding, final norm and head (tensor parallel as the target is)."""
    import dataclasses

    from visper_lm_tpu_torch.models.decoder import Decoder
    from visper_lm_tpu_torch.parallel.tensor import set_tensor_parallel

    d = target.cfg
    with torch.device("meta"):
        draft = Decoder(dataclasses.replace(d, num_layers=d.num_layers // 2))
    draft.embed_tokens, draft.final_norm, draft.lm_head = (
        target.embed_tokens, target.final_norm, target.lm_head)
    draft.blocks = torch.nn.ModuleList(target.blocks[:d.num_layers // 2])
    if target.tp is not None:
        own = dict(draft.named_parameters())
        set_tensor_parallel(draft, target.tp, {n: pl for n, pl in target.tp_plan.items()
                                               if n in own}, {})
    return draft.eval()


def spec_prompt(cfg) -> list:
    return np.random.default_rng(1).integers(3, cfg.decoder.vocab_size - 10, size=128).tolist()


@torch.no_grad()
def serving_checks(model, cfg, batch, dev, reset, read, margins: bool = False) -> dict:
    """Phase 17 (d)-(f) on one model (a tp rank's or one process's): (d) the
    Generator with AWQ-calibrated int4 weights, (e) the Engine at
    bench_engine.py's defaults with int8 KV + w8a16 on TP_ENGINE_REQUESTS
    of its workload, (f) speculative, prompt-lookup and beam decoding at
    batch 1. Returns what each measured; with margins (the one-process
    reference) also the top-2 logit margins along (d)'s and (e)'s tokens and
    along (f)'s greedy path."""
    from visper_lm_tpu_torch.models.vlm import encode_images, splice_embeddings
    from visper_lm_tpu_torch.ops import quant_matmul as qm
    from visper_lm_tpu_torch.serve.beam import BeamSearchDecoder
    from visper_lm_tpu_torch.serve.calibrate import decoder_act_rms
    from visper_lm_tpu_torch.serve.engine import Engine, EngineConfig, Request
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator
    from visper_lm_tpu_torch.serve.speculative import PromptLookupDecoder, SpeculativeDecoder
    from visper_lm_tpu_torch.tools.bench_engine import request_mix

    out = {}
    # (d): calibrated on the batch through this model's decoder, then int4
    t0 = time.perf_counter()
    gen = Generator(model, cfg, GenerationConfig(), BATCH, PROMPT_LEN, device=dev)
    b = gen._to_device(batch)
    embeds = splice_embeddings(model, b["text_ids"].long(), b["token_type"],
                               b["src_index"].long(), encode_images(model, b["images"]))
    act_rms = decoder_act_rms(model.decoder, cfg.decoder, [embeds])
    del embeds, b, gen
    q_gen = Generator(model, cfg, GenerationConfig(max_new_tokens=TP_NEW_TOKENS,
                                                   weight_quant="int4", calibration=act_rms),
                      BATCH, PROMPT_LEN, device=dev)
    torch.cuda.synchronize()
    rec = dict(quantize_s=time.perf_counter() - t0, decoder_gib=(
        sum(t.numel() * t.element_size() for t in q_gen.decoder.parameters())
        + sum(t.numel() * t.element_size() for t in q_gen.decoder.buffers())) / 2**30)
    q_gen.prefill(batch)                       # warm-up
    reset()
    qm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = q_gen.prefill(batch)
    torch.cuda.synchronize()
    rec.update(prefill_ms=(time.perf_counter() - t0) * 1e3, w4_per_forward=qm.launches,
               prefill_launches=read()["flash_fwd"], logits=logits.float().cpu())
    qm.launches = 0
    t0 = time.perf_counter()
    rec["tokens"] = q_gen.generate(batch)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    chunk = q_gen.gen_cfg.decode_chunk
    rec["forwards"] = 1 + -(-TP_NEW_TOKENS // chunk) * chunk
    rec["w4_generate"] = qm.launches
    rec["decode_ms_per_token"] = (gen_ms - rec["prefill_ms"]) / (rec["forwards"] - 1)
    if margins:
        rec["margins"] = forced_margins(q_gen, batch, rec["tokens"])
    out["d"] = rec
    del q_gen, logits, act_rms
    release_cuda()

    # (e): the Engine, int8 KV + w8a16
    work = request_mix(cfg, np.random.default_rng(0), TP_ENGINE_REQUESTS, ENGINE["max_len"])
    eng = Engine(model, cfg, EngineConfig(**ENGINE, kv_quant=True, weight_quant=True), device=dev)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run([Request(plan=p, images=im, max_new_tokens=n, uid=i)
                    for i, (p, im, n) in enumerate(work)])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    tokens = {r.uid: r.output_ids for r in done}
    out["e"] = dict(tokens=[tokens[i] for i in range(len(work))], seconds=sec,
                    tokens_per_s=sum(len(t) for t in tokens.values()) / sec,
                    steps=eng.stats["steps"], prefills=eng.stats["prefills"],
                    dispatches=eng.stats["admit_dispatches"],
                    b1_launches=read()["flash_fwd"], cache_heads=int(eng.cache.k.shape[3]))
    del eng, done
    release_cuda()
    if margins:
        from visper_lm_tpu_torch.serve.generate import left_pad_plans

        pad_to = -(-max(p.seq_length for p, _, _ in work) // 128) * 128
        batch_e = left_pad_plans([p for p, _, _ in work], pad_to)
        batch_e["images"] = np.concatenate([im for _, im, _ in work])
        gen = Generator(model, cfg, GenerationConfig(kv_quant=True, weight_quant=True),
                        len(work), pad_to, device=dev)
        out["e"]["margins"] = forced_margins(gen, batch_e, out["e"]["tokens"])
        del gen
        release_cuda()

    # (f): batch 1, the half-depth draft, prompt lookup, 2 beams
    target, prompt = model.decoder, spec_prompt(cfg)
    t0 = time.perf_counter()
    spec, st = SpeculativeDecoder(target, half_draft(target), k=4, max_len=512).generate(
        prompt, max_new_tokens=TP_SPEC_TOKENS)
    lookup, _ = PromptLookupDecoder(target, k=4, max_len=512).generate(
        prompt, max_new_tokens=TP_SPEC_TOKENS)
    beam, score = BeamSearchDecoder(target, num_beams=TP_BEAMS, max_len=512).generate(
        prompt, max_new_tokens=TP_SPEC_TOKENS)
    torch.cuda.synchronize()
    out["f"] = dict(spec=spec, lookup=lookup, beam=beam, beam_score=score,
                    acceptance=st.acceptance_rate, seconds=time.perf_counter() - t0)
    if margins:
        out["f"]["greedy"], out["f"]["margins"] = batch1_greedy_margins(target, prompt,
                                                                       TP_SPEC_TOKENS)
    return out


def tp_lora_rank(mesh, tp, dev, rank: int, reset, read) -> dict:
    """Phase 17 (g) on one rank: `tp_lora_config`'s LoRA stage at tp on
    phase 16's IFT batches (save_gate): losses, step ms, launches, the
    reduced gradients' samples, peak GiB, whether every trainable is the
    same bytes on both ranks, and (rank 0) the trainables after the updates."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    cfg = tp_lora_config()
    local = [D.shard_batch_multihost(b, mesh, device=dev) for b in dp_batches(cfg, pt=False)]
    model = init_vlm(cfg, device=dev, seed=0, tp=tp)
    step = make_train_step(cfg, dp_opt_cfg("lora"), model, remat_policy="save_gate", mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = dict(grads=dp_grads(step))
    rec.update(dp_steps(step, local, reset, read))
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    same = True
    for p in step.trainable.values():
        mine = p.detach().contiguous()
        same &= bool(torch.equal(mine, D.broadcast(mine.clone(), 0)))
    rec["replicas_bit_equal"] = same
    rec["trainables"] = ({n: p.detach().cpu() for n, p in step.trainable.items()}
                         if rank == 0 else None)
    rec["seconds"] = time.perf_counter() - t0
    del step, model
    release_cuda()
    return rec


def tp_rank(argv) -> int:
    """One of phase 17's two tensor-parallel ranks (`chip_smoke.py
    --phase17-rank R PORT DIR`, dp 1 x tp 2 sharing the card over gloo):
    (a) the Generator at Phi3-mini + CLIP-L, full width and depth, bf16, on
    phase 4's batch; (b) config #1's PT step (phase 16's depth-cut model)
    with and without shard_teachers on phase 16's 3 global batches. Writes
    what it measured to DIR/rank<R>.pt."""
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.parallel.tensor import tensor_parallel
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator
    from visper_lm_tpu_torch.train.train_step import make_train_step

    rank, port, root = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    D.init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0], device="cuda",
                       backend="gloo")
    mesh = D.make_global_mesh(dp=1, tp=2)
    tp = tensor_parallel(mesh)
    dev = torch.device("cuda", 0)
    reset, read = dp_counters()
    out = dict(backend=str(torch.distributed.get_backend()), start_s=time.perf_counter() - t_start)

    # (a) serving: each rank half the heads and the MLP, the logits gathered
    cfg = tp_gen_config()
    batch = main_path_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_vlm(cfg, device=dev, seed=0, tp=tp)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    rec = dict(init_s=time.perf_counter() - t0, init_peak_gib=init_peak / 2**30,
               decoder_gib=decoder_bytes(model) / 2**30)
    generator = Generator(model, cfg, GenerationConfig(max_new_tokens=TP_NEW_TOKENS), BATCH,
                          PROMPT_LEN, device=dev)
    generator.prefill(batch)                       # warm-up
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = generator.prefill(batch)
    torch.cuda.synchronize()
    rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    rec["prefill_launches"] = read()["flash_fwd"]
    rec["cache_heads"] = int(cache.k.shape[3])
    rec["logits"] = logits.float().cpu()
    del cache
    t0 = time.perf_counter()
    rec["tokens"] = generator.generate(batch)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3
    steps = -(-TP_NEW_TOKENS // generator.gen_cfg.decode_chunk) * generator.gen_cfg.decode_chunk
    rec["decode_ms_per_token"] = (gen_ms - rec["prefill_ms"]) / steps
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["a"] = rec
    del generator, logits
    release_cuda()

    # (d)-(f): int4 + AWQ, the Engine, speculative / prompt-lookup / beam
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out["serving"] = serving_checks(model, cfg, batch, dev, reset, read)
    out["serving"].update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          seconds=time.perf_counter() - t0)
    del model
    release_cuda()
    if rank == 0:
        # (a) and (d)-(f)'s timings are taken: (c)'s spawn may share the card
        # with (b) and (g) from here
        (root / "serving_done.tmp").write_text("")
        (root / "serving_done.tmp").rename(root / "serving_done")

    # (b) config #1's PT step, the whole global batch on each rank
    cfg = dp_config(distill=True)
    local = [D.shard_batch_multihost(b, mesh, device=dev) for b in dp_batches(cfg, pt=True)]
    tfn = make_teacher_fn(cfg)
    for mode in TP_MODES:
        t0 = time.perf_counter()
        teachers = init_teachers(cfg, device=dev, seed=7)
        teacher_whole = held_bytes(teachers.parameters())
        model = init_vlm(cfg, device=dev, seed=0, tp=tp)
        step = make_train_step(cfg, dp_opt_cfg("pretrain"), model, teacher_fn=tfn,
                               teacher_params=teachers, remat_policy="save_gate", mesh=mesh,
                               shard_teachers=mode == "shard_teachers")
        held_t = held_bytes(teachers.parameters())
        if step.teacher_sharded is not None:
            held_t += step.teacher_sharded.shard_bytes
        rec = dict(decoder_gib=decoder_bytes(model) / 2**30, teachers_gib=held_t / 2**30,
                   teachers_whole_gib=teacher_whole / 2**30)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec["grads"] = dp_grads(step)
        rec.update(dp_steps(step, local, reset, read))
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # every trainable is replicated over tp (PT trains no Megatron leaf):
        # rank 0's bytes against this rank's, whole
        same = True
        for p in step.trainable.values():
            mine = p.detach().contiguous()
            theirs = D.broadcast(mine.clone(), 0)
            same &= bool(torch.equal(mine, theirs))
        rec["replicas_bit_equal"] = same
        rec["trainables"] = ({n: p.detach().cpu() for n, p in step.trainable.items()}
                             if rank == 0 else None)
        rec["seconds"] = time.perf_counter() - t0
        out[mode] = rec
        del step, model, teachers
        release_cuda()

    # (g) the LoRA stage (the factors replicated, their side path on the
    # rank's slices)
    out["g"] = tp_lora_rank(mesh, tp, dev, rank, reset, read)
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, root / f"rank{rank}.pt")
    D.barrier()
    D.shutdown()
    return 0


def tp_recipe_rank(argv) -> int:
    """One of phase 17 (c)'s four ranks (`chip_smoke.py --phase17c-rank R
    PORT DIR`): `cli.main(["@recipes/pretrain_full.args", ...])` at
    Llama-3-8B full width, cut to TP_RECIPE_LAYERS layers, --tp 4 over gloo
    on the one card, TP_RECIPE_STEPS steps on phase 12's PT records. Writes
    what it measured to DIR/rank<R>.pt."""
    import dataclasses
    from unittest import mock

    from visper_lm_tpu_torch.models import vlm as vlm_lib
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.train import cli
    from visper_lm_tpu_torch.train import train_step as ts
    from visper_lm_tpu_torch.train.checkpoint import CheckpointManager

    rank, port, root = int(argv[0]), int(argv[1]), Path(argv[2])
    t_start = time.perf_counter()
    D.init_distributed(f"localhost:{port}", 4, rank, local_device_ids=[0], device="cuda",
                       backend="gloo")
    reset, read = dp_counters()
    out = dict(backend=str(torch.distributed.get_backend()))
    repo = Path(__file__).resolve().parent
    data = json.loads((root / "data.json").read_text())
    build_cfg, init, call = cli.build_vlm_config, vlm_lib.init_vlm, ts.TrainStep.__call__

    def cut(args):
        cfg = build_cfg(args)
        return dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, num_layers=TP_RECIPE_LAYERS))

    def init_vlm(cfg, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = init(cfg, **kw)
        torch.cuda.synchronize()
        out.update(init_peak_bytes=torch.cuda.max_memory_allocated(),
                   decoder_bytes=decoder_bytes(model))
        return model

    step_ms, launches = [], []

    def timed_call(self, batch):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = call(self, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read())
        return metrics

    saves = []
    argv_cli = [f"@{repo / 'recipes' / 'pretrain_full.args'}", "--layer-indices", DP_TAPS,
                "--data-path", data["pt"], "--image-folder", data["images"], "--tokenizer",
                "fake-whitespace", "--output-dir", str(root / "run"), "--max-steps",
                str(TP_RECIPE_STEPS), "--seq-buckets", "1024,2048"]
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(cli, "build_vlm_config", cut), \
            mock.patch.object(vlm_lib, "init_vlm", init_vlm), \
            mock.patch.object(ts.TrainStep, "__call__", timed_call), \
            mock.patch.object(CheckpointManager, "save",
                              lambda self, step, *a, **k: saves.append(step)):
        state = cli.main(argv_cli)
    torch.cuda.synchronize()
    opt, stream = state.optimizer, state.grad_stream
    out.update(
        step_ms=step_ms, launches=launches, metrics=state.last_metrics, saves=saves,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        pinned_gib=(opt.host_bytes + (stream.host_bytes if stream is not None else 0)) / 2**30,
        optimizer=type(opt).__name__, streamed=stream is not None,
        tp=state.model.decoder.tp.size, layers=state.model.cfg.decoder.num_layers,
        teacher_split=0 if state.teacher_sharded is None else len(state.teacher_sharded.shards),
        teachers_gib=(held_bytes(state.teacher_params.parameters()) + (
            state.teacher_sharded.shard_bytes if state.teacher_sharded else 0)) / 2**30,
        seconds=time.perf_counter() - t_start)
    torch.save(out, root / f"rank{rank}.pt")
    D.barrier()
    D.shutdown()
    return 0


def free_port() -> int:
    """A coordinator's port below the ephemeral range, which the gloo ranks
    of a spawn already running cannot take from under the next one's
    (`distributed.free_port`)."""
    from visper_lm_tpu_torch.parallel.distributed import free_port as below_ephemeral

    return below_ephemeral()


def held_port(root: Path) -> str:
    """A rank started by `start_ranks(hold=True)`: import what the ranks use
    and open the CUDA context, then wait for DIR/start (`release_ranks`) and
    return the port it names."""
    import importlib

    for mod in ("models.vlm", "models.teachers", "parallel.distributed", "parallel.tensor",
                "serve.generate", "serve.engine", "train.train_step", "train.cli"):
        importlib.import_module(f"visper_lm_tpu_torch.{mod}")
    torch.zeros(1, device="cuda")
    deadline = time.perf_counter() + HOLD_TIMEOUT
    while not (root / "start").exists():
        check(time.perf_counter() < deadline, f"no start within {HOLD_TIMEOUT} s")
        time.sleep(0.05)
    return (root / "start").read_text().strip()


def start_ranks(flag: str, world: int, root: Path, hold: bool = False) -> dict:
    """Start `world` processes of this script (`flag R PORT DIR`) from a free
    port, each logging to DIR/rank<R>.log; `wait_ranks` collects them. With
    `hold` they start with PORT "hold" and wait, imported and with their CUDA
    context open, until `release_ranks` names the port: a spawn's start-up
    (seconds a process) runs beside the parent's work before it."""
    root.mkdir(parents=True, exist_ok=True)
    port = "hold" if hold else str(free_port())
    env = dict(os.environ, PYTHONHASHSEED="0")
    logs = [open(root / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), flag, str(r),
                               port, str(root)], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    return dict(procs=procs, logs=logs, root=root,
                deadline=None if hold else time.perf_counter() + TP_TIMEOUT)


def wait_for_file(path: Path, ranks: dict) -> None:
    """Wait until `path` exists, one of `ranks`' processes has ended, or
    their TP_TIMEOUT has passed (`wait_ranks` then reports why)."""
    while not path.exists() and all(p.poll() is None for p in ranks["procs"]):
        if time.perf_counter() > ranks["deadline"]:
            return
        time.sleep(0.05)


def release_ranks(ranks: dict) -> None:
    """Let held ranks (`start_ranks(hold=True)`) go on, from a free port;
    their TP_TIMEOUT runs from here."""
    if ranks["deadline"] is None:
        (ranks["root"] / "start.tmp").write_text(str(free_port()))
        (ranks["root"] / "start.tmp").rename(ranks["root"] / "start")
        ranks["deadline"] = time.perf_counter() + TP_TIMEOUT


def stop_ranks(ranks: dict) -> None:
    """Kill what is left of `start_ranks`' processes and close their logs."""
    for p in ranks["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in ranks["logs"]:
        f.close()


def wait_ranks(ranks: dict, name: str) -> list:
    """Wait for `start_ranks`' processes within TP_TIMEOUT of their start,
    kill what is left, print a failed rank's log and fail the phase unless
    every rank exits 0. Returns the ranks' records."""
    release_ranks(ranks)
    procs, root = ranks["procs"], ranks["root"]
    world = len(procs)
    try:
        codes = [p.wait(timeout=max(ranks["deadline"] - time.perf_counter(), 0)) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        stop_ranks(ranks)
    for r in range(world):
        if codes is None or codes[r] != 0:
            print(f"{name} rank {r} log (tail):\n{(root / f'rank{r}.log').read_text()[-3000:]}")
    check(codes is not None, f"{name}: the ranks did not finish within {TP_TIMEOUT} s")
    check(codes == [0] * world, f"{name}: rank exit codes {codes}")
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(world)]


def tp_serving_checks(smi: str, cfg, ranks: list, one: dict, logits_f, tol: float,
                      e_bf16: float) -> dict:
    """Phase 17 (d)-(f): the two ranks' `serving_checks` against the
    one-process run's (`one`, with margins) and the f32 logits; (a)'s
    tolerance `tol` for the margin rule of (e) and (f)."""
    out = {}
    d = [r["d"] for r in ranks]
    per_forward = 7 * cfg.decoder.num_layers + 1
    check(torch.equal(d[0]["logits"], d[1]["logits"]) and d[0]["tokens"] == d[1]["tokens"],
          "phase 17 (d): the tp ranks' int4 logits or tokens differ")
    e_q = float((one["d"]["logits"] - logits_f).abs().max())
    tol_d = 2 * e_q
    d_q = float((d[0]["logits"] - one["d"]["logits"]).abs().max())
    check(d_q <= tol_d, f"phase 17 (d): int4 prefill logits {d_q:.4g} from the one-process int4 "
          f"run's, beyond 2 x its distance to f32 {e_q:.4g}")
    agree_d, low_d = margin_rule("phase 17 (d)", d[0]["tokens"], one["d"]["tokens"],
                                 one["d"]["margins"], tol_d)
    for r, rec in enumerate(d):
        check(rec["w4_per_forward"] == per_forward and
              rec["w4_generate"] == per_forward * rec["forwards"],
              f"phase 17 (d) rank {r}: B5 {rec['w4_per_forward']} a forward, "
              f"{rec['w4_generate']} a generate (expected {per_forward} a forward)")
        check(rec["prefill_launches"] == cfg.decoder.num_layers,
              f"phase 17 (d) rank {r}: {rec['prefill_launches']} B1 launches a prefill")
        share = rec["decoder_gib"] / one["d"]["decoder_gib"]
        check(0.45 <= share <= 0.55, f"phase 17 (d) rank {r}: {share:.3f} of the int4 decoder")
    out["d"] = dict(logits_max_abs_to_one=d_q, int4_to_f32=e_q, tolerance=tol_d,
                    tokens_agree=agree_d, first_low_margin=low_d,
                    one_process={k: one["d"][k] for k in ("prefill_ms", "decode_ms_per_token",
                                                          "decoder_gib", "w4_per_forward")},
                    ranks=[{k: v for k, v in rec.items() if k not in ("logits", "tokens")}
                           for rec in d])
    for r, rec in enumerate(d):
        print(f"phase 17 (d) rank {r}: int4 + AWQ decoder {rec['decoder_gib']:.3f} GiB (one "
              f"process {one['d']['decoder_gib']:.3f}), B5 {rec['w4_per_forward']} a forward, "
              f"{rec['w4_generate']} a generate, B1 {rec['prefill_launches']} a prefill, "
              f"prefill {rec['prefill_ms']:.1f} ms, decode {rec['decode_ms_per_token']:.1f} "
              f"ms/token (one process {one['d']['prefill_ms']:.1f} / "
              f"{one['d']['decode_ms_per_token']:.1f}) [{smi}]")
    print(f"phase 17 (d): int4 prefill logits {d_q:.4g} from one process (int4 vs f32 "
          f"{e_q:.4g}, tolerance {tol_d:.4g}); greedy tokens equal through {agree_d} (margin "
          f"first under the tolerance at {low_d}); first divergence: "
          f"{divergence_note(agree_d, one['d']['margins'])}")

    e = [r["e"] for r in ranks]
    check(e[0]["tokens"] == e[1]["tokens"], "phase 17 (e): the tp ranks' engine tokens differ")
    check([len(t) for t in e[0]["tokens"]] == [len(t) for t in one["e"]["tokens"]],
          "phase 17 (e): the engine's token counts differ from one process's")
    agree_e, low_e = margin_rule("phase 17 (e)", e[0]["tokens"], one["e"]["tokens"],
                                 one["e"]["margins"], tol)
    for r, rec in enumerate(e):
        check(rec["cache_heads"] == cfg.decoder.num_kv_heads // 2,
              f"phase 17 (e) rank {r}: a cache of {rec['cache_heads']} kv heads")
        check(rec["b1_launches"] == cfg.decoder.num_layers * rec["dispatches"],
              f"phase 17 (e) rank {r}: B1 {rec['b1_launches']} for {rec['dispatches']} prefill "
              "dispatches")
    out["e"] = dict(tokens_agree=agree_e, first_low_margin=low_e, tolerance=tol,
                    one_process={k: one["e"][k] for k in ("seconds", "tokens_per_s", "steps",
                                                          "b1_launches")},
                    ranks=[{k: v for k, v in rec.items() if k != "tokens"} for rec in e])
    for r, rec in enumerate(e):
        print(f"phase 17 (e) rank {r}: Engine int8 KV + w8a16, {TP_ENGINE_REQUESTS} requests, "
              f"{rec['steps']} steps, {rec['prefills']} prefills, B1 {rec['b1_launches']}, "
              f"{rec['tokens_per_s']:.1f} tokens/s ({rec['seconds']:.2f} s; one process "
              f"{one['e']['tokens_per_s']:.1f}) [{smi}]")
    print(f"phase 17 (e): tokens equal the one-process engine's through {agree_e} (margin first "
          f"under {tol:.4g} at {low_e}); first divergence: "
          f"{divergence_note(agree_e, one['e']['margins'])}")

    f = [r["f"] for r in ranks]
    check(all(f[0][k] == f[1][k] for k in ("spec", "lookup", "beam")),
          "phase 17 (f): the tp ranks' tokens differ")
    out["f"] = dict(tolerance=tol, acceptance=f[0]["acceptance"], seconds=f[0]["seconds"],
                    one_process_seconds=one["f"]["seconds"])
    for k in ("spec", "lookup", "beam"):
        ag, low = margin_rule(f"phase 17 (f) {k}", [f[0][k]], [one["f"][k]],
                              [one["f"]["margins"]], tol)
        out["f"][k] = dict(agree=ag[0], first_low_margin=low[0], tokens=f[0][k])
    print(f"phase 17 (f): batch 1, {TP_SPEC_TOKENS} tokens: speculative (half-depth draft, "
          f"acceptance {f[0]['acceptance']:.3f}), prompt lookup and {TP_BEAMS} beams equal the "
          f"one-process runs through {[out['f'][k]['agree'] for k in ('spec', 'lookup', 'beam')]}"
          f" (greedy margin first under {tol:.4g} at {out['f']['spec']['first_low_margin']}); "
          f"{f[0]['seconds']:.2f} s a rank (one process {one['f']['seconds']:.2f}) [{smi}]")
    return out


def tp_lora_checks(smi: str, recs: list, ref: dict) -> dict:
    """Phase 17 (g): the ranks' LoRA steps held to the one-process step and
    the f32 run by phase 16's bounds."""
    check(recs[0]["losses"] == recs[1]["losses"], "phase 17 (g): the ranks' losses differ")
    want = dict(flash_fwd=2 * DP_LAYERS, flash_bwd_dq=DP_LAYERS, flash_bwd_dkv=DP_LAYERS,
                window_attn=0)
    for r, rr in enumerate(recs):
        check(all(c == want for c in rr["launches"]),
              f"phase 17 (g) rank {r}: launches {rr['launches']}, expected {want} a step")
    check(all(c == want for c in ref["launches"]),
          f"phase 17 (g): one-process launches {ref['launches']}, expected {want}")
    for x, c, f in zip(recs[0]["losses"], ref["losses"], ref["losses_f"]):
        check(abs(x - c) <= 2 * abs(c - f) + 1e-4 * abs(c),
              f"phase 17 (g): loss {x} vs one process {c} (f32 {f})")
    g_m, replicas_equal = dp_reduced([rr["grads"] for rr in recs])
    check(replicas_equal, "phase 17 (g): a factor's gradient differs between the tp ranks")
    d_grad = rel_fro(g_m, ref["g_f"])
    check(d_grad <= ref["d_grad"] + 1e-2, f"phase 17 (g): gradients {d_grad:.4g} from f32 (one "
          f"process {ref['d_grad']:.4g})")
    same = all(rr["replicas_bit_equal"] for rr in recs)
    check(same, "phase 17 (g): the replicated factors differ between the tp ranks")
    e_1 = ref["e_1"]
    moves = delta_record(deltas(recs[0]["trainables"], ref["p0"]), ref["move_1"], ref["move_f"],
                         DP_LR)
    check(moves["rel_frobenius_to_f32"] <= 2 * e_1 + 1e-3 and
          moves["rel_frobenius"] <= 3 * e_1 + 1e-3,
          f"phase 17 (g): parameter moves {moves} (one process {e_1:.4g} from f32)")
    out = dict(losses=recs[0]["losses"], losses_one_process=ref["losses"],
               losses_f32=ref["losses_f"], grads_rel_frobenius_to_f32=d_grad,
               grads_one_process_to_f32=ref["d_grad"], moves=moves, replicas_bit_equal=same,
               trainables=ref["trainables"], one_process=dict(step_ms=ref["step_ms"],
                                                             peak_gib=ref["peak_gib"]),
               ranks=[dict(peak_gib=rr["peak_gib"], launches_per_step=rr["launches"][-1],
                           step_ms=rr["step_ms"], seconds=rr["seconds"]) for rr in recs])
    for r, rr in enumerate(out["ranks"]):
        print(f"phase 17 (g) rank {r}: LoRA r 64 at tp 2, peak {rr['peak_gib']:.2f} GiB (one "
              f"process {ref['peak_gib']:.2f}), B1-B3 a step {rr['launches_per_step']}, step ms "
              f"{', '.join(f'{x:.1f}' for x in rr['step_ms'])} (one process "
              f"{', '.join(f'{x:.1f}' for x in ref['step_ms'])}) [{smi}]")
    print(f"phase 17 (g): losses {recs[0]['losses']} (one process {ref['losses']}, f32 "
          f"{ref['losses_f']}); reduced step-1 gradients rel Frobenius to f32 {d_grad:.4g} (one "
          f"process {ref['d_grad']:.4g}); moves {json.dumps(moves)}; factors bit-equal across "
          f"tp {same}")
    return out


def tp_phase(smi: str, ref: dict) -> dict:
    """Phase 17: tensor parallelism on the card (see the module docstring);
    `ref`: phase 16's one-process PT references. Returns the record printed
    as `tp_path`."""
    import dataclasses
    import shutil

    from visper_lm_tpu_torch import native
    from visper_lm_tpu_torch.config import LLAMA3_8B
    from visper_lm_tpu_torch.models.decoder import Decoder
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator

    root = Path(__file__).resolve().parent / "tmp" / "chip_smoke_tp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = dict(card=smi)
    # both spawns' ranks start now and wait for the references below
    held = [start_ranks("--phase17-rank", 2, root / "ab", hold=True),
            start_ranks("--phase17c-rank", 4, root / "c", hold=True)]
    try:
        # (a)'s one-process references: phase 4's model and batch, bf16, and
        # the same weights in f32 on the plain path
        t0 = time.perf_counter()
        cfg = tp_gen_config()
        batch = main_path_batch(cfg)
        torch.cuda.reset_peak_memory_stats()
        model = init_vlm(cfg, device="cuda", seed=0)
        one_dec = decoder_bytes(model)
        gen_cfg = GenerationConfig(max_new_tokens=TP_NEW_TOKENS)
        generator = Generator(model, cfg, gen_cfg, BATCH, PROMPT_LEN, device="cuda")
        logits_1 = generator.prefill(batch)[0].float().cpu()
        tokens_1, margins_1 = greedy_margins(generator, batch, TP_NEW_TOKENS)
        gen_1 = generator.generate(batch)
        check(gen_1 == tokens_1.T.tolist(), "phase 17 (a): the margins' greedy decode is not "
              "the Generator's")
        one_peak = torch.cuda.max_memory_allocated() / 2**30
        del generator
        # (d)-(f)'s one-process references, with their margins
        reset, read = dp_counters()
        serv_1 = serving_checks(model, cfg, batch, torch.device("cuda"), reset, read,
                                margins=True)
        model.float()
        logits_f = Generator(model, cfg, gen_cfg, BATCH, PROMPT_LEN, cache_dtype=torch.float32,
                             device="cuda").prefill(batch, use_kernel=False)[0].float().cpu()
        del model
        release_cuda()
        e_bf16 = float((logits_1 - logits_f).abs().max())
        tol = 2 * e_bf16
        lora_ref = lora_references(reset, read)
        # (c)'s records and the native library, before any rank runs
        root_c = held[1]["root"]
        data = recipe_dataset(root_c)
        (root_c / "data.json").write_text(json.dumps(data))
        native.load()                       # built once here, not by four ranks at once
        ref_s = time.perf_counter() - t0

        # (a) and (b): two ranks, dp 1 x tp 2; (c)'s four ranks share the
        # card with (b), (g) and these checks once (a) and (d)-(f) are timed
        t0 = time.perf_counter()
        release_ranks(held[0])
        wait_for_file(held[0]["root"] / "serving_done", held[0])
        release_ranks(held[1])
        t_c = time.perf_counter()
        ranks = wait_ranks(held[0], "phase 17 (a)-(b)")
        ranks_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks), "phase 17: the ranks did not run gloo")
        a = [r["a"] for r in ranks]
        check(torch.equal(a[0]["logits"], a[1]["logits"]) and a[0]["tokens"] == a[1]["tokens"],
              "phase 17 (a): the tp ranks' logits or tokens differ")
        d_tp = float((a[0]["logits"] - logits_1).abs().max())
        check(d_tp <= tol, f"phase 17 (a): prefill logits {d_tp:.4g} from the one-process run's, "
              f"beyond 2 x the bf16-vs-f32 distance {e_bf16:.4g}")
        agree, first_low = margin_rule("phase 17 (a)", a[0]["tokens"], gen_1,
                                       margins_1.T.tolist(), tol)
        for r, rec in enumerate(a):
            check(rec["prefill_launches"] == cfg.decoder.num_layers,
                  f"phase 17 (a) rank {r}: {rec['prefill_launches']} B1 launches a prefill")
            check(rec["cache_heads"] == cfg.decoder.num_kv_heads // 2,
                  f"phase 17 (a) rank {r}: a cache of {rec['cache_heads']} kv heads")
            share = rec["decoder_gib"] * 2**30 / one_dec
            check(0.5 <= share <= 0.51, f"phase 17 (a) rank {r}: {share:.3f} of the decoder")
            check(rec["init_peak_gib"] * 2**30 < one_dec, f"phase 17 (a) rank {r}: the init "
                  f"peak {rec['init_peak_gib']:.2f} GiB reaches the whole decoder's bytes")
        out["a"] = dict(
            logits_max_abs_to_one=d_tp, bf16_to_f32=e_bf16, tolerance=tol, tokens_agree=agree,
            first_low_margin=first_low, one_process=dict(peak_gib=one_peak,
                                                         decoder_gib=one_dec / 2**30),
            ranks=[{k: v for k, v in rec.items() if k not in ("logits", "tokens")} for rec in a])
        for r, rec in enumerate(out["a"]["ranks"]):
            print(f"phase 17 (a) rank {r}: B1 {rec['prefill_launches']} a prefill, peak "
                  f"{rec['peak_gib']:.2f} GiB (decoder {rec['decoder_gib']:.2f} of "
                  f"{one_dec / 2**30:.2f}), prefill {rec['prefill_ms']:.1f} ms, decode "
                  f"{rec['decode_ms_per_token']:.1f} ms/token [{smi}]")
        print(f"phase 17 (a): prefill logits {d_tp:.4g} from one process (bf16 vs f32 "
              f"{e_bf16:.4g}, tolerance {tol:.4g}); greedy tokens equal through positions "
              f"{agree} (one-process margin first under the tolerance at {first_low})")

        # (b): each mode against the one-process step and the f32 run of phase 16
        cfg_b = ref["cfg"]
        b = {}
        for mode in TP_MODES:
            recs = [r[mode] for r in ranks]
            check(recs[0]["losses"] == recs[1]["losses"],
                  f"phase 17 (b) {mode}: the ranks' losses differ")
            for r, rr in enumerate(recs):
                check(all(c == ref["launches"] for c in rr["launches"]),
                      f"phase 17 (b) {mode} rank {r}: launches {rr['launches']}, expected "
                      f"{ref['launches']} a step")
            for x, c, f in zip(recs[0]["losses"], ref["losses"], ref["losses_f"]):
                check(abs(x - c) <= 2 * abs(c - f) + 1e-4 * abs(c),
                      f"phase 17 (b) {mode}: loss {x} vs one process {c} (f32 {f})")
            g_m, replicas_equal = dp_reduced([rr["grads"] for rr in recs])
            check(replicas_equal, f"phase 17 (b) {mode}: a gradient differs between the tp ranks")
            d_grad = rel_fro(g_m, ref["g_f"])
            check(d_grad <= ref["d_grad"] + 1e-2,
                  f"phase 17 (b) {mode}: gradients {d_grad:.4g} from f32 (one process "
                  f"{ref['d_grad']:.4g})")
            same = all(rr["replicas_bit_equal"] for rr in recs)
            check(same, f"phase 17 (b) {mode}: the replicated trainables differ between tp ranks")
            e_1 = ref["e_1"]
            moves = delta_record(deltas(recs[0]["trainables"], ref["p0"]), ref["move_1"],
                                 ref["move_f"], DP_LR)
            check(moves["rel_frobenius_to_f32"] <= 2 * e_1 + 1e-3 and
                  moves["rel_frobenius"] <= 3 * e_1 + 1e-3,
                  f"phase 17 (b) {mode}: parameter moves {moves} (one process {e_1:.4g} from f32)")
            b[mode] = dict(losses=recs[0]["losses"], grads_rel_frobenius_to_f32=d_grad,
                           moves=moves, replicas_bit_equal=same,
                           ranks=[dict(peak_gib=rr["peak_gib"], decoder_gib=rr["decoder_gib"],
                                       teachers_gib=rr["teachers_gib"],
                                       teachers_whole_gib=rr["teachers_whole_gib"],
                                       launches_per_step=rr["launches"][-1],
                                       step_ms=rr["step_ms"], seconds=rr["seconds"])
                                  for rr in recs])
            for r, rr in enumerate(b[mode]["ranks"]):
                print(f"phase 17 (b) {mode} rank {r}: peak {rr['peak_gib']:.2f} GiB, decoder "
                      f"{rr['decoder_gib']:.3f} GiB, teachers {rr['teachers_gib']:.3f} of "
                      f"{rr['teachers_whole_gib']:.3f} GiB, B1-B4 a step "
                      f"{rr['launches_per_step']}, step ms "
                      f"{', '.join(f'{x:.1f}' for x in rr['step_ms'])} [{smi}]")
            print(f"phase 17 (b) {mode}: losses {recs[0]['losses']} (one process "
                  f"{ref['losses']}); gradients rel Frobenius to f32 {d_grad:.4g}; moves "
                  f"{json.dumps(moves)}; replicated trainables bit-equal across tp {same}")
        check(b["plain"]["losses"] == b["shard_teachers"]["losses"],
              "phase 17 (b): shard_teachers changes the losses")
        for r in range(2):
            share = b["shard_teachers"]["ranks"][r]["teachers_gib"] / b["plain"]["ranks"][r]["teachers_gib"]
            check(0.45 <= share <= 0.6, f"phase 17 (b): shard_teachers keeps {share:.3f} of the "
                  f"teachers' bytes")
        out["b"] = b
        out.update(tp_serving_checks(smi, cfg, [r["serving"] for r in ranks], serv_1, logits_f,
                                     tol, e_bf16))
        out["g"] = tp_lora_checks(smi, [r["g"] for r in ranks], lora_ref)

        # (c): the pretrain_full recipe at Llama-3-8B widths on four ranks
        shutil.rmtree(root / "ab", ignore_errors=True)
        ranks_c = wait_ranks(held[1], "phase 17 (c)")
        c_s = time.perf_counter() - t_c
        with torch.device("meta"):
            whole = sum(p.numel() * p.element_size() for p in Decoder(dataclasses.replace(
                LLAMA3_8B, num_layers=TP_RECIPE_LAYERS), dtype=torch.bfloat16).parameters())
        n_swin = 24
        want_c = dict(flash_fwd=2 * TP_RECIPE_LAYERS, flash_bwd_dq=TP_RECIPE_LAYERS,
                      flash_bwd_dkv=TP_RECIPE_LAYERS, window_attn=n_swin)
        for r, rr in enumerate(ranks_c):
            check(rr["backend"] == "gloo" and rr["tp"] == 4 and rr["layers"] == TP_RECIPE_LAYERS,
                  f"phase 17 (c) rank {r}: {rr['backend']}, tp {rr['tp']}, {rr['layers']} layers")
            check(rr["optimizer"] == "OffloadedAdamW" and rr["streamed"] and rr["teacher_split"],
                  f"phase 17 (c) rank {r}: the recipe's levers are not on")
            check(len(rr["step_ms"]) == TP_RECIPE_STEPS and all(
                c == want_c for c in rr["launches"]),
                f"phase 17 (c) rank {r}: launches {rr['launches']}, expected {want_c} a step")
            share = rr["decoder_bytes"] / whole
            check(0.25 <= share <= 0.26, f"phase 17 (c) rank {r}: {share:.4f} of the decoder")
            check(rr["init_peak_bytes"] < whole, f"phase 17 (c) rank {r}: the init peak "
                  f"{rr['init_peak_bytes'] / 2**30:.2f} GiB reaches the whole decoder's "
                  f"{whole / 2**30:.2f} GiB")
            check(math.isfinite(rr["metrics"]["loss"]) and rr["metrics"] == ranks_c[0]["metrics"],
                  f"phase 17 (c): rank {r}'s metrics {rr['metrics']}")
            check(rr["saves"] == [TP_RECIPE_STEPS], f"phase 17 (c) rank {r}: saves {rr['saves']}")
        pinned = sum(rr["pinned_gib"] for rr in ranks_c)
        check(pinned < 57.99, f"phase 17 (c): {pinned:.2f} GiB pinned over the ranks")
        out["c"] = dict(whole_decoder_gib=whole / 2**30, pinned_gib_total=pinned,
                        loss=ranks_c[0]["metrics"]["loss"],
                        ranks=[dict(peak_gib=rr["peak_gib"], pinned_gib=rr["pinned_gib"],
                                    decoder_gib=rr["decoder_bytes"] / 2**30,
                                    init_peak_gib=rr["init_peak_bytes"] / 2**30,
                                    teachers_gib=rr["teachers_gib"],
                                    launches_per_step=rr["launches"][-1], step_ms=rr["step_ms"],
                                    seconds=rr["seconds"]) for rr in ranks_c])
        for r, rr in enumerate(out["c"]["ranks"]):
            print(f"phase 17 (c) rank {r}: peak {rr['peak_gib']:.2f} GiB (init "
                  f"{rr['init_peak_gib']:.2f}), pinned {rr['pinned_gib']:.2f} GiB, decoder "
                  f"{rr['decoder_gib']:.3f} of {whole / 2**30:.3f} GiB, teachers "
                  f"{rr['teachers_gib']:.3f} GiB, B1-B4 a step {rr['launches_per_step']}, step "
                  f"ms {', '.join(f'{x:.1f}' for x in rr['step_ms'])} [{smi}]")
        print(f"phase 17 (c): recipes/pretrain_full.args at Llama-3-8B widths, "
              f"{TP_RECIPE_LAYERS} layers, tp 4: loss {out['c']['loss']:.6f} on every rank, "
              f"{pinned:.2f} GiB pinned over the ranks")
        out["seconds_by_part"] = dict(references=ref_s, ranks_a_b=ranks_s, recipe=c_s,
                                      rank_start=[r["start_s"] for r in ranks])
    finally:
        for h in held:
            stop_ranks(h)
        shutil.rmtree(root, ignore_errors=True)
        release_cuda()
    return out


# ---------------------------------------------------------------------------
# phase 18: sequence and pipeline parallelism
# ---------------------------------------------------------------------------


def sp_config():
    """Phase 18 (b)'s Llama-3-8B + CLIP-L, cut to SP_LAYERS layers (time)."""
    import dataclasses

    from visper_lm_tpu_torch.config import llama3_clip_vlm

    cfg = llama3_clip_vlm(distill=False)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=SP_LAYERS))


def pp_config():
    """Phase 18 (c)'s Phi3-mini-4k + CLIP-L, cut to PP_LAYERS layers (time)."""
    import dataclasses

    from visper_lm_tpu_torch.config import phi3_clip_vlm

    cfg = phi3_clip_vlm(distill=False)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, num_layers=PP_LAYERS))


def pp_lora_config():
    """Phase 18 (c)'s model with phase 12's LoRA adapters (r 64, alpha 16,
    all seven targets)."""
    import dataclasses

    from visper_lm_tpu_torch.config import LoraConfig

    return dataclasses.replace(pp_config(), lora=LoraConfig())


def sp_pp_batches(cfg, batch: int, seq: int) -> list:
    """SP_STEPS full-length IFT batches (seeds 0, 1, ...)."""
    from visper_lm_tpu_torch.train import aot

    return [aot.full_length_batch(cfg, batch, seq, with_teachers=False, seed=s)
            for s in range(SP_STEPS)]


def chunked_attention(plain):
    """`plain` (`mha_plain`) one kv head's group of query heads at a time,
    each group rematerialised: the same numbers, without the (B, N, T, T)
    f32 scores of every head at once (an f32 reference at T8192)."""
    import functools

    from torch.utils.checkpoint import checkpoint

    def attend(q, k, v, **kw):
        g = q.shape[2] // k.shape[2]
        fn = functools.partial(plain, **kw)
        parts = []
        for i in range(k.shape[2]):
            args = (q[:, :, i * g:(i + 1) * g], k[:, :, i:i + 1], v[:, :, i:i + 1])
            parts.append(checkpoint(fn, *args, use_reentrant=False) if torch.is_grad_enabled()
                         else fn(*args))
        return torch.cat(parts, 2)

    return attend


def f32_steps(cfg, batches, stage: str, chunked: bool) -> dict:
    """The f32 student from the same seed (plain attention, the port's AdamW
    in f32, no remat) on the batches: each loss, the step-1 gradients'
    samples, the samples of the trainables before and after, the loss on
    the last batch after the updates."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.ops import attention
    from visper_lm_tpu_torch.train.optimizer import AdamW, trainable_mask
    from visper_lm_tpu_torch.train.train_step import make_loss_fn

    model = init_vlm(cfg, device="cuda", seed=0).float()
    mask = trainable_mask(model.named_parameters(), stage)
    names = [n for n, _ in model.named_parameters() if mask[n]]
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(mask[n])
    loss_fn = make_loss_fn(cfg, use_kernel=False, remat=False)
    opt = AdamW(((n, params[n]) for n in names), dp_opt_cfg(stage))
    s_0 = {n: dp_sample(params[n]) for n in names}
    losses, g_1 = [], None
    plain = attention.mha_plain
    if chunked:
        attention.mha_plain = chunked_attention(plain)
    try:
        for batch in batches:
            dbatch = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
            loss, grads = loss_and_grads(loss_fn, model, dbatch, None, [params[n] for n in names])
            grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
            if g_1 is None:
                g_1 = {n: dp_sample(g) for n, g in grads.items()}
            opt.step(grads)
            losses.append(loss)
            del grads, dbatch
        with torch.no_grad():
            after = float(loss_fn(model, {k: torch.as_tensor(v).to("cuda")
                                          for k, v in batches[-1].items()}, None)[0])
    finally:
        attention.mha_plain = plain
    out = dict(losses=losses, g_1=g_1, s_0=s_0, s_1={n: dp_sample(params[n]) for n in names},
               loss_after=after)
    del opt, model, params
    release_cuda()
    return out


@contextlib.contextmanager
def first_routes(layers: int, into: list):
    """`ops.moe.route` keeping, on the host, the expert ids (N, k) of its
    first `layers` calls: a MoE decoder's first forward, layer by layer."""
    import visper_lm_tpu_torch.ops.moe as moe_ops

    routed = moe_ops.route

    def recording(probs, k):
        vals, idx = routed(probs, k)
        if len(into) < layers:
            into.append(idx.cpu())
        return vals, idx

    moe_ops.route = recording
    try:
        yield into
    finally:
        moe_ops.route = routed


def one_process_steps(cfg, batches, stage: str, reset, read) -> dict:
    """The one-process bf16 step (save_gate) on the batches, as phase 16's;
    a MoE decoder's first forward's routes kept (`first_routes`)."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.train.train_step import make_train_step

    torch.cuda.reset_peak_memory_stats()
    model = init_vlm(cfg, device="cuda", seed=0)
    step = make_train_step(cfg, dp_opt_cfg(stage), model, remat_policy="save_gate")
    s_0 = {n: dp_sample(p) for n, p in step.trainable.items()}
    kept = dp_grads(step)
    routes = []
    with first_routes(cfg.decoder.num_layers if cfg.decoder.moe_experts else 0, routes):
        rec = dp_steps(step, batches, reset, read)
    rec["routes"] = routes
    rec.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30, s_0=s_0,
               g_1={n: s for n, (_, s) in kept.items()},
               s_1={n: dp_sample(p) for n, p in step.trainable.items()},
               loss_after=dp_loss_at(step, batches[-1]))
    del step, model, kept
    release_cuda()
    return rec


def whole_sample(model, n: str, t: torch.Tensor) -> torch.Tensor:
    """`dp_sample` of trainable n's whole value from this rank's `t`
    (collective). A MoE bank under expert parallelism is sampled where the
    rank's experts hold the whole tensor's sample positions, and only the
    pieces are gathered over the expert group (not the bank: gloo stages
    every byte through host memory); anything else via `whole_param`."""
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.parallel.tensor import whole_param

    ep = model.decoder.ep
    if ep is None or ".moe_" not in n or not n.endswith(".kernel"):
        return dp_sample(whole_param(model, n, t))
    flat = t.detach().reshape(-1)
    total = flat.numel() * ep.size
    stride = max(1, total // DP_SAMPLE)
    start = ep.rank * flat.numel()
    piece = flat[-(-start // stride) * stride - start::stride].float()
    cap = flat.numel() // stride + 1
    padded = torch.zeros(cap + 1, device=flat.device)
    padded[0], padded[1:1 + piece.numel()] = piece.numel(), piece
    parts = D.all_gather(padded, 0, ep.group).reshape(ep.size, cap + 1).cpu()
    return torch.cat([p[1:1 + int(p[0])] for p in parts])[:DP_SAMPLE]


def whole_grads(step) -> dict:
    """Arm `step` to keep, from its next update, a sample of each of the
    rank's trainables' gradients as the optimizer's reduce leaves them,
    gathered whole over the model group (collective: the tp ranks of a
    stage hold the same names): {name: sample}."""
    opt, kept = step.optimizer, {}

    def reduce_grads(names, grads, reduced=()):
        del opt.reduce_grads
        opt.reduce_grads(names, grads, reduced)
        for n in names:
            g = grads[n].to(opt.params[n].device)        # a streamed one is on the host
            kept[n] = whole_sample(step.model, n, g)

    opt.reduce_grads = reduce_grads
    return kept


def whole_samples(step) -> dict:
    """A sample of each of the rank's trainables, whole over the model group."""
    return {n: whole_sample(step.model, n, p) for n, p in step.trainable.items()}


# foreign blocks gathered from their owners so far (a pipeline's plain
# loop; counted where a phase 18 (c) rank patches `PipeParallel.gather`)
FOREIGN_GATHERS = [0]


def count_foreign_gathers() -> None:
    """Count each foreign block's gather from its owner in FOREIGN_GATHERS."""
    from visper_lm_tpu_torch.parallel.pipeline import PipeParallel

    gather = PipeParallel.gather

    def counted(self, layer):
        if layer not in self.gathered and not self.owns(layer):
            FOREIGN_GATHERS[0] += 1
        return gather(self, layer)

    PipeParallel.gather = counted


def sp_pp_rank_steps(cfg, mesh, dev, tp=None, pp=None, ep=None, shape=None,
                     ready=None, stage: str = "finetune", step_kw=None,
                     moments: bool = False) -> dict:
    """Phase 18 (b) / (c) (and 19 (c)) on one rank: SP_STEPS updates of
    `stage` on the rank's share of batches of `shape` (B, T), its gradients,
    trainables (and moments) sampled whole, the loss on the last batch after
    the updates, point-to-point sends and foreign blocks gathered a step,
    the pinned bytes and the state tensors on the host; ep: a MoE model's
    expert group (a MoE model's first forward's routes of the rank's rows
    kept, `first_routes`); ready: called once the model and step are
    built, before any step runs (returns when the card is the ranks'
    alone); step_kw: make_train_step's levers; moments: also sample the
    moments after the updates."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.train.train_step import make_train_step

    reset, read = dp_counters()
    if shape is None:
        shape = (1, SP_T) if pp is None else (PP_BATCH, PP_SEQ)
    batches = sp_pp_batches(cfg, *shape)
    local = [D.shard_batch_multihost(b, mesh, device=dev) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_vlm(cfg, device=dev, seed=0, tp=tp, pp=pp, ep=ep)
    step = make_train_step(cfg, dp_opt_cfg(stage), model, remat_policy="save_gate", mesh=mesh,
                           **(step_kw or {}))
    opt, stream = step.optimizer, step.grad_stream
    host_keys = sorted(k for k, v in getattr(opt, "plan", {}).items() if v is not None)
    rec = dict(init_s=time.perf_counter() - t0, s_0=whole_samples(step),
               decoder_gib=held_bytes(model.decoder.parameters()) / 2**30,
               bank_bytes=bank_bytes(model),
               pinned_bytes=getattr(opt, "host_bytes", 0) + (stream.host_bytes if stream else 0),
               on_host=len(host_keys), host_keys=host_keys,
               state_tensors=len(getattr(opt, "plan", {})),
               segments=None if stream is None else stream.ranges)
    if ready is not None:
        rec["waited_s"] = ready()
    kept = whole_grads(step)
    runs, p2p, gathers, routes = [], [], [], []
    for batch in local:
        before, gathered = D.p2p_sends, FOREIGN_GATHERS[0]
        with first_routes(cfg.decoder.num_layers if cfg.decoder.moe_experts else 0, routes):
            runs.append(dp_steps(step, [batch], reset, read))
        p2p.append(D.p2p_sends - before)
        gathers.append(FOREIGN_GATHERS[0] - gathered)
    rec.update({k: [r[k][0] for r in runs] for k in ("losses", "step_ms", "launches", "dropped")})
    rec.update(p2p=p2p, gathers=gathers, routes=routes, g_1=kept, s_1=whole_samples(step),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if moments:
        # the rank's own slices: the moments are compared rank by rank
        rec["m_1"] = {f"{k}/{n}": dp_sample(t) for k, state in (("mu", opt.mu), ("nu", opt.nu))
                      for n, t in state.items()}
    with torch.no_grad():
        total, _ = step.loss_fn(step.model, step.to_device(local[-1]), None)
        shares = D.all_reduce_scalars([total.detach()], step.zero.group)
        if step.zero.seq is not None:
            shares = D.all_reduce_scalars(shares, step.zero.seq.group)
    rec["loss_after"] = float(shares[0])
    del step, model, opt, stream
    release_cuda()
    return rec


def sp_rank(argv) -> int:
    """One of phase 18 (a)-(b)'s two ranks (`chip_smoke.py --phase18-rank R
    PORT DIR`, dp 1 x sp 2 sharing the card over gloo): (a) Ulysses and the
    ring on the rank's rows of DIR/attn.pt, forward and backward; (b) the
    finetune step at Llama-3-8B widths, B1 x T8192, with and without the
    levers, and the MoE decoder's at Phi3-mini widths, B2 x T8192. Writes
    DIR/rank<R>.pt."""
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.parallel.sequence import (
        ring_attention,
        sequence_parallel,
        ulysses_attention,
    )

    rank, port, root = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    D.init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0], device="cuda",
                       backend="gloo")
    mesh = D.make_global_mesh(dp=1, sp=2)
    seq = sequence_parallel(mesh)
    dev = torch.device("cuda", 0)
    reset, read = dp_counters()
    out = dict(backend=str(torch.distributed.get_backend()), start_s=time.perf_counter() - t_start)
    inp = torch.load(root / "attn.pt")
    rows = seq.rows(SP_T)
    dout = inp["dout"][:, rows].to(dev)
    for name, fn in (("ulysses", ulysses_attention), ("ring", ring_attention)):
        for run in range(2):                            # the second timed
            leaves = [inp[x][:, rows].to(dev).requires_grad_(True) for x in "qkv"]
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = fn(*leaves, seq=seq, causal=True)
            o.backward(dout)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(ms=ms, launches=read(), rows=(rows.start, rows.stop),
                         out=o.detach().cpu(), grads=[x.grad.cpu() for x in leaves])
        del o, leaves
        release_cuda()
    if rank == 0:
        # (a)'s timings are taken: (c)'s spawn may share the card from here
        (root / "a_done.tmp").write_text("")
        (root / "a_done.tmp").rename(root / "a_done")
    del inp, dout
    out["b"] = sp_pp_rank_steps(sp_config(), mesh, dev, moments=True)
    out["b_levers"] = sp_pp_rank_steps(sp_config(), mesh, dev, step_kw=SP_PP_LEVERS,
                                       moments=True)
    # the MoE decoder at sp 2: each rank routes its rows over the seq group
    out["b_moe"] = sp_pp_rank_steps(moe_config(False, SP_MOE_LAYERS), mesh, dev,
                                    shape=(SP_MOE_BATCH, SP_T))
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, root / f"rank{rank}.pt")
    D.barrier()
    D.shutdown()
    return 0


def pp_rank(argv) -> int:
    """One of phase 18 (c)'s four ranks (`chip_smoke.py --phase18c-rank R
    PORT DIR`, pp 2 x tp 2 sharing the card over gloo): the finetune step at
    Phi3-mini widths, PP_LAYERS layers, B4 x T1024, with and without the
    levers, the LoRA stage, and the MoE decoder's step (the plain loop).
    Writes DIR/rank<R>.pt."""
    from visper_lm_tpu_torch.parallel import distributed as D
    from visper_lm_tpu_torch.parallel.pipeline import pipe_parallel
    from visper_lm_tpu_torch.parallel.tensor import tensor_parallel

    rank, port, root = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    D.init_distributed(f"localhost:{port}", 4, rank, local_device_ids=[0], device="cuda",
                       backend="gloo")
    mesh = D.make_global_mesh(tp=2, pp=2)
    tp, pp = tensor_parallel(mesh), pipe_parallel(mesh, PP_LAYERS)
    out = dict(backend=str(torch.distributed.get_backend()), start_s=time.perf_counter() - t_start,
               stage=pp.rank, layers=list(pp.layers), tp_rank=tp.rank)
    dev = torch.device("cuda", 0)
    out["c"] = sp_pp_rank_steps(pp_config(), mesh, dev, tp=tp, pp=pp, moments=True)
    out["c_levers"] = sp_pp_rank_steps(pp_config(), mesh, dev, tp=tp, pp=pp,
                                       step_kw=SP_PP_LEVERS, moments=True)
    out["c_lora"] = sp_pp_rank_steps(pp_lora_config(), mesh, dev, tp=tp, pp=pp, stage="lora")
    # the MoE decoder at pp 2 x tp 2: JAX's plain loop, no schedule. Four
    # ranks of it do not fit the card beside (b)'s two (not even with (b)'s
    # MoE run at T4096): it starts once they have ended (DIR/moe_go from
    # the parent)
    deadline = time.perf_counter() + HOLD_TIMEOUT
    while not (root / "moe_go").exists():
        check(time.perf_counter() < deadline, f"no moe_go within {HOLD_TIMEOUT} s")
        time.sleep(0.05)
    count_foreign_gathers()
    out["c_moe"] = sp_pp_rank_steps(moe_config(False, MOE_EP_LAYERS), mesh, dev, tp=tp, pp=pp,
                                    shape=(TRAIN_BATCH, TRAIN_SEQ))
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, root / f"rank{rank}.pt")
    D.barrier()
    D.shutdown()
    return 0


def bank_bytes(model) -> int:
    """Bytes of a MoE decoder's expert banks this process holds (0 for a dense one)."""
    return sum(p.numel() * p.element_size() for n, p in model.decoder.named_parameters()
               if ".moe_gate." in n or ".moe_up." in n or ".moe_down." in n)


def held_to_refs(name: str, recs: list, one: dict, f32: dict, smi: str,
                 phase: str = "18") -> dict:
    """Phase 16's bounds on the ranks' FT run against the one-process bf16
    run and the f32 run: each loss (and the loss after the updates) within 2
    x the bf16-vs-f32 distance + 1e-4 relative; the step-1 gradients
    (sampled, whole) within the one-process run's distance from f32 + 1e-2;
    the parameter moves within 2 x (to f32) and 3 x (to the one-process
    moves) the one-process run's distance from the f32 moves, + 1e-3; the
    last update moves the loss beyond 3 x its tolerance (the bounds can
    fail)."""
    g_r, s_0, s_1 = {}, {}, {}
    for rr in recs:                    # a stage's names from its ranks, bit-equal where shared
        for src, dst in ((rr["g_1"], g_r), (rr["s_0"], s_0), (rr["s_1"], s_1)):
            for n, t in src.items():
                check(n not in dst or torch.equal(dst[n], t),
                      f"phase {phase} {name}: {n} differs between ranks that hold it")
                dst[n] = t
    check(sorted(g_r) == sorted(one["g_1"]), f"phase {phase} {name}: the ranks hold "
          f"{len(g_r)} trainables, one process {len(one['g_1'])}")
    losses = recs[0]["losses"]
    check(all(rr["losses"] == losses for rr in recs), f"phase {phase} {name}: the ranks' losses differ")
    for x, c, f in zip(losses + [recs[0]["loss_after"]], one["losses"] + [one["loss_after"]],
                       f32["losses"] + [f32["loss_after"]]):
        check(abs(x - c) <= 2 * abs(c - f) + 1e-4 * abs(c),
              f"phase {phase} {name}: loss {x} vs one process {c} (f32 {f})")
    tol_after = 2 * abs(one["loss_after"] - f32["loss_after"]) + 1e-4 * abs(one["loss_after"])
    moved = abs(one["loss_after"] - one["losses"][-1])
    check(moved > 3 * tol_after, f"phase {phase} {name}: the last update moves the loss {moved:.3g}, "
          f"not beyond 3 x its tolerance {tol_after:.3g}")
    d_grad_1 = rel_fro(one["g_1"], f32["g_1"])
    d_grad = rel_fro(g_r, f32["g_1"])
    check(d_grad <= d_grad_1 + 1e-2, f"phase {phase} {name}: gradients {d_grad:.4g} from f32 (one "
          f"process {d_grad_1:.4g})")
    move_1, move_f = deltas(one["s_1"], one["s_0"]), deltas(f32["s_1"], f32["s_0"])
    e_1 = rel_fro(move_1, move_f)
    check(all(torch.equal(s_0[n], one["s_0"][n]) for n in s_0),
          f"phase {phase} {name}: the ranks start from other weights")
    moves = delta_record(deltas(s_1, s_0), move_1, move_f, DP_LR)
    check(moves["rel_frobenius_to_f32"] <= 2 * e_1 + 1e-3 and moves["rel_frobenius"] <= 3 * e_1 + 1e-3,
          f"phase {phase} {name}: parameter moves {moves} (one process {e_1:.4g} from f32)")
    rec = dict(losses=losses, loss_after=recs[0]["loss_after"], losses_one_process=one["losses"],
               loss_after_one_process=one["loss_after"], losses_f32=f32["losses"],
               loss_after_f32=f32["loss_after"], grads_rel_frobenius_to_f32=d_grad,
               grads_one_process_to_f32=d_grad_1, moves=moves, moves_one_process_to_f32=e_1,
               one_process=dict(peak_gib=one["peak_gib"], step_ms=one["step_ms"],
                                launches_per_step=one["launches"][-1]),
               ranks=[dict(peak_gib=rr["peak_gib"], decoder_gib=rr["decoder_gib"],
                           step_ms=rr["step_ms"], launches_per_step=rr["launches"][-1],
                           p2p=rr["p2p"], init_s=rr["init_s"]) for rr in recs])
    for r, rr in enumerate(rec["ranks"]):
        print(f"phase {phase} {name} rank {r}: peak {rr['peak_gib']:.2f} GiB (one process "
              f"{one['peak_gib']:.2f}), decoder {rr['decoder_gib']:.3f} GiB, B1-B4 a step "
              f"{rr['launches_per_step']}, sends a step {rr['p2p']}, step ms "
              f"{', '.join(f'{x:.1f}' for x in rr['step_ms'])} (one process "
              f"{', '.join(f'{x:.1f}' for x in one['step_ms'])}) [{smi}]")
    print(f"phase {phase} {name}: losses {losses} + after {rec['loss_after']:.6f} (one process "
          f"{one['losses']} + {one['loss_after']:.6f}; f32 {f32['losses']} + "
          f"{f32['loss_after']:.6f}); step-1 gradients rel Frobenius to f32 {d_grad:.4g} (one "
          f"process {d_grad_1:.4g}); moves {json.dumps(moves)} (one process {e_1:.4g} from f32)")
    return rec


def ranks_as_one(recs: list) -> dict:
    """The ranks' records of one run as `held_to_refs`' reference run: the
    samples of every rank put together (a stage's names from its ranks),
    rank 0's losses, step ms and launches, the largest peak."""
    one = {k: recs[0][k] for k in ("losses", "loss_after", "step_ms", "launches")}
    for key in ("g_1", "s_0", "s_1"):
        one[key] = {n: t for rr in recs for n, t in rr[key].items()}
    one["peak_gib"] = max(rr["peak_gib"] for rr in recs)
    return one


def lever_checks(name: str, recs: list, plain: list, f32: dict, want: dict, smi: str) -> dict:
    """Phase 18 (b) / (c) with the memory levers: B1-B3 `want` a rank and
    step; every state tensor on the card (no spec covers 'seq' or 'pipe':
    JAX's plan); phase 16's bounds against the same ranks' plain step and
    the f32 run; whether the losses, trainables and moments are bit-equal to
    the plain step's (rank by rank), with the pinned bytes a rank."""
    for r, rr in enumerate(recs):
        check(all(c == want for c in rr["launches"]),
              f"phase 18 {name} with the levers rank {r}: launches {rr['launches']}, expected "
              f"{want}")
        check(rr["on_host"] == 0, f"phase 18 {name} with the levers rank {r}: {rr['on_host']} "
              "state tensors on the host (JAX's plan keeps every one on the card under sp / pp)")
    rec = held_to_refs(f"{name} with the levers", recs, ranks_as_one(plain), f32, smi)
    same = dict(
        losses=all(rr["losses"] == pr["losses"] and rr["loss_after"] == pr["loss_after"]
                   for rr, pr in zip(recs, plain)),
        trainables=all(torch.equal(rr["s_1"][n], pr["s_1"][n])
                       for rr, pr in zip(recs, plain) for n in pr["s_1"]),
        moments=all(torch.equal(rr["m_1"][k], pr["m_1"][k])
                    for rr, pr in zip(recs, plain) for k in pr["m_1"]))
    rec.update(bit_equal_to_plain=same, pinned_gib=[rr["pinned_bytes"] / 2**30 for rr in recs],
               segments=[rr["segments"] for rr in recs])
    for r, rr in enumerate(recs):
        print(f"phase 18 {name} with the levers rank {r}: pinned {rr['pinned_bytes'] / 2**30:.3f} "
              f"GiB, state tensors on the host {rr['on_host']}, streamed segments "
              f"{rr['segments']}, peak {rr['peak_gib']:.2f} GiB (plain {plain[r]['peak_gib']:.2f}) "
              f"[{smi}]")
    print(f"phase 18 {name} with the levers: bit-equal to the plain step {json.dumps(same)}")
    return rec


# the MoE finetune step's references at Phi3-mini widths, MOE_EP_LAYERS
# layers, B TRAIN_BATCH x TRAIN_SEQ: phase 18 (c) makes them, phase 19 (c)
# holds its ranks to the same (the same config, batches and seed)
MOE_FT_REFS: dict = {}


def moe_finetune_refs(reset, read, part: str = "both") -> dict:
    """MOE_FT_REFS, made where missing: `part` "one" (the one-process bf16
    step), "f32" (the f32 run) or "both"; returns it."""
    cfg = moe_config(distill=False, layers=MOE_EP_LAYERS)
    batches = sp_pp_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    if part in ("one", "both") and "one" not in MOE_FT_REFS:
        MOE_FT_REFS["one"] = one_process_steps(cfg, batches, "finetune", reset, read)
    if part in ("f32", "both") and "f32" not in MOE_FT_REFS:
        MOE_FT_REFS["f32"] = f32_steps(cfg, batches, "finetune", chunked=False)
    return MOE_FT_REFS


def moe_route_checks(name: str, recs: list, one: dict, seq_split: bool, smi: str) -> dict:
    """The ranks' first forward's routes (each layer's (token, k) expert ids:
    of the rank's rows put together along T when `seq_split`, else each
    rank's whole batch) and the step-1 dropped share (the global batch's,
    the same on every rank) against the one-process run's: the share of
    routes equal, at least 0.99 a layer (bf16 products over T/sp rows may
    round a near tie the other way), the dropped share within 1e-3;
    whether both are equal is printed."""
    layers = len(one["routes"])
    check(layers > 0 and all(len(rr["routes"]) == layers for rr in recs),
          f"phase 18 {name}: routes of {[len(rr['routes']) for rr in recs]} layers, one process "
          f"{layers}")
    agree = []
    for lay in range(layers):
        ref = one["routes"][lay]
        if seq_split:
            b, k = SP_MOE_BATCH, ref.shape[1]
            sets = [torch.cat([rr["routes"][lay].reshape(b, -1, k) for rr in recs], 1)
                    .reshape(ref.shape)]
        else:
            sets = [rr["routes"][lay] for rr in recs]
        agree.append(min(float((got == ref).float().mean()) for got in sets))
    dropped = [rr["dropped"][0] for rr in recs]
    check(all(d == dropped[0] for d in dropped), f"phase 18 {name}: the ranks' dropped shares "
          f"{dropped} differ")
    d_one = one["dropped"][0]
    check(min(agree) >= 0.99, f"phase 18 {name}: routes agree with one process's {agree} by layer")
    check(abs(dropped[0] - d_one) <= 1e-3 and dropped[0] > 0,
          f"phase 18 {name}: dropped share {dropped[0]} (one process {d_one})")
    rec = dict(route_agreement=agree, routes_equal=min(agree) == 1.0, dropped_frac=dropped[0],
               dropped_frac_one_process=d_one, dropped_equal=dropped[0] == d_one,
               routes_per_layer=int(one["routes"][0].numel()))
    print(f"phase 18 {name}: routes of the first forward agree with one process's "
          f"{', '.join(f'{a:.6f}' for a in agree)} by layer ({rec['routes_per_layer']} a layer; "
          f"equal {rec['routes_equal']}); dropped share {dropped[0]:.6f} (one process "
          f"{d_one:.6f}; equal {rec['dropped_equal']}) [{smi}]")
    return rec


def sp_pp_phase(smi: str) -> dict:
    """Phase 18: sequence and pipeline parallelism on the card (see the
    module docstring). Returns the record printed as `sp_pp_path`."""
    import shutil

    from visper_lm_tpu_torch.ops.attention import mha_plain, multi_head_attention

    root = Path(__file__).resolve().parent / "tmp" / "chip_smoke_sp_pp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    reset, read = dp_counters()
    out = dict(card=smi)
    # both spawns' ranks start now and wait for the references below
    held = [start_ranks("--phase18-rank", 2, root / "ab", hold=True),
            start_ranks("--phase18c-rank", 4, root / "c", hold=True)]
    try:
        # (a)'s inputs and references: Llama-3-8B's attention at B1 x T8192,
        # the one-process B1/B2/B3 call and an f32 plain run
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(18)
        b, t, nq, nkv, h = 1, SP_T, 32, 8, 128
        inp = {x: torch.randn((b, t, n, h), generator=gen, device="cuda", dtype=torch.bfloat16)
               for x, n in (("q", nq), ("k", nkv), ("v", nkv), ("dout", nq))}
        torch.save({k: v.cpu() for k, v in inp.items()}, held[0]["root"] / "attn.pt")
        leaves = [inp[x].clone().requires_grad_(True) for x in "qkv"]
        reset()
        o = multi_head_attention(*leaves, causal=True)
        o.backward(inp["dout"])
        one_launches = read()
        check(one_launches == dict(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1, window_attn=0),
              f"phase 18 (a): the one-process call launched {one_launches}")
        one = dict(out=o.detach().float().cpu(), grads=[x.grad.float().cpu() for x in leaves])
        ref = dict(out=[], grads=[[], [], []])
        g = nq // nkv
        for i in range(nkv):               # one kv head's group at a time (f32 scores fit)
            lv = [inp["q"][:, :, i * g:(i + 1) * g], inp["k"][:, :, i:i + 1],
                  inp["v"][:, :, i:i + 1]]
            lv = [x.float().requires_grad_(True) for x in lv]
            of = mha_plain(*lv, causal=True)
            of.backward(inp["dout"][:, :, i * g:(i + 1) * g].float())
            ref["out"].append(of.detach().cpu())
            for j in range(3):
                ref["grads"][j].append(lv[j].grad.cpu())
            del of, lv
        f32 = dict(out=torch.cat(ref["out"], 2), grads=[torch.cat(x, 2) for x in ref["grads"]])
        del o, leaves, inp, ref
        release_cuda()
        refs_a_s = time.perf_counter() - t0

        # (b)'s references: the one-process step and the f32 run
        t0 = time.perf_counter()
        cfg_b = sp_config()
        batches_b = sp_pp_batches(cfg_b, 1, SP_T)
        one_b = one_process_steps(cfg_b, batches_b, "finetune", reset, read)
        f32_b = f32_steps(cfg_b, batches_b, "finetune", chunked=True)
        cfg_m = moe_config(False, SP_MOE_LAYERS)
        batches_m = sp_pp_batches(cfg_m, SP_MOE_BATCH, SP_T)
        one_m = one_process_steps(cfg_m, batches_m, "finetune", reset, read)
        f32_m = f32_steps(cfg_m, batches_m, "finetune", chunked=True)
        refs_b_s = time.perf_counter() - t0

        # (c)'s references (the finetune and the LoRA stage)
        t0 = time.perf_counter()
        cfg_c = pp_config()
        batches_c = sp_pp_batches(cfg_c, PP_BATCH, PP_SEQ)
        one_c = one_process_steps(cfg_c, batches_c, "finetune", reset, read)
        f32_c = f32_steps(cfg_c, batches_c, "finetune", chunked=False)
        cfg_l = pp_lora_config()
        one_l = one_process_steps(cfg_l, batches_c, "lora", reset, read)
        f32_l = f32_steps(cfg_l, batches_c, "lora", chunked=False)
        moe_refs = moe_finetune_refs(reset, read)
        refs_c_s = time.perf_counter() - t0

        # (a) and (b): two ranks, dp 1 x sp 2; (c)'s four ranks at pp 2 x tp
        # 2 share the card with (b) once (a)'s attention timings are taken
        t0 = time.perf_counter()
        release_ranks(held[0])
        wait_for_file(held[0]["root"] / "a_done", held[0])
        release_ranks(held[1])
        t_c = time.perf_counter()
        ranks = wait_ranks(held[0], "phase 18 (a)-(b)")
        (held[1]["root"] / "moe_go").touch()          # (b)'s ranks have ended: (c)'s MoE step
        ranks_ab_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks), "phase 18: the ranks did not run gloo")
        a = {}
        for name, want in (("ulysses", dict(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1,
                                              window_attn=0)),
                           ("ring", dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                                         window_attn=0))):
            recs = [r[name] for r in ranks]
            for r, rr in enumerate(recs):
                check(rr["launches"] == want, f"phase 18 (a) {name} rank {r}: launches "
                      f"{rr['launches']}, expected {want}")
            got = dict(out=torch.cat([rr["out"].float() for rr in recs], 1),
                       grads=[torch.cat([rr["grads"][j].float() for rr in recs], 1)
                              for j in range(3)])
            rec = dict(ms=[rr["ms"] for rr in recs], launches=recs[0]["launches"])
            for what, i in (("out", None), ("dq", 0), ("dk", 1), ("dv", 2)):
                x = got["out"] if i is None else got["grads"][i]
                r1 = one["out"] if i is None else one["grads"][i]
                rf = f32["out"] if i is None else f32["grads"][i]
                d_one = float((x - r1).norm() / r1.norm())
                d_f32 = float((x - rf).norm() / rf.norm())
                d_kernel = float((r1 - rf).norm() / rf.norm())
                rec[what] = dict(rel_frobenius_to_one_process=d_one, rel_frobenius_to_f32=d_f32,
                                 one_process_to_f32=d_kernel, bit_equal=bool(torch.equal(x, r1)),
                                 max_abs_err=float((x - rf).abs().max()))
                check(d_f32 <= 1e-2, f"phase 18 (a) {name} {what}: {d_f32:.4g} from f32")
                check(d_one <= 2e-2, f"phase 18 (a) {name} {what}: {d_one:.4g} from the "
                      "one-process kernel call")
            a[name] = rec
            print(f"phase 18 (a) {name} at Llama-3-8B's attention (B1 x T{SP_T}, 32/8 heads, "
                  f"H128, causal, bf16), sp 2: forward + backward ms a rank "
                  f"{', '.join(f'{x:.1f}' for x in rec['ms'])}, B1-B4 a rank {rec['launches']}; "
                  + "; ".join(f"{w} rel {rec[w]['rel_frobenius_to_one_process']:.3g} to one "
                              f"process (bit-equal {rec[w]['bit_equal']}), "
                              f"{rec[w]['rel_frobenius_to_f32']:.3g} to f32"
                              for w in ("out", "dq", "dk", "dv")) + f" [{smi}]")
        out["a"] = a
        want_b = dp_expected(SP_LAYERS, 0, 0)
        for rr in [r["b"] for r in ranks] + [one_b]:
            check(all(c == want_b for c in rr["launches"]),
                  f"phase 18 (b): launches {rr['launches']}, expected {want_b}")
        out["b"] = held_to_refs("(b) sp 2", [r["b"] for r in ranks], one_b, f32_b, smi)
        out["b_levers"] = lever_checks("(b) sp 2", [r["b_levers"] for r in ranks],
                                       [r["b"] for r in ranks], f32_b, want_b, smi)
        # (b) the MoE decoder at sp 2: routes over the seq group, held as (b)
        want_m = dp_expected(SP_MOE_LAYERS, 0, 0)
        for rr in [r["b_moe"] for r in ranks] + [one_m]:
            check(all(c == want_m for c in rr["launches"]),
                  f"phase 18 (b) MoE: launches {rr['launches']}, expected {want_m}")
        recs_m = [r["b_moe"] for r in ranks]
        out["b_moe"] = held_to_refs("(b) MoE sp 2", recs_m, one_m, f32_m, smi)
        out["b_moe"].update(moe_route_checks("(b) MoE sp 2", recs_m, one_m, True, smi))

        # (c): four ranks at pp 2 x tp 2
        ranks_c = wait_ranks(held[1], "phase 18 (c)")
        ranks_c_s = time.perf_counter() - t_c
        check([(r["stage"], r["tp_rank"]) for r in ranks_c] == [(0, 0), (0, 1), (1, 0), (1, 1)],
              f"phase 18 (c): stages {[(r['stage'], r['tp_rank']) for r in ranks_c]}")
        micro = PP_BATCH                     # JAX's rule: 4 microbatches of 1 at B4 over 2 stages
        per_stage = PP_LAYERS // 2
        want_c = dict(flash_fwd=2 * per_stage * micro, flash_bwd_dq=per_stage * micro,
                      flash_bwd_dkv=per_stage * micro, window_attn=0)
        for r, rr in enumerate(ranks_c):
            for run in ("c", "c_levers", "c_lora"):
                check(all(c == want_c for c in rr[run]["launches"]),
                      f"phase 18 {run} rank {r}: launches {rr[run]['launches']}, expected {want_c}")
                check(rr[run]["p2p"] == [micro] * SP_STEPS,
                      f"phase 18 {run} rank {r}: point-to-point sends {rr[run]['p2p']}, expected "
                      f"{micro} a step (stage 0 the activations, stage 1 their gradients)")
        want_one = dp_expected(PP_LAYERS, 0, 0)
        for name, ref in (("finetune", one_c), ("LoRA", one_l)):
            check(all(c == want_one for c in ref["launches"]),
                  f"phase 18 (c): one-process {name} launches {ref['launches']}, expected "
                  f"{want_one}")
        out["c"] = held_to_refs("(c) pp 2 x tp 2", [r["c"] for r in ranks_c], one_c, f32_c, smi)
        out["c"]["layers_by_stage"] = [ranks_c[0]["layers"], ranks_c[2]["layers"]]
        out["c_levers"] = lever_checks("(c) pp 2 x tp 2", [r["c_levers"] for r in ranks_c],
                                       [r["c"] for r in ranks_c], f32_c, want_c, smi)
        out["c_lora"] = held_to_refs("(c) LoRA r 64 at pp 2 x tp 2",
                                     [r["c_lora"] for r in ranks_c], one_l, f32_l, smi)
        # (c) the MoE decoder at pp 2 x tp 2: JAX's plain loop (no schedule,
        # no send), each foreign block gathered before its forward and its backward
        want_cm = dp_expected(MOE_EP_LAYERS, 0, 0)
        foreign = MOE_EP_LAYERS // 2
        recs_cm = [r["c_moe"] for r in ranks_c]
        for r, rr in enumerate(recs_cm + [moe_refs["one"]]):
            check(all(c == want_cm for c in rr["launches"]),
                  f"phase 18 (c) MoE {r}: launches {rr['launches']}, expected {want_cm}")
        for r, rr in enumerate(recs_cm):
            check(rr["p2p"] == [0] * SP_STEPS and rr["gathers"] == [2 * foreign] * SP_STEPS,
                  f"phase 18 (c) MoE rank {r}: sends {rr['p2p']}, foreign gathers "
                  f"{rr['gathers']} a step (expected 0 and {2 * foreign}: the plain loop)")
        out["c_moe"] = held_to_refs("(c) MoE pp 2 x tp 2", recs_cm, moe_refs["one"],
                                    moe_refs["f32"], smi)
        out["c_moe"].update(moe_route_checks("(c) MoE pp 2 x tp 2", recs_cm, moe_refs["one"],
                                             False, smi),
                            sends=recs_cm[0]["p2p"], foreign_gathers=recs_cm[0]["gathers"])
        print(f"phase 18 (c) MoE pp 2 x tp 2: the plain loop, sends a step {recs_cm[0]['p2p']}, "
              f"foreign blocks gathered a step {recs_cm[0]['gathers']} [{smi}]")
        out["seconds_by_part"] = dict(refs_a=refs_a_s, refs_b=refs_b_s, ranks_a_b=ranks_ab_s,
                                      refs_c=refs_c_s, ranks_c=ranks_c_s,
                                      rank_start=[r["start_s"] for r in ranks + ranks_c])
    finally:
        for h in held:
            stop_ranks(h)
        shutil.rmtree(root, ignore_errors=True)
        release_cuda()
    return out


def moe_config(distill: bool, layers=None):
    """Phase 19's model: Phi3-mini-4k + CLIP-L (config #1 with distill) with
    JAX's dry-run MoE (E MOE_EXPERTS, top-MOE_TOP_K, capacity factor 1.25,
    aux weight 0.01: the config's defaults); `layers` cuts its depth, its
    taps then inside the cut (DP_TAPS)."""
    import dataclasses

    from visper_lm_tpu_torch.config import make_distill_config, phi3_clip_vlm

    cfg = phi3_clip_vlm(distill=distill)
    dec = dataclasses.replace(cfg.decoder, moe_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K)
    if layers is not None:
        dec = dataclasses.replace(dec, num_layers=layers)
    cfg = dataclasses.replace(cfg, decoder=dec)
    if distill and layers is not None:
        cfg = dataclasses.replace(cfg, distill=make_distill_config(layer_indices=DP_TAPS))
    return cfg


def moe_routes(model, run, route=None) -> list:
    """run() with a hook on each MoE block's input norm: each layer's
    (token, k) expert ids (`route`, by default `ops.moe.route`, of the
    block's router on what the MoE layer reads) in the calls of more than
    one token, on the host."""
    if route is None:
        from visper_lm_tpu_torch.ops.moe import route

    routes, hooks = [], []
    for block in model.decoder.blocks:
        def hook(mod, inp, out, block=block):
            if out.shape[1] > 1:
                logits = out.reshape(-1, out.shape[-1]).float() @ block.moe_router.weight.t()
                routes.append(route(torch.softmax(logits, -1), block.cfg.moe_top_k)[1].cpu())
        hooks.append(block.mlp_norm.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return routes


def moe_drops(decoder, run) -> dict:
    """run() with a hook on the decoder: the dropped share of every forward
    (the mean over the layers), {"prefill": [...], "decode": [...]} by the
    call's length (read once run() is done: no host sync inside)."""
    seen = {"prefill": [], "decode": []}

    def hook(mod, args, kwargs, out):
        t = (args[0] if args else kwargs["inputs_embeds"]).shape[1]
        seen["prefill" if t > 1 else "decode"].append(out["moe_aux"]["dropped_frac"].detach())

    handle = decoder.register_forward_hook(hook, with_kwargs=True)
    try:
        run()
    finally:
        handle.remove()
    return {k: [float(x) for x in v] for k, v in seen.items()}


def moe_serving(smi: str, qm) -> tuple:
    """Phase 19 (a): the Generator on the MoE model at full width and depth,
    an int4 prefill, and the first MOE_F32_LAYERS layers held to an f32 run.
    Returns (the record, the model: (b) trains it)."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.ops import flash_attention as fa
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator
    from visper_lm_tpu_torch.tools.bench_decode import measure as decode_measure

    cfg = moe_config(distill=True)
    d = cfg.decoder
    batch = main_path_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=19)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_dec = sum(p.numel() for p in model.decoder.parameters())
    w_bytes = decoder_bytes(model)
    check(abs(n_dec / 11.07e9 - 1) < 0.01, f"phase 19 (a): {n_dec / 1e9:.3f} B decoder parameters, "
          "not Phi3-mini's widths with 4 experts (11.07 B)")
    check(model.decoder.blocks[0].moe_router.weight.dtype == torch.float32,
          "phase 19 (a): the router is not f32")
    gen_cfg = GenerationConfig(max_new_tokens=MOE_NEW_TOKENS)
    generator = Generator(model, cfg, gen_cfg, BATCH, PROMPT_LEN, device="cuda")
    fa.launches = 0
    holder = {}
    drops = moe_drops(model.decoder, lambda: holder.update(out=generator.generate(batch)))
    launches = fa.launches
    outputs = holder["out"]
    check(launches == d.num_layers, f"phase 19 (a): {launches} B1 launches, expected {d.num_layers}")
    check(len(outputs) == BATCH and all(len(o) == MOE_NEW_TOKENS for o in outputs)
          and all(0 <= x < d.vocab_size for o in outputs for x in o),
          f"phase 19 (a): tokens {[len(o) for o in outputs]}")
    check(len(drops["prefill"]) == 1 and len(drops["decode"]) >= MOE_NEW_TOKENS - 1,
          f"phase 19 (a): {len(drops['prefill'])} prefills, {len(drops['decode'])} decode steps")
    timing = decode_measure(generator, batch, MOE_NEW_TOKENS, warm=False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logits_bf16 = generator.prefill(batch)[0].float()
    check(bool(torch.isfinite(logits_bf16).all()), "phase 19 (a): prefill logits not finite")
    del generator
    release_cuda()

    # an int4 prefill: B5 on the attention projections and the head only
    q_gen = Generator(model, cfg, GenerationConfig(max_new_tokens=MOE_NEW_TOKENS,
                                                   weight_quant="int4"),
                      BATCH, PROMPT_LEN, device="cuda")
    qm.launches = 0
    logits_q = q_gen.prefill(batch)[0].float()
    torch.cuda.synchronize()
    q_launches = qm.launches
    t0 = time.perf_counter()
    q_gen.prefill(batch)
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    want_q = 4 * d.num_layers + 1
    check(q_launches == want_q, f"phase 19 (a): {q_launches} B5 launches an int4 prefill, "
          f"expected {want_q} (4 attention projections a layer + the head; the banks stay dense)")
    check(bool(torch.isfinite(logits_q).all()), "phase 19 (a): int4 prefill logits not finite")
    drift = float((logits_q - logits_bf16).square().mean().sqrt()
                  / logits_bf16.square().mean().sqrt())
    del q_gen, logits_q
    release_cuda()

    # the first MOE_F32_LAYERS layers, bf16 with the kernels against the same
    # weights in f32 on the plain path, routing as its own logits say (free)
    # and routing as the bf16 run did (forced: the arithmetic alone; a
    # routing flip sends a token to another expert, a jump no bf16 bound
    # covers, so flips are counted, not bounded away)
    import visper_lm_tpu_torch.ops.moe as moe_ops

    cut, cfg_c, _ = cut_depth(model, cfg, {}, MOE_F32_LAYERS)
    g_cfg = GenerationConfig(max_new_tokens=TP_NEW_TOKENS)
    gen_b = Generator(cut, cfg_c, g_cfg, BATCH, PROMPT_LEN, device="cuda")
    got, taken = {}, []
    routed = moe_ops.route

    def recording(probs, k):
        vals, idx = routed(probs, k)
        taken.append(idx)
        return vals, idx

    moe_ops.route = recording
    try:
        routes_b = moe_routes(cut, lambda: got.update(
            logits=gen_b.prefill(batch)[0].float().cpu()), route=routed)
    finally:
        moe_ops.route = routed
    tokens_b, _ = greedy_margins(gen_b, batch, TP_NEW_TOKENS)
    del gen_b
    ref = copy.deepcopy(cut).float()
    gen_f = Generator(ref, cfg_c, g_cfg, BATCH, PROMPT_LEN, cache_dtype=torch.float32,
                      device="cuda")
    routes_f = moe_routes(ref, lambda: got.update(
        logits_f=gen_f.prefill(batch, use_kernel=False)[0].float().cpu()))
    tokens_f, margins_f = greedy_margins(gen_f, batch, TP_NEW_TOKENS, use_kernel=False)
    forced = iter(taken)

    def replay(probs, k):
        idx = next(forced)
        return probs.gather(1, idx), idx

    moe_ops.route = replay
    try:
        got["logits_forced"] = gen_f.prefill(batch, use_kernel=False)[0].float().cpu()
    finally:
        moe_ops.route = routed
    del gen_f, ref, cut, taken
    release_cuda()
    scale = float(got["logits_f"].abs().max())
    diff = float((got["logits"] - got["logits_forced"]).abs().max())
    free = float((got["logits"] - got["logits_f"]).abs().max())
    # pad rows differ by design (the kernel gives a fully masked row 0, the
    # plain version the mean of v), so their routes are compared apart
    valid = (torch.arange(PROMPT_LEN)[None, :]
             >= torch.as_tensor(batch["pad_offsets"]).reshape(-1, 1)).reshape(-1)
    agree = [float((rb == rf)[valid].float().mean()) for rb, rf in zip(routes_b, routes_f)]
    agree_all = [float((rb == rf).float().mean()) for rb, rf in zip(routes_b, routes_f)]
    flips = [int((rb != rf)[valid].sum()) for rb, rf in zip(routes_b, routes_f)]
    tol = 2 * free
    low = margins_f < tol
    first_low = [int(low[:, i].nonzero()[0]) if low[:, i].any() else TP_NEW_TOKENS
                 for i in range(BATCH)]
    same_to = [next((j for j in range(TP_NEW_TOKENS) if tokens_b[j, i] != tokens_f[j, i]),
                    TP_NEW_TOKENS) for i in range(BATCH)]
    print(f"phase 19 (a) {MOE_F32_LAYERS} layers bf16 + kernels vs f32 plain: prefill logits max "
          f"abs {diff:.4g} with the bf16 run's routes, {free:.4g} routing freely (max |logit| "
          f"{scale:.4g}); routes of the {int(valid.sum())} tokens agree by layer "
          f"{', '.join(f'{a:.4f}' for a in agree)} (flips {flips} of "
          f"{int(valid.sum()) * MOE_TOP_K}; with the pad rows "
          f"{', '.join(f'{a:.4f}' for a in agree_all)}); greedy tokens equal through {same_to} "
          f"(f32 margin first under {tol:.4g} at {first_low})")
    check(diff <= 0.05 * scale, f"phase 19 (a): {MOE_F32_LAYERS}-layer prefill logits {diff:.4g} "
          f"from f32 on the same routes, beyond 0.05 x {scale:.4g}")
    check(len(routes_b) == len(routes_f) == MOE_F32_LAYERS, "phase 19 (a): routes not captured")
    check(min(agree) >= 0.9, f"phase 19 (a): (token, k) routes agree with f32's {agree} by layer")
    check(all(g >= f for g, f in zip(same_to, first_low)),
          f"phase 19 (a): tokens differ from f32's at {same_to} before the first position where "
          f"the f32 top-2 margin falls under {tol:.4g} ({first_low})")
    rec = dict(card=smi, decoder_params=n_dec, weight_gb=w_bytes / 1e9, weight_gib=w_bytes / 2**30,
               init_s=init_s, b1_launches_prefill=launches, peak_gib=peak, **timing,
               dropped_frac_prefill=drops["prefill"][0],
               dropped_frac_decode_mean=sum(drops["decode"]) / len(drops["decode"]),
               dropped_frac_decode_max=max(drops["decode"]),
               int4=dict(b5_launches_prefill=q_launches, prefill_ms=q_ms, drift_vs_bf16=drift),
               f32_hold=dict(layers=MOE_F32_LAYERS, logits_max_abs=diff, max_abs_logit=scale,
                             logits_max_abs_free=free,
                             route_agreement=agree, route_flips=flips,
                             route_agreement_with_pad_rows=agree_all,
                             routes_per_layer=int(valid.sum()) * MOE_TOP_K, tolerance=tol,
                             tokens_equal_through=same_to, first_low_margin=first_low))
    print(f"phase 19 (a) MoE Generator (Phi3-mini widths, {d.num_layers} layers, E "
          f"{d.moe_experts} top-{d.moe_top_k}, cf {d.moe_capacity_factor}, bf16; {n_dec / 1e9:.3f} "
          f"B decoder parameters, {w_bytes / 1e9:.2f} GB = {w_bytes / 2**30:.2f} GiB): B{BATCH} x "
          f"{PROMPT_LEN} prefill {timing['prefill_s'] * 1e3:.1f} ms, decode "
          f"{timing['decode_step_ms']:.2f} ms/token ({MOE_NEW_TOKENS} tokens), peak "
          f"{peak:.2f} GiB, B1 {launches} a prefill; dropped share prefill "
          f"{rec['dropped_frac_prefill']:.4f}, decode mean {rec['dropped_frac_decode_mean']:.4f} "
          f"max {rec['dropped_frac_decode_max']:.4f} (N 8: capacity 5) [{smi}]")
    print(f"phase 19 (a) int4 prefill: B5 {q_launches} a forward, {q_ms:.1f} ms, RMS drift vs bf16 "
          f"{drift:.4g} [{smi}]")
    return rec, model


def moe_pt_hold(teachers, tfn, reset, read) -> dict:
    """Phase 19 (b)'s hold: config #1's PT step with the MoE decoder cut to
    MOE_PT_LAYERS layers, bf16 (save_gate, the kernels) against the same
    student in f32 (plain attention, the port's AdamW in f32) from the same
    weights on DP_STEPS batches: phase 16's tolerances of a bf16 run from
    f32, and its two checks that the bounds can fail."""
    from visper_lm_tpu_torch.models.vlm import init_vlm
    from visper_lm_tpu_torch.tools.bench import bench_batch
    from visper_lm_tpu_torch.train.optimizer import AdamW
    from visper_lm_tpu_torch.train.train_step import make_loss_fn, make_train_step

    cfg = moe_config(distill=True, layers=MOE_PT_LAYERS)
    batches = [bench_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, True, seed=s) for s in range(DP_STEPS)]
    model = init_vlm(cfg, device="cuda", seed=19)
    step = make_train_step(cfg, dp_opt_cfg("pretrain"), model, teacher_fn=tfn,
                           teacher_params=teachers, remat_policy="save_gate")
    names = list(step.trainable)
    p0 = {n: p.detach().clone() for n, p in step.trainable.items()}
    still = dp_loss_at(step, batches[-1])
    kept = dp_grads(step)
    one = dp_steps(step, batches, reset, read)
    g_1 = {n: s for n, (_, s) in kept.items()}
    move_1 = deltas({n: p.detach().cpu() for n, p in step.trainable.items()},
                    {n: p.cpu() for n, p in p0.items()})
    del step
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n in names:
            params[n].copy_(p0[n])
    model.float()
    loss_fn = make_loss_fn(cfg, teacher_fn=tfn, use_kernel=False)
    opt_f = AdamW(((n, params[n]) for n in names), dp_opt_cfg("pretrain"))
    losses_f, g_f = [], None
    for batch in batches:
        dbatch = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
        loss, grads = loss_and_grads(loss_fn, model, dbatch, teachers, [params[n] for n in names])
        grads = {n: torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)}
        if g_f is None:
            g_f = {n: dp_sample(g) for n, g in grads.items()}
        opt_f.step(grads)
        losses_f.append(loss)
        del grads, dbatch
    move_f = deltas({n: params[n].detach().cpu() for n in names},
                    {n: p.cpu() for n, p in p0.items()})
    del opt_f, params, model, p0
    release_cuda()
    d_loss = [abs(a - f) / abs(f) for a, f in zip(one["losses"], losses_f)]
    d_grad = rel_fro(g_1, g_f)
    e_1 = rel_fro(move_1, move_f)
    tol_last = 2 * abs(one["losses"][-1] - losses_f[-1]) + 1e-4 * abs(one["losses"][-1])
    moved = abs(one["losses"][-1] - still)
    check(max(d_loss) <= 1e-2, f"phase 19 (b): losses {d_loss} from f32 at {MOE_PT_LAYERS} layers")
    check(d_grad <= 3e-2, f"phase 19 (b): step-1 gradients {d_grad:.4g} from f32")
    check(moved > 3 * tol_last, f"phase 19 (b): the updates move the last loss {moved:.3g}, not "
          f"beyond 3 x its tolerance {tol_last:.3g}")
    check(3 * e_1 + 1e-2 <= 0.75, f"phase 19 (b): bf16 moves {e_1:.3g} from f32, too far to tell "
          "an update from none")
    want = dp_expected(MOE_PT_LAYERS, 24, TRAIN_BATCH)
    check(all(c == want for c in one["launches"]),
          f"phase 19 (b) hold: launches {one['launches']}, expected {want} a step")
    return dict(layers=MOE_PT_LAYERS, losses=one["losses"], losses_f32=losses_f, loss_rel=d_loss,
                grads_rel_frobenius=d_grad, moves_rel_frobenius=e_1, last_loss_moved=moved,
                last_loss_tolerance=tol_last, launches_per_step=one["launches"][-1])


def moe_training(smi: str, model, reset, read) -> dict:
    """Phase 19 (b): bench.py config #1's PT step (B4 x T1024, the teachers
    in the step, save_gate) with the MoE decoder at full depth, then the
    hold at MOE_PT_LAYERS layers."""
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.tools.bench import bench_batch
    from visper_lm_tpu_torch.train.train_step import make_train_step

    cfg = moe_config(distill=True)
    d = cfg.decoder
    teachers = init_teachers(cfg, device="cuda", seed=7)
    tfn = make_teacher_fn(cfg)
    n_swin = sum(teachers["swin"].cfg.depths)
    step = make_train_step(cfg, dp_opt_cfg("pretrain"), model, teacher_fn=tfn,
                           teacher_params=teachers, remat_policy="save_gate")
    tbatch = bench_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, True)
    first = step(tbatch)                                 # update 1: lr 0
    torch.cuda.reset_peak_memory_stats()
    want = dp_expected(d.num_layers, n_swin, TRAIN_BATCH)
    steps = dp_steps(step, [tbatch] * MOE_PT_STEPS, reset, read)
    peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = step.last_metrics
    losses = [first["loss"]] + steps["losses"]
    check(all(c == want for c in steps["launches"]),
          f"phase 19 (b): launches {steps['launches']}, expected {want} a step")
    check(all(math.isfinite(x) for x in losses) and losses[-1] != losses[-2],
          f"phase 19 (b): losses {losses}")
    check(all(math.isfinite(metrics[k]) for k in ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")),
          f"phase 19 (b): MoE metrics {metrics}")
    del step, model
    release_cuda()
    hold = moe_pt_hold(teachers, tfn, reset, read)
    del teachers
    release_cuda()
    rec = dict(card=smi, step_ms=steps["step_ms"], peak_gib=peak, losses=losses,
               launches_per_step=steps["launches"][-1],
               moe=dict(lb_loss=metrics["moe_lb_loss"], z_loss=metrics["moe_z_loss"],
                        dropped_frac=metrics["moe_dropped_frac"]), hold=hold)
    print(f"phase 19 (b) PT step, MoE decoder at {d.num_layers} layers (B{TRAIN_BATCH} x "
          f"T{TRAIN_SEQ}, teachers in the step, save_gate): "
          f"{', '.join(f'{x:.1f}' for x in steps['step_ms'])} ms a step, peak {peak:.2f} GiB, "
          f"B1-B4 a step {steps['launches'][-1]}, losses {losses}, moe {json.dumps(rec['moe'])} "
          f"[{smi}]")
    print(f"phase 19 (b) at {MOE_PT_LAYERS} layers bf16 vs f32: losses {hold['losses']} vs "
          f"{hold['losses_f32']} (rel {', '.join(f'{x:.3g}' for x in hold['loss_rel'])}); step-1 "
          f"gradients rel Frobenius {hold['grads_rel_frobenius']:.4g}; moves "
          f"{hold['moves_rel_frobenius']:.4g}; B1-B4 a step {hold['launches_per_step']}")
    return rec


def ep_rank(argv) -> int:
    """One of phase 19 (c)'s two ranks (`chip_smoke.py --phase19-rank R PORT
    DIR`, dp 1 x ep 2 sharing the card over gloo): the finetune step of the
    MoE decoder at Phi3-mini widths, MOE_EP_LAYERS layers, the rank's two
    experts, then the same with offload_opt_state. The rank builds its model
    while the parent may still hold the card (an f32 run not made in phase
    18), and steps only once DIR/go exists, so its step times are its own.
    Writes DIR/rank<R>.pt."""
    from visper_lm_tpu_torch.ops.moe import expert_parallel
    from visper_lm_tpu_torch.parallel import distributed as D

    rank, port, root = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    D.init_distributed(f"localhost:{port}", 2, rank, local_device_ids=[0], device="cuda",
                       backend="gloo")
    mesh = D.make_global_mesh(dp=1, ep=2)
    ep = expert_parallel(mesh)
    out = dict(backend=str(torch.distributed.get_backend()), start_s=time.perf_counter() - t_start,
               expert_rank=ep.rank)

    def ready() -> float:
        t0 = time.perf_counter()
        while not (root / "go").exists():
            time.sleep(0.05)
        D.barrier()
        return time.perf_counter() - t0

    cfg = moe_config(distill=False, layers=MOE_EP_LAYERS)
    dev = torch.device("cuda", 0)
    out["c"] = sp_pp_rank_steps(cfg, mesh, dev, ep=ep, shape=(TRAIN_BATCH, TRAIN_SEQ),
                                ready=ready, moments=True)
    # the same with the moments offloaded where JAX's plan says (the banks')
    out["c_offload"] = sp_pp_rank_steps(cfg, mesh, dev, ep=ep, shape=(TRAIN_BATCH, TRAIN_SEQ),
                                        step_kw=dict(offload_opt_state=True), moments=True)
    out["seconds"] = time.perf_counter() - t_start
    torch.save(out, root / f"rank{rank}.pt")
    D.barrier()
    D.shutdown()
    return 0


def moe_ep(smi: str, reset, read, held: dict) -> dict:
    """Phase 19 (c): the finetune step at ep 2 on two gloo ranks sharing the
    card (`held`: started at the phase's start), held to the one-process
    step and an f32 run by phase 16's bounds."""
    root = held["root"]
    try:
        cfg = moe_config(distill=False, layers=MOE_EP_LAYERS)
        one = moe_finetune_refs(reset, read, "one")["one"]
        whole_banks = MOE_EP_LAYERS * 3 * MOE_EXPERTS * cfg.decoder.hidden_size * \
            cfg.decoder.mlp_dim * 2
        # the ranks start, import and build their models while the f32 run
        # (whose times are not read; phase 18 made it in a whole run) holds
        # the card; they step only after it (DIR/go), so their step times
        # are taken with the card theirs alone
        t0 = time.perf_counter()
        release_ranks(held)
        f32 = moe_finetune_refs(reset, read, "f32")["f32"]
        release_cuda()
        (root / "go").touch()
        ranks = wait_ranks(held, "phase 19 (c)")
        ranks_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks), "phase 19 (c): the ranks did not run gloo")
        check([r["expert_rank"] for r in ranks] == [0, 1], "phase 19 (c): expert ranks")
        want = dp_expected(MOE_EP_LAYERS, 0, 0)
        for rr in [r["c"] for r in ranks] + [one]:
            check(all(c == want for c in rr["launches"]),
                  f"phase 19 (c): launches {rr['launches']}, expected {want}")
        for r, rr in enumerate(ranks):
            check(rr["c"]["bank_bytes"] * 2 == whole_banks,
                  f"phase 19 (c) rank {r}: {rr['c']['bank_bytes']} bytes of banks, not half of "
                  f"{whole_banks}")
        router = [n for n in ranks[0]["c"]["s_1"] if ".moe_router." in n]
        check(router and all(torch.equal(ranks[0]["c"]["s_1"][n], ranks[1]["c"]["s_1"][n])
                             for n in router), "phase 19 (c): the routers differ after the update")
        rec = held_to_refs("(c) ep 2", [r["c"] for r in ranks], one, f32, smi, phase="19")
        rec.update(bank_bytes_a_rank=[r["c"]["bank_bytes"] for r in ranks],
                   bank_bytes_whole=whole_banks, ranks_s=ranks_s,
                   ranks_waited_s=[r["c"]["waited_s"] for r in ranks])
        print(f"phase 19 (c) ep 2: banks {ranks[0]['c']['bank_bytes'] / 2**30:.3f} GiB a rank of "
              f"{whole_banks / 2**30:.3f}; routers and replicated parameters bit-equal across the "
              f"ranks [{smi}]")
        rec["offload"] = ep_offload_checks([r["c_offload"] for r in ranks],
                                           [r["c"] for r in ranks], want, smi)
    finally:
        release_cuda()
    return rec


def ep_offload_checks(recs: list, plain: list, want: dict, smi: str) -> dict:
    """Phase 19 (c) with offload_opt_state at ep 2: JAX's plan (`_covers_mesh`
    on the one axis wider than 1, 'expert') puts every bank's mu and nu (the
    rank's E/ep experts of them) on the host and keeps each dense moment on
    the card; B1-B3 `want` a step; the losses, the trainables and the
    moments bit-equal to the plain ep 2 step's, rank by rank; the pinned
    bytes a rank those of its banks' moments."""
    banks = sorted(f"{k}/decoder.blocks.{i}.{n}.kernel" for k in ("mu", "nu")
                   for i in range(MOE_EP_LAYERS) for n in ("moe_down", "moe_gate", "moe_up"))
    for r, (rr, pr) in enumerate(zip(recs, plain)):
        check(all(c == want for c in rr["launches"]),
              f"phase 19 (c) offloaded rank {r}: launches {rr['launches']}, expected {want}")
        check(rr["host_keys"] == banks and rr["state_tensors"] > len(banks),
              f"phase 19 (c) offloaded rank {r}: on the host {rr['host_keys']} of "
              f"{rr['state_tensors']} state tensors; expected the banks' moments {banks}")
        held = rr["bank_bytes"] * (4 + 2) // 2      # mu f32 and nu bf16 of the rank's banks
        check(rr["pinned_bytes"] >= held, f"phase 19 (c) offloaded rank {r}: "
              f"{rr['pinned_bytes']} bytes pinned for {held} of the banks' moments")
    same = dict(
        losses=all(rr["losses"] == pr["losses"] and rr["loss_after"] == pr["loss_after"]
                   for rr, pr in zip(recs, plain)),
        trainables=all(torch.equal(rr["s_1"][n], pr["s_1"][n])
                       for rr, pr in zip(recs, plain) for n in pr["s_1"]),
        moments=all(torch.equal(rr["m_1"][k], pr["m_1"][k])
                    for rr, pr in zip(recs, plain) for k in pr["m_1"]))
    check(all(same.values()), f"phase 19 (c) offloaded: not bit-equal to the plain ep 2 step "
          f"{same}")
    rec = dict(bit_equal_to_plain=same, on_host=len(banks),
               on_card=[rr["state_tensors"] - rr["on_host"] for rr in recs],
               launches_per_step=recs[0]["launches"][-1],
               pinned_gib=[rr["pinned_bytes"] / 2**30 for rr in recs],
               step_ms=[rr["step_ms"] for rr in recs], peak_gib=[rr["peak_gib"] for rr in recs])
    for r, rr in enumerate(recs):
        print(f"phase 19 (c) ep 2 with offload_opt_state rank {r}: {rr['on_host']} state tensors "
              f"on the host (the banks' mu and nu), {rec['on_card'][r]} on the card, pinned "
              f"{rec['pinned_gib'][r]:.3f} GiB, peak {rr['peak_gib']:.2f} GiB (plain "
              f"{plain[r]['peak_gib']:.2f}), step ms {', '.join(f'{x:.1f}' for x in rr['step_ms'])} "
              f"(plain {', '.join(f'{x:.1f}' for x in plain[r]['step_ms'])}) [{smi}]")
    print(f"phase 19 (c) ep 2 with offload_opt_state: bit-equal to the plain step "
          f"{json.dumps(same)}")
    return rec


def moe_phase(smi: str) -> dict:
    """Phase 19: the MoE decoder and expert parallelism (see the module
    docstring). Returns the record printed as `moe_path`."""
    import shutil

    from visper_lm_tpu_torch.ops import quant_matmul as qm

    reset, read = dp_counters()
    out = {}
    root = Path(__file__).resolve().parent / "tmp" / "chip_smoke_ep"
    shutil.rmtree(root, ignore_errors=True)
    # (c)'s two ranks start now and wait through (a) and (b)
    held = start_ranks("--phase19-rank", 2, root, hold=True)
    try:
        t0 = time.perf_counter()
        out["a"], model = moe_serving(smi, qm)
        out["seconds_a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b"] = moe_training(smi, model, reset, read)
        out["seconds_b"] = time.perf_counter() - t0
        del model
        release_cuda()
        t0 = time.perf_counter()
        out["c"] = moe_ep(smi, reset, read, held)
        out["seconds_c"] = time.perf_counter() - t0
    finally:
        stop_ranks(held)
        shutil.rmtree(root, ignore_errors=True)
    return out


def release_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def cli_batches(cfg, args, ds, teacher_batch):
    """The CLI's PT batches (`cli.main`'s data_iter without the prefetch):
    splice plans and tower pixels, then the teachers' pixels of the raw
    images."""
    from visper_lm_tpu_torch.data.dataset import RAW_IMAGES, BatchIterator

    tasks = tuple(t.task for t in cfg.distill.tasks)
    for batch in BatchIterator(ds, args.per_device_batch_size, seed=0, distill_tasks=tasks,
                               seq_buckets=tuple(int(x) for x in args.seq_buckets.split(","))):
        batch.update(teacher_batch(cfg, batch.pop(RAW_IMAGES), workers=4))
        yield batch


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_entries = {"--phase16-rank": dp_rank, "--phase17-rank": tp_rank,
                    "--phase17c-rank": tp_recipe_rank, "--phase18-rank": sp_rank,
                    "--phase18c-rank": pp_rank, "--phase19-rank": ep_rank}
    if sys.argv[1:2] and sys.argv[1] in rank_entries:
        argv = sys.argv[2:]
        if argv[1] == "hold":
            argv[1] = held_port(Path(argv[2]))
        return rank_entries[sys.argv[1]](argv)
    from visper_lm_tpu_torch.config import LLAMA3_8B, phi3_clip_vlm
    from visper_lm_tpu_torch.models.teachers import init_teachers, make_teacher_fn
    from visper_lm_tpu_torch.models.decoder import quantize_head_vectors
    from visper_lm_tpu_torch.models.teachers import swin
    from visper_lm_tpu_torch.models.vlm import encode_images, init_vlm, splice_embeddings
    from visper_lm_tpu_torch.ops import _build
    from visper_lm_tpu_torch.ops import decode_attention as da
    from visper_lm_tpu_torch.ops import flash_attention as fa
    from visper_lm_tpu_torch.ops import quant_matmul as qm
    from visper_lm_tpu_torch.ops import window_attention as wa
    from visper_lm_tpu_torch.serve.calibrate import decoder_act_rms
    from visper_lm_tpu_torch.serve.generate import GenerationConfig, Generator
    from visper_lm_tpu_torch.tools.bench import bench_batch, time_steps
    from visper_lm_tpu_torch.tools.bench_decode import measure as decode_measure
    from visper_lm_tpu_torch.utils import param
    from visper_lm_tpu_torch.train.optimizer import OptimizerConfig
    from visper_lm_tpu_torch.train.train_step import make_loss_fn, make_train_step

    # reference settings: f32 matmuls in full f32, no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    progress("phase 1")
    # 1. environment
    smi = environment(_build)
    name = torch.cuda.get_device_name(0)

    progress("phase 2")
    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    print("build seconds by library " + json.dumps(
        {lib: round(sec, 1) for lib, sec in _build.build_seconds.items()}))
    for lib, log in logs.items():
        for entry, res in _build.kernel_resources(log).items():
            print(f"ptxas[{lib}] {entry}: {json.dumps(res)}")
    if sys.argv[1:] and set(sys.argv[1:]) <= {"--phase18", "--phase19"}:
        # phase 18 and / or 19 on their own, after the build (a measurement
        # run; with both, phase 19 takes phase 18's MoE references as in the
        # whole run)
        if "--phase18" in sys.argv[1:]:
            t0 = time.perf_counter()
            sp_pp = sp_pp_phase(smi)
            sp_pp["seconds"] = time.perf_counter() - t0
            print(f"sp_pp phase {sp_pp['seconds']:.1f} s [{smi}]")
            print("sp_pp_path " + json.dumps(sp_pp))
        if "--phase19" in sys.argv[1:]:
            t0 = time.perf_counter()
            moe = moe_phase(smi)
            moe["seconds"] = time.perf_counter() - t0
            print(f"moe phase {moe['seconds']:.1f} s [{smi}]")
            print("moe_path " + json.dumps(moe))
        return 0
    if sys.argv[1:2] in (["--phase16"], ["--phase17"]):
        # phase 16 (with --phase17 phase 17 after it) on its own, after the
        # build (a measurement run; the contract's run takes no argument and
        # runs every phase)
        ref = {}
        dp = dp_phase(smi, ref)
        print("dp_path " + json.dumps(dp))
        if sys.argv[1] == "--phase17":
            t0 = time.perf_counter()
            tp = tp_phase(smi, ref)
            tp["seconds"] = time.perf_counter() - t0
            print(f"tp phase {tp['seconds']:.1f} s [{smi}]")
            print("tp_path " + json.dumps(tp))
        return 0
    # the redesigned kernels: registers, spills and shared memory
    smem, kv_tile, stages = (ctypes.c_int() for _ in range(3))
    for h in fa.SUPPORTED_HEAD_DIMS:
        check(_build.load("flash_fwd").visper_flash_fwd_wgmma_info(
            h, ctypes.byref(smem), ctypes.byref(kv_tile), ctypes.byref(stages)) == 0,
            f"no wgmma forward kernel at H{h}")
        print(f"flash_fwd wgmma H{h}: {smem.value} B dynamic shared memory, {kv_tile.value}-key "
              f"tiles, {stages.value} stages, 288 threads, 1 CTA per SM")
    dq_smem, dkv_smem, threads = (ctypes.c_int() for _ in range(3))
    for h in fa.SUPPORTED_HEAD_DIMS:
        check(_build.load("flash_bwd").visper_flash_bwd_wgmma_info(
            h, ctypes.byref(dq_smem), ctypes.byref(dkv_smem), ctypes.byref(stages),
            ctypes.byref(threads)) == 0, f"no wgmma backward kernels at H{h}")
        print(f"flash_bwd wgmma H{h}: dq {dq_smem.value} B, dk/dv {dkv_smem.value} B dynamic shared "
              f"memory, {stages.value} stages, {threads.value} threads (two warpgroups; warp 0 "
              f"refills the ring), 1 CTA per SM")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    win_threads, win_ctas = ctypes.c_int(), ctypes.c_int()
    for nw in (0, SWIN_STAGES[0][0] // 2):
        plan = wa.window_attn_plan(*SWIN_STAGES[0], 144, 32, nw, sms)
        check(_build.load("window_attn").visper_window_attn_info(
            144, 32, int(nw > 0), plan.stages,
            ctypes.byref(win_threads), ctypes.byref(smem), ctypes.byref(win_ctas)) == 0,
            "no streamed window kernel at N144 D32")
        check(smem.value == plan.smem_bytes,
              f"window_attn_plan counts {plan.smem_bytes} B of shared memory, the kernel {smem.value}")
        check(win_ctas.value >= 1, f"the streamed window kernel does not fit an SM: {plan}")
        print(f"window_attn streamed N144 D32 {'shifted' if nw else 'unshifted'} stage 1: "
              f"{smem.value} B dynamic shared memory, {win_threads.value} threads, "
              f"{win_ctas.value} CTA per SM; plan {json.dumps(plan._asdict())}")
    for lib, mark in (("flash_fwd", "wgmma_kernel"), ("flash_bwd", "wgmma_kernel"),
                      ("decode_attn", "split_kernel"), ("window_attn", "stream_kernel")):
        for entry, res in _build.kernel_resources(logs.get(lib, "")).items():
            if mark in entry:
                check(res["spill_bytes"] == 0, f"{entry} spills {res['spill_bytes']} bytes")
        # ptxas reports a wgmma it had to serialise only as an info line
        for ln in logs.get(lib, "").splitlines():
            if "C75" in ln:
                print(f"ptxas[{lib}] {ln.strip()}")

    cfg = phi3_clip_vlm(distill=True)
    batch = main_path_batch(cfg)
    offsets = batch["pad_offsets"].tolist()
    print(f"main-path pad offsets {offsets}")

    progress("phase 3")
    # 3. kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = cfg.decoder
    slice_rec = kernel_case(
        "slice", BATCH, PROMPT_LEN, d.num_heads, d.num_kv_heads, d.head_dim,
        torch.bfloat16, True, offsets, [PROMPT_LEN] * BATCH, gen, fa, old=True,
    )
    kernel_case("gqa", 2, 1024, 32, 8, 128, torch.bfloat16, True, [0, 100], [1024, 1024], gen, fa)
    kernel_case("noncausal_kvlen", 2, 512, 16, 16, 64, torch.bfloat16, False, [0, 0], [512, 300], gen, fa)
    kernel_case("f32", 2, 256, 8, 8, 96, torch.float32, True, [0, 50], [256, 256], gen, fa)
    tbatch = bench_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, True)
    train_lens = tbatch["seq_lengths"].tolist()
    print(f"training batch seq_lengths {train_lens}")
    train_fwd_rec = kernel_case(
        "train", TRAIN_BATCH, TRAIN_SEQ, d.num_heads, d.num_kv_heads, d.head_dim,
        torch.bfloat16, True, [0] * TRAIN_BATCH, train_lens, gen, fa, old=True,
    )
    dq_rec, dkv_rec = bwd_case(
        "train", TRAIN_BATCH, TRAIN_SEQ, d.num_heads, d.num_kv_heads, d.head_dim, True,
        [0] * TRAIN_BATCH, train_lens, gen, fa,
    )
    gqa_dq, gqa_dkv = bwd_case("gqa", 2, 1024, 32, 8, 128, True, [0, 100], [1024, 900], gen, fa)
    # B1-B3 at phase 12's recipe PT shape: Llama-3-8B, B4 x T1024, GQA 32/8 H128, causal
    l3 = LLAMA3_8B
    full = ([0] * RECIPE_BATCH, [TRAIN_SEQ] * RECIPE_BATCH)
    recipe_fwd = kernel_case("recipe_pt", RECIPE_BATCH, TRAIN_SEQ, l3.num_heads, l3.num_kv_heads,
                             l3.head_dim, torch.bfloat16, True, *full, gen, fa)
    recipe_dq, recipe_dkv = bwd_case("recipe_pt", RECIPE_BATCH, TRAIN_SEQ, l3.num_heads,
                                     l3.num_kv_heads, l3.head_dim, True, *full, gen, fa)
    win_recs = [
        window_case(i, w, heads, shifted, gen, wa, swin)
        for i, (w, heads) in enumerate(SWIN_STAGES) for shifted in (False, True)
    ]
    win_rec = win_recs[1]                       # stage 1, shifted: the largest launch
    # B4 in a train step: every Swin-L block launches once per teacher
    # micro-batch of 2, the odd blocks of each stage shifted
    win_step = dict(ms=0.0, library_ms=0.0, bound_ms=0.0, launches=0)
    for rec, depth in zip(win_recs, [dd for dd in swin.SWIN_L.depths for _ in range(2)]):
        n_launch = depth // 2 * (TRAIN_BATCH // 2)
        win_step["launches"] += n_launch
        for key in ("ms", "library_ms", "bound_ms"):
            win_step[key] += n_launch * rec[key]
    print("window_attn per train step (launch-weighted; CUDA graphs) " + json.dumps(win_step))
    # B5 at the quantized serving path's linears: prefill (M = B8 x T768) and
    # decode (M = 8); lm_head runs at M = 8 only (prefill keeps the last row)
    h_, m_, v_ = d.hidden_size, d.mlp_dim, d.vocab_size
    w4_recs = {}
    for lname, din, dout in (("qkvo", h_, d.num_heads * d.head_dim), ("gate_up", h_, m_),
                             ("down", m_, h_)):
        for m in (BATCH, BATCH * PROMPT_LEN):
            key = f"{lname}_M{m}"
            w4_recs[key] = w4_case(key, m, din, dout, gen, qm, param)
    w4_recs["lm_head_M8"] = w4_case("lm_head_M8", BATCH, h_, v_, gen, qm, param)
    w4_recs["gate_up_M8_awq"] = w4_case("gate_up_M8_awq", BATCH, h_, m_, gen, qm, param, awq=True)
    w4_rec = w4_recs[f"gate_up_M{BATCH * PROMPT_LEN}"]
    # B5 at a tp 2 rank's slices of the same linears (phase 17 (d)'s path)
    qkv_ = d.num_heads * d.head_dim
    w4_tp2 = {f"{lname}_M{BATCH * PROMPT_LEN}": w4_case(f"tp2_{lname}", BATCH * PROMPT_LEN, din,
                                                       dout, gen, qm, param)
              for lname, din, dout in (("qkv", h_, qkv_ // 2), ("o", qkv_ // 2, h_),
                                       ("gate_up", h_, m_ // 2), ("down", m_ // 2, h_))}
    # B6 at the decode shape (this Generator's max_len 896, the last decode
    # step's lengths 800 over the main path's left pads) in bf16 and int8, and
    # GQA 32/8 H128 with a fully masked row (batch row 2)
    serve_max_len = -(-(PROMPT_LEN + B6_DECODED + 1) // 128) * 128
    dec_lens = [PROMPT_LEN + B6_DECODED] * BATCH
    dec_bf16 = decode_case("decode_bf16", BATCH, d.num_heads, d.num_kv_heads, d.head_dim,
                           serve_max_len, False, offsets, dec_lens, gen, da, quantize_head_vectors)
    dec_rec = decode_case("decode_int8", BATCH, d.num_heads, d.num_kv_heads, d.head_dim,
                          serve_max_len, True, offsets, dec_lens, gen, da, quantize_head_vectors)
    for quant in (False, True):
        decode_case(f"decode_gqa_{'int8' if quant else 'bf16'}", 4, 32, 8, 128, 1024, quant,
                    [0, 100, 0, 0], [1024, 700, 0, 1024], gen, da, quantize_head_vectors)

    progress("phase 4")
    # 4. main path
    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"init_vlm {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    gen_cfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    generator = Generator(model, cfg, gen_cfg, BATCH, PROMPT_LEN, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0                             # B6: no path may call it (read after phase 9)
    t0 = time.perf_counter()
    outputs = generator.generate(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == d.num_layers,
          f"flash kernel launched {launches} times in the main path, expected {d.num_layers}")
    check(len(outputs) == BATCH and all(len(o) == NEW_TOKENS for o in outputs),
          f"expected {BATCH}x{NEW_TOKENS} tokens, got {[len(o) for o in outputs]}")
    check(all(0 <= tok < d.vocab_size for o in outputs for tok in o), "token out of vocab")
    print(f"main path: {launches} flash launches, {BATCH}x{NEW_TOKENS} tokens, "
          f"first run {first_s:.3f} s, peak {peak / 2**30:.2f} GiB")
    print(f"sample tokens {outputs[0][:8]} ... {outputs[-1][:8]}")

    # prefill logits: kernel path vs plain attention
    # [0]: the logits only; a cache kept in `_` would hold 1.4 GB to the end
    logits_k = generator.prefill(batch)[0]
    logits_p = generator.prefill(batch, use_kernel=False)[0]
    torch.cuda.synchronize()
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    check(tuple(logits_k.shape) == (BATCH, d.vocab_size), f"logits shape {tuple(logits_k.shape)}")
    diff = (logits_k - logits_p).abs().max().item()
    scale = logits_p.abs().max().item()
    agree = int((logits_k.argmax(-1) == logits_p.argmax(-1)).sum())
    print(f"prefill logits kernel vs plain: max abs diff {diff:.4g}, max |logit| {scale:.4g}, "
          f"argmax agree {agree}/{BATCH}")
    check(diff <= 0.05 * scale, f"prefill logits differ by {diff} > 0.05 x {scale}")

    # the decode slot lives on the device: the same prefill and cache decoded
    # with a Python-int q_offset must give the same tokens, bit for bit
    logits_s, cache_s = generator.prefill(batch)
    first = logits_s.argmax(-1)
    cache_i = type(cache_s)(*(t.clone() for t in vars(cache_s).values()))
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    chunk = gen_cfg.decode_chunk
    step, tok, slot_toks = torch.zeros((), dtype=torch.long, device="cuda"), first, []
    for _ in range(-(-(NEW_TOKENS - 1) // chunk)):
        slot_toks.append(generator._decode_chunk(cache_s, tok, step, offs,
                                                 torch.Generator(device="cuda")))
        tok, step = slot_toks[-1][-1], step + chunk
    slot_toks = torch.cat(slot_toks)
    int_toks = int_offset_decode(generator, cache_i, first, offs, slot_toks.shape[0])
    check(torch.equal(slot_toks, int_toks),
          f"device-slot decode differs from the int-offset decode at "
          f"{int((slot_toks != int_toks).sum())} of {slot_toks.numel()} tokens")
    check(torch.equal(cache_s.k, cache_i.k) and torch.equal(cache_s.v, cache_i.v),
          "device-slot and int-offset decodes wrote different caches")
    gen_toks = torch.cat([first[None], slot_toks])[:NEW_TOKENS].T.tolist()
    check(gen_toks == outputs, "generate() differs from its own prefill + decode chunks")
    print(f"device-slot decode: {slot_toks.shape[0]} x {BATCH} tokens and the cache equal to "
          f"the int-offset decode's, bit for bit")
    del logits_s, cache_s, cache_i

    timing = dict(decode_measure(generator, batch, NEW_TOKENS, warm=False), peak_gib=peak / 2**30)
    print("main_path " + json.dumps(timing))

    progress("phase 5")
    # 5. where the time goes: device time by op for one prefill and one decode chunk
    logits, cache = generator.prefill(batch)
    token = logits.argmax(-1)
    offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
    profile_window("prefill", lambda: generator.prefill(batch))
    profile_window("decode_chunk", lambda: short_chunk(generator)._decode_chunk(
        cache, token, 0, offs, torch.Generator(device="cuda")))

    progress("phase 6")
    # 6. quantized serving: int8 KV + AWQ-calibrated w4a16 (B5), then int8 KV + w8a16
    t0 = time.perf_counter()
    with torch.no_grad():
        dev_batch = generator._to_device(batch)
        embeds = splice_embeddings(
            model, dev_batch["text_ids"].long(), dev_batch["token_type"],
            dev_batch["src_index"].long(), encode_images(model, dev_batch["images"]),
        )
    act_rms = decoder_act_rms(model.decoder, d, [embeds])
    torch.cuda.synchronize()
    del embeds
    print(f"calibration (decoder_act_rms, {BATCH}x{PROMPT_LEN} tokens) "
          f"{time.perf_counter() - t0:.2f} s")
    per_forward = 7 * d.num_layers + 1          # the block linears + lm_head
    quant_timing = {}
    for qname, wq in (("int4_awq", "int4"), ("w8a16", True)):
        q_cfg = GenerationConfig(max_new_tokens=NEW_TOKENS, kv_quant=True, weight_quant=wq,
                                 calibration=act_rms if wq == "int4" else None)
        t0 = time.perf_counter()
        q_gen = Generator(model, cfg, q_cfg, BATCH, PROMPT_LEN, device="cuda")
        torch.cuda.synchronize()
        print(f"quantize decoder ({qname}) {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        qm.launches = 0
        t0 = time.perf_counter()
        q_out = q_gen.generate(batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        q_launches = qm.launches
        q_peak = torch.cuda.max_memory_allocated()
        check(len(q_out) == BATCH and all(len(o) == NEW_TOKENS for o in q_out),
              f"{qname}: expected {BATCH}x{NEW_TOKENS} tokens, got {[len(o) for o in q_out]}")
        check(all(0 <= tok < d.vocab_size for o in q_out for tok in o), f"{qname}: token out of vocab")
        forwards = 1 + -(-NEW_TOKENS // q_cfg.decode_chunk) * q_cfg.decode_chunk
        if wq == "int4":
            w4_launches = q_launches
            check(q_launches == per_forward * forwards,
                  f"w4 kernel launched {q_launches} times in the int4 generate, expected "
                  f"{per_forward} x {forwards} forwards")
            qm.launches = 0
            logits_q, cache_q = q_gen.prefill(batch)
            check(qm.launches == per_forward, f"w4 launches per prefill {qm.launches} != {per_forward}")
            offs = torch.as_tensor(batch["pad_offsets"], device="cuda").long()
            qm.launches = 0
            q_gen._decode_chunk(cache_q, logits_q.argmax(-1), 0, offs, torch.Generator(device="cuda"))
            torch.cuda.synchronize()
            check(qm.launches == per_forward * q_cfg.decode_chunk,
                  f"w4 launches per decode chunk {qm.launches} != {per_forward} x {q_cfg.decode_chunk}")
            logits_p = q_gen.prefill(batch, use_kernel=False)[0]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(logits_q).all()), "int4 prefill logits not finite")
            diff = (logits_q - logits_p).abs().max().item()
            scale = logits_p.abs().max().item()
            agree = int((logits_q.argmax(-1) == logits_p.argmax(-1)).sum())
            print(f"int4 prefill logits kernels vs plain: max abs diff {diff:.4g}, max |logit| "
                  f"{scale:.4g}, argmax agree {agree}/{BATCH}")
            check(diff <= 0.05 * scale, f"int4 prefill logits differ by {diff} > 0.05 x {scale}")
            drift = ((logits_q - logits_k).square().mean().sqrt()
                     / logits_k.square().mean().sqrt()).item()
            agree_bf16 = int((logits_q.argmax(-1) == logits_k.argmax(-1)).sum())
            print(f"int4 vs bf16 prefill logits: relative RMS drift {drift:.4g}, argmax agree "
                  f"{agree_bf16}/{BATCH} (printed only: int4 is a quality trade-off)")
            prof = dict(
                prefill=profile_window("int4_prefill", lambda: q_gen.prefill(batch), match=("w4_",)),
                decode_chunk=profile_window("int4_decode_chunk", lambda: short_chunk(
                    q_gen)._decode_chunk(cache_q, logits_q.argmax(-1), 0, offs,
                                         torch.Generator(device="cuda")), match=("w4_",)))
            print("int4_profile " + json.dumps(prof))
            del logits_q, logits_p, cache_q
        print(f"{qname}: {BATCH}x{NEW_TOKENS} tokens, first run {first_s:.3f} s, "
              f"{q_launches} w4 launches, peak {q_peak / 2**30:.2f} GiB")
        print(f"{qname} sample tokens {q_out[0][:8]} ... {q_out[-1][:8]}")
        quant_timing[qname] = dict(decode_measure(q_gen, batch, NEW_TOKENS, warm=False),
                                   peak_gib=q_peak / 2**30)
        print(f"quant_path_{qname} " + json.dumps(quant_timing[qname]))
        del q_gen
        gc.collect()
        torch.cuda.empty_cache()

    progress("phase 7")
    # 7. training path: config #1's PT step with the three teachers
    del generator, model, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = init_vlm(cfg, device="cuda", seed=0)
    teachers = init_teachers(cfg, device="cuda", seed=7)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, total_steps=1000, stage="pretrain")
    step = make_train_step(cfg, opt_cfg, model, teacher_fn=make_teacher_fn(cfg),
                           teacher_params=teachers, remat=False)
    torch.cuda.synchronize()
    print(f"training init {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B student params "
          f"({sum(p.numel() for p in step.trainable.values()) / 1e6:.1f} M trainable), "
          f"{sum(p.numel() for p in teachers.parameters()) / 1e9:.3f} B teacher params")
    frozen = model.decoder.blocks[0].q_proj.weight
    frozen_before = frozen.detach().clone()
    n_swin = sum(teachers["swin"].cfg.depths)
    expected = dict(flash_fwd=d.num_layers, flash_bwd_dq=d.num_layers,
                    flash_bwd_dkv=d.num_layers, window_attn=n_swin * TRAIN_BATCH // 2)

    def reset_counts():
        fa.launches = fa.dq_launches = fa.dkv_launches = wa.launches = 0

    def counts():
        return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.dq_launches,
                    flash_bwd_dkv=fa.dkv_launches, window_attn=wa.launches)

    # tools/bench.py's timing: a warm-up step (update 1, lr 0), then
    # TRAIN_STEPS steps between two synchronizes; each step's launches and
    # loss read after it (host reads only)
    losses = []
    train_launches = {k: 0 for k in expected}

    def each(i, metrics):
        if i == 0:
            print("train step 1 (warm-up) " + json.dumps(metrics))
            torch.cuda.reset_peak_memory_stats()
        else:
            c = counts()
            check(c == expected, f"train step {i + 1}: launches {c}, expected {expected}")
            for kname in c:
                train_launches[kname] += c[kname]
            print(f"train step {i + 1}: launches {c} " + json.dumps(metrics))
        reset_counts()
        losses.append(metrics["loss"])

    dt, _ = time_steps(step, step.to_device(tbatch), TRAIN_STEPS, torch.device("cuda"), each=each)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(losses[i + 1] != losses[i] for i in range(1, len(losses) - 1)),
          f"loss did not change from step 2 on: {losses}")
    check(torch.equal(frozen, frozen_before), "a frozen decoder weight changed")
    train = dict(mean_step_ms=dt * 1e3, examples_per_s=TRAIN_BATCH / dt, peak_gib=peak / 2**30,
                 losses=losses, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    print("train_path " + json.dumps(train))

    # the kernel step vs the same step with plain attention, at B1
    b1 = step.to_device({k: v[:1] for k, v in tbatch.items()})
    names = list(step.trainable)

    def kernel_or_plain(use_kernel):
        loss_fn = make_loss_fn(cfg, teacher_fn=make_teacher_fn(cfg, use_kernel=use_kernel),
                               use_kernel=use_kernel, remat=False)
        return loss_and_grads(loss_fn, model, b1, teachers, [step.trainable[n] for n in names])

    loss_k, grads_k = kernel_or_plain(None)
    loss_p, grads_p = kernel_or_plain(False)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    min_cos, min_name, n_cmp = grad_agreement(names, grads_k, grads_p)
    del grads_k, grads_p
    print(f"train B1 kernel vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.3g}), "
          f"min grad cosine {min_cos:.6f} ({min_name}) over {n_cmp} tensors")
    check(rel <= 1e-3, f"B1 loss kernel vs plain differs by {rel:.3g} > 1e-3")
    check(min_cos >= 0.999, f"B1 grad cosine {min_cos} < 0.999 for {min_name}")

    # where the training step's time goes
    train_prof = profile_window("train_step", lambda: step(tbatch), top=15,
                                match=("flash_bwd", "window_attn_stream"))
    print("train_profile " + json.dumps(train_prof))
    check(train_prof["window_attn_stream"]["launches"] == expected["window_attn"],
          f"the profiled step ran {train_prof['window_attn_stream']['launches']} window "
          f"kernels, expected {expected['window_attn']}")
    progress("phase 8")
    # 8. trainer path: remat policies, trainer.train with accumulation,
    # checkpoint and resume, the chunked cross-entropy, master weights
    del step
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = trainer_phase(cfg, model, teachers, tbatch, reset_counts, counts)
    print(f"trainer phase {time.perf_counter() - t0:.1f} s")
    print("trainer_path " + json.dumps(trainer))

    progress("phase 8b")
    # 8b. the measurement tools on what phases 7-8 hold: the teacher pattern
    # on their teachers, speculative._bench, the input pipeline
    t0 = time.perf_counter()
    tools = tools_phase(teachers, wa, smi)
    tools["seconds"] = time.perf_counter() - t0
    print(f"tools phase {tools['seconds']:.1f} s [{smi}]")
    print("tools_path " + json.dumps(tools))

    progress("phase 9")
    # 9. the continuous-batching engine at bench_engine.py's defaults, the
    # batch loop beside it, prefix caching, chunked prefill, speculative and
    # beam decoding, an int4 engine run. The decoder is frozen in phases 7-8:
    # it is phase 4's
    del teachers
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cut, cut_cfg, cut_rms = cut_depth(model, cfg, act_rms, ENGINE_LAYERS)
    engine = engine_phase(cut_cfg, cut, cut_rms, fa, qm)
    del cut, cut_rms
    print(f"engine phase {time.perf_counter() - t0:.1f} s ({ENGINE_LAYERS} of "
          f"{cfg.decoder.num_layers} layers)")
    print("engine_path " + json.dumps(engine))

    progress("phase 10")
    # 10. the user API at Llama-3-8B + CLIP-L: export/import, chat, serve,
    # ChatSession, the file round trip, Vicuna-7B. Phases 4-9's models go first
    del model, act_rms
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    api, api_state = api_phase(fa, qm, da, param, gen)
    print(f"api phase {time.perf_counter() - t0:.1f} s")
    print("api_path " + json.dumps({k: v for k, v in api.items() if k not in ("b1", "b5")}))

    progress("phase 11")
    # 11. the vision side at Llama-3-8B: the ConvNeXt-XXL tower and a chat
    # through it, an anyres chat, an S2 call; a PT step of the convnext cell
    t0 = time.perf_counter()
    vision = vision_phase(api_state, fa, qm, wa, gen, smi)
    print(f"vision phase {time.perf_counter() - t0:.1f} s")
    print("vision_path " + json.dumps(
        {k: v for k, v in vision.items() if k not in ("b1_convnext", "b1_anyres")}))

    progress("phase 12")
    # 12. training from the recipes through the CLI: PT at Llama-3-8B, IFT at
    # Phi3-mini with --init-from, the LoRA and vision-tower stages
    del api_state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recipe = recipe_phase(fa, wa, smi)
    print(f"recipe phase {time.perf_counter() - t0:.1f} s")
    print("recipe_path " + json.dumps(recipe))

    progress("phase 13")
    # 13. visual interpretations at Llama-3-8B: the tap forward, DPT, OneFormer
    # over Swin-L, the unCLIP pipeline, the bundles, the demo, the hook, deltas
    release_cuda()
    t0 = time.perf_counter()
    viz = viz_phase(fa, wa, smi)
    viz["seconds"] = time.perf_counter() - t0
    print(f"viz phase {viz['seconds']:.1f} s [{smi}]")
    print("viz_path " + json.dumps(viz))

    progress("phase 14")
    # 14. evaluation at Llama-3-8B: CV-Bench / MMStar through chat, the harness
    # and the lmms adapter (generate_until, loglikelihood, rolling), B1 against
    # an f32 run, FID-Inception on the card, the validation CLI
    release_cuda()
    t0 = time.perf_counter()
    evals = eval_phase(fa, smi)
    evals["seconds"] = time.perf_counter() - t0
    print(f"eval phase {evals['seconds']:.1f} s, B1 launches {json.dumps(evals['b1_launches'])} [{smi}]")
    print("eval_path " + json.dumps(evals))
    progress("phase 15")
    # 15. the memory levers: the host link, offloaded and streamed steps held to
    # the on-card step at 4 layers, IFT at Llama-3-8B from recipes/finetune.args
    # with --offload-opt-state --stream-grads 8, without them (out of memory),
    # and train/aot.py's breakdown against what the run allocated
    t0 = time.perf_counter()
    memory = memory_phase(fa, wa, smi)
    memory["seconds"] = time.perf_counter() - t0
    print(f"memory phase {memory['seconds']:.1f} s [{smi}]")
    print("memory_path " + json.dumps({k: v for k, v in memory.items() if k not in ("b1", "b2", "b3")}))
    progress("phase 16")
    # 16. data parallelism and ZeRO: a one-rank NCCL group, two ranks sharing
    # the card (plain dp, zero_frozen, zero_params), IFT with ZeRO-2 moments
    release_cuda()
    t0 = time.perf_counter()
    dp_ref = {}
    dp = dp_phase(smi, dp_ref)
    dp["seconds"] = time.perf_counter() - t0
    print(f"dp phase {dp['seconds']:.1f} s [{smi}]")
    print("dp_path " + json.dumps(dp))
    progress("phase 17")
    # 17. tensor parallelism: the tp-sharded Generator at Phi3-mini, config
    # #1's PT step at tp 2 with and without sharded teachers, the
    # pretrain_full recipe at Llama-3-8B widths on four ranks
    t0 = time.perf_counter()
    tp = tp_phase(smi, dp_ref)
    tp["seconds"] = time.perf_counter() - t0
    del dp_ref
    print(f"tp phase {tp['seconds']:.1f} s [{smi}]")
    print("tp_path " + json.dumps(tp))
    progress("phase 18")
    # 18. sequence and pipeline parallelism: Ulysses and the ring at
    # Llama-3-8B's attention, the finetune step at sp 2 (Llama-3-8B widths,
    # T8192) and at pp 2 x tp 2 (Phi3-mini widths)
    release_cuda()
    t0 = time.perf_counter()
    sp_pp = sp_pp_phase(smi)
    sp_pp["seconds"] = time.perf_counter() - t0
    print(f"sp_pp phase {sp_pp['seconds']:.1f} s [{smi}]")
    print("sp_pp_path " + json.dumps(sp_pp))
    progress("phase 19")
    # 19. the MoE decoder: the Generator at full depth (and an int4 prefill,
    # and 8 layers held to f32), config #1's PT step with the MoE decoder, the
    # finetune step at ep 2
    t0 = time.perf_counter()
    moe = moe_phase(smi)
    moe["seconds"] = time.perf_counter() - t0
    print(f"moe phase {moe['seconds']:.1f} s [{smi}]")
    print("moe_path " + json.dumps(moe))
    dec_launches = da.launches                  # over phases 4-19
    print(f"decode_attn launches over the serving, training, engine, api, vision, recipe, viz, "
          f"eval, memory, parallel and MoE paths: {dec_launches}")
    check(dec_launches == 0, f"decode_attn launched {dec_launches} times; no path calls it")

    def entry(kname, source, replaces, rec, launches):
        return dict(
            name=kname, route="cuda", source=source, replaces=replaces, launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        )

    csrc = "visper_lm_tpu_torch/csrc/"
    w4_decode = w4_recs[f"gate_up_M{BATCH}"]
    dp_rank_launches = dp["b"]["plain"]["ranks"][0]["launches_per_step"]   # phase 16, a rank's step
    tp_rank_launches = tp["b"]["plain"]["ranks"][0]["launches_per_step"]   # phase 17 (b)
    tp_lora_launches = tp["g"]["ranks"][0]["launches_per_step"]            # phase 17 (g)
    tp_recipe_launches = tp["c"]["ranks"][0]["launches_per_step"]          # phase 17 (c)

    def phase18(kname):
        """A kernel's launches in phase 18: a rank's attention call (a), a
        rank's step at sp 2 (b) and at pp 2 x tp 2 (c), each with the memory
        levers too, and the LoRA step at (c)."""
        step = {f"{k}_step_a_rank": sp_pp[run]["ranks"][0]["launches_per_step"][kname]
                for k, run in (("sp", "b"), ("pp", "c"), ("sp_levers", "b_levers"),
                               ("pp_levers", "c_levers"), ("pp_lora", "c_lora"),
                               ("sp_moe", "b_moe"), ("pp_moe", "c_moe"))}
        return dict(attention_a_rank=sp_pp["a"]["ulysses"]["launches"][kname], **step)

    def phase19(kname):
        """A kernel's launches in phase 19: a MoE prefill (a), a PT step with
        the MoE decoder (b) and a rank's finetune step at ep 2 (c)."""
        return dict(prefill=moe["a"]["b1_launches_prefill"] if kname == "flash_fwd" else 0,
                    pt_step=moe["b"]["launches_per_step"][kname],
                    ep_step_a_rank=moe["c"]["ranks"][0]["launches_per_step"][kname],
                    ep_offload_step_a_rank=moe["c"]["offload"]["launches_per_step"][kname])

    main_launches = trainer["trainer"]["launches"]   # trainer.train, the main path
    kernels = [
        dict(entry("flash_fwd", csrc + "flash_fwd.cu", "visper_lm_tpu/ops/flash_attention.py:234",
                   slice_rec, main_launches["flash_fwd"]),
             launches_serving=launches, launches_phase7=train_launches["flash_fwd"],
             launches_engine=engine["engine"]["flash_launches"],
             shape=slice_rec["shape"], kernel=slice_rec["kernel"],
             mma_sync_ms=slice_rec["mma_sync_ms"],
             llama3=dict({k: api["b1"][k] for k in LLAMA3_KEYS},
                         launches=api["chat"]["bf16"]["b1_launches"],
                         library="SDPA, boolean mask, enable_gqa=True"),
             convnext_chat=dict({k: vision["b1_convnext"][k] for k in LLAMA3_KEYS},
                                launches=vision["convnext_chat"]["b1_launches"]),
             anyres_chat=dict({k: vision["b1_anyres"][k] for k in LLAMA3_KEYS},
                              launches=vision["anyres_chat"]["b1_launches"]),
             launches_convnext_pt_step=vision["convnext_pt_step"]["launches"]["flash_fwd"],
             launches_recipe_pt=recipe["pt"]["launches"]["flash_fwd"],
             launches_recipe_ift=recipe["ift"]["launches"]["flash_fwd"],
             recipe_pt={k: recipe_fwd[k] for k in LLAMA3_KEYS},
             launches_phase13=viz["tap_forward"]["b1_launches"],
             launches_phase14=dict(evals["b1_launches"], per_loglikelihood_request=(
                 evals["b1_launches"]["loglikelihood"] // evals["loglikelihood"]["requests"])),
             launches_phase15_per_step=memory["ift"]["launches_per_step"]["flash_fwd"],
             launches_phase16_rank_per_step=dp_rank_launches["flash_fwd"],
             launches_phase17=dict(prefill_a_rank=tp["a"]["ranks"][0]["prefill_launches"],
                                   pt_step_a_rank=tp_rank_launches["flash_fwd"],
                                   recipe_step_a_rank=tp_recipe_launches["flash_fwd"],
                                   int4_prefill_a_rank=tp["d"]["ranks"][0]["prefill_launches"],
                                   engine_run_a_rank=tp["e"]["ranks"][0]["b1_launches"],
                                   lora_step_a_rank=tp_lora_launches["flash_fwd"]),
             launches_phase18=phase18("flash_fwd"),
             launches_phase19=phase19("flash_fwd"),
             ift_t4096={k: memory["b1"][k] for k in LLAMA3_KEYS},
             train=dict(shape=train_fwd_rec["shape"], ms=train_fwd_rec["ms"],
                        mma_sync_ms=train_fwd_rec["mma_sync_ms"],
                        library_ms=train_fwd_rec["library_ms"],
                        bound_ms=train_fwd_rec["bound_ms"])),
        dict(entry("flash_bwd_dq", csrc + "flash_bwd.cu", "visper_lm_tpu/ops/flash_attention.py:497",
                   dq_rec, main_launches["flash_bwd_dq"]),
             launches_phase7=train_launches["flash_bwd_dq"], shape=dq_rec["shape"], kernel=dq_rec["kernel"], device_ms=dq_rec["device_ms"],
             launches_recipe_pt=recipe["pt"]["launches"]["flash_bwd_dq"],
             launches_recipe_ift=recipe["ift"]["launches"]["flash_bwd_dq"],
             recipe_pt={k: recipe_dq[k] for k in LLAMA3_KEYS + ("device_ms",)},
             launches_phase15_per_step=memory["ift"]["launches_per_step"]["flash_bwd_dq"],
             launches_phase16_rank_per_step=dp_rank_launches["flash_bwd_dq"],
             launches_phase17=dict(pt_step_a_rank=tp_rank_launches["flash_bwd_dq"],
                                   recipe_step_a_rank=tp_recipe_launches["flash_bwd_dq"],
                                   lora_step_a_rank=tp_lora_launches["flash_bwd_dq"]),
             launches_phase18=phase18("flash_bwd_dq"),
             launches_phase19=phase19("flash_bwd_dq"),
             ift_t4096={k: memory["b2"][k] for k in LLAMA3_KEYS + ("device_ms",)},
             library="SDPA backward (dq, dk and dv in one call)",
             gqa=dict(shape=gqa_dq["shape"], ms=gqa_dq["ms"], device_ms=gqa_dq["device_ms"],
                      library_ms=gqa_dq["library_ms"], bound_ms=gqa_dq["bound_ms"])),
        dict(entry("flash_bwd_dkv", csrc + "flash_bwd.cu", "visper_lm_tpu/ops/flash_attention.py:562",
                   dkv_rec, main_launches["flash_bwd_dkv"]),
             launches_phase7=train_launches["flash_bwd_dkv"], shape=dkv_rec["shape"], kernel=dkv_rec["kernel"], device_ms=dkv_rec["device_ms"],
             launches_recipe_pt=recipe["pt"]["launches"]["flash_bwd_dkv"],
             launches_recipe_ift=recipe["ift"]["launches"]["flash_bwd_dkv"],
             recipe_pt={k: recipe_dkv[k] for k in LLAMA3_KEYS + ("device_ms",)},
             launches_phase15_per_step=memory["ift"]["launches_per_step"]["flash_bwd_dkv"],
             launches_phase16_rank_per_step=dp_rank_launches["flash_bwd_dkv"],
             launches_phase17=dict(pt_step_a_rank=tp_rank_launches["flash_bwd_dkv"],
                                   recipe_step_a_rank=tp_recipe_launches["flash_bwd_dkv"],
                                   lora_step_a_rank=tp_lora_launches["flash_bwd_dkv"]),
             launches_phase18=phase18("flash_bwd_dkv"),
             launches_phase19=phase19("flash_bwd_dkv"),
             ift_t4096={k: memory["b3"][k] for k in LLAMA3_KEYS + ("device_ms",)},
             library="SDPA backward (dq, dk and dv in one call)",
             gqa=dict(shape=gqa_dkv["shape"], ms=gqa_dkv["ms"], device_ms=gqa_dkv["device_ms"],
                      library_ms=gqa_dkv["library_ms"], bound_ms=gqa_dkv["bound_ms"])),
        dict(entry("window_attn", csrc + "window_attn.cu", "visper_lm_tpu/ops/window_attention.py:112",
                   win_rec, main_launches["window_attn"]),
             launches_phase7=train_launches["window_attn"], shape=win_rec["shape"], kernel=win_rec["kernel"], timing=win_rec["timing"],
             launches_recipe_pt=recipe["pt"]["launches"]["window_attn"],
             launches_teacher_pattern=tools["teacher_pattern"]["b4_launches"],
             launches_phase13=viz["seg"]["b4_launches"],
             launches_phase16_rank_per_step=dp_rank_launches["window_attn"],
             launches_phase17=dict(pt_step_a_rank=tp_rank_launches["window_attn"],
                                   recipe_step_a_rank=tp_recipe_launches["window_attn"]),
             launches_phase18=phase18("window_attn"),
             launches_phase19=phase19("window_attn"),
             eager_ms=win_rec["eager_ms"],
             stages={r["case"]: dict(ms=r["ms"],
                                     library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                                     max_abs_err=r["max_abs_err"]) for r in win_recs},
             per_train_step=win_step, profile_ms_per_train_step=train_prof["window_attn_stream"]["ms"]),
        dict(entry("w4_matmul", csrc + "w4_matmul.cu", "visper_lm_tpu/ops/quant_matmul.py:125",
                   w4_rec, w4_launches),
             shape=w4_rec["shape"], launches_per_forward=per_forward,
             launches_phase19=dict(moe_int4_prefill=moe["a"]["int4"]["b5_launches_prefill"]),
             launches_phase17=dict(int4_forward_a_rank=tp["d"]["ranks"][0]["w4_per_forward"],
                                   int4_generate_a_rank=tp["d"]["ranks"][0]["w4_generate"]),
             tp2_slices={k: {f: r[f] for f in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms", "max_abs_err")}
                         for k, r in w4_tp2.items()},
             launches_engine=engine["int4_engine"]["w4_launches"],
             mma_sync_ms=w4_rec["mma_sync_ms"],
             llama3=dict({case: {k: rec[k] for k in LLAMA3_KEYS + ("cold_ms", "library_cold_ms")
                                 if k in rec}
                          for case, rec in api["b5"].items()},
                         launches=api["chat"]["int4"]["b5_launches"]),
             decode=dict(shape=w4_decode["shape"], ms=w4_decode["ms"],
                         device_ms=w4_decode["device_ms"], cold_ms=w4_decode["cold_ms"],
                         mma_sync_ms=w4_decode["mma_sync_ms"],
                         mma_sync_cold_ms=w4_decode["mma_sync_cold_ms"],
                         bound_ms=w4_decode["bound_ms"], library_ms=w4_decode["library_ms"],
                         library_cold_ms=w4_decode["library_cold_ms"])),
        dict(entry("decode_attn", csrc + "decode_attn.cu",
                   "visper_lm_tpu/ops/decode_attention.py:188", dec_rec, dec_launches),
             shape=dec_rec["shape"], timing="ms, library_ms: CUDA graphs over caches that exceed L2",
             device_ms=dec_rec["device_ms"], eager_ms=dec_rec["eager_ms"],
             serial_cold_ms=dec_rec["serial_cold_ms"],
             bf16=dict(shape=dec_bf16["shape"], ms=dec_bf16["ms"], device_ms=dec_bf16["device_ms"],
                       serial_cold_ms=dec_bf16["serial_cold_ms"], bound_ms=dec_bf16["bound_ms"],
                       library_ms=dec_bf16["library_ms"]),
             note="standalone op: no path calls it, as in the JAX package"),
    ]
    progress("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
