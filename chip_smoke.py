#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build      — compile paddle_tpu_torch/csrc/*.cu with nvcc (sm_90a, one
                process per source, in parallel), load it. The Hopper
                kernels' instantiations, each in bf16 and in f16, one line
                each for the attention forward (flash, flashmask and varlen
                at head dims 64, 128 and 192), the backward (dQ and dK/dV
                of flash, flashmask and varlen at 64, 128 and 192) and the
                grouped GEMM (weights read as they are and transposed): registers and
                spills from ptxas, wgmma (HGMMA) and TMA-load (UTMALDG)
                instructions from `cuobjdump -sass`; none may spill or
                lack either. The fused RoPE's twelve instantiations
                (`fused_rope ptxas`) and the norm dx's eighteen
                (`fused_norm_dx ptxas`) and the f32 attention tile kernels'
                nine at the 192 width (`flash_tiles 192 ptxas`): registers
                and spills; none may spill.
2. kernels    — each hand-written kernel against its plain PyTorch version
                on the card, at the shapes its path gives it and a few edge
                shapes, in float32 and bfloat16 (and the sm90 kernels' f16
                instantiations in float16: the flash path's shape and one
                edge at each tile width, flashmask's path and documents with
                a mask per head, varlen's pack and cross attention, the
                grouped GEMM's rung product, its dlhs, partial tiles and K
                off the TMA line): max error against a stated
                tolerance, device time (CUDA graph replays timed by CUDA
                events, warm L2; the paged decodes also on a cold L2,
                round-robin over copies of the case) and eager
                back-to-back time, the plain
                version's time, the least time the card could take (bound),
                and the time of one PyTorch library call computing the same
                function where there is one. Fused norm forward (the
                serving rows, the three training steps' f32 rows, rows at a
                mean of 1000, an odd width, a row past the register
                design's 8192 elements) and dx (also at the three training
                steps' f32 rows, with the dweight/dbias reductions beside
                them timed, rows at a mean of 1000, a view off the 16-byte
                line and a row past 8192 elements; each case's route),
                paged decode attention (full precision and int8 pages, with
                g = 4, a zero-length row, -1 table entries, a live chunk of
                -1 pages, a page whose scales are 0, a serving tick's
                one-page rows at gpt3_1p3b's and llama_7b's heads, one
                512-token row; each case called twice, bit for bit, the
                arrival counters left at zero), dense-cache decode
                attention split over the
                sequence (the MMHA shape, g = 4, a short odd cache with a
                zero-length row), flash attention forward, dq and dk/dv (the
                path's shape; S off the forward's 128-row tiles, D 64, 40,
                96 and 36 (the copy route), g = 4, a key bias, Sq > Skv
                and Skv > Sq, a fused qkv's strided views and unaligned
                views (the copy route)), then
                flash_attention_fwd(...).backward(dO) through autograd at
                the path's shape and at GQA 32/8 against the plain
                functions (dQ, and dK, dV of the kv heads), the
                flash forward at the dense engine's decode shape (Sq = 1),
                fused RoPE (forward and backward, neox and interleaved,
                q + k at 32/8 heads in bf16, f32 and f16, the decode and
                prefill shapes with a table per row, a ragged S, and the
                scalar route at D 36 and on a view at an odd 2-byte
                offset; each case's route, grid and share of its bound
                printed), flashmask forward, dq and dk/dv (the LLaMA
                step's trivial causal index at B 4 x 2048 with 32/8 heads,
                and document masks: causal n = 1 and n = 2, non-causal
                n = 2 and n = 4 (n = 2 and rows that keep no key in bf16
                and f32), a mask per head, GQA, S not a multiple of 64 or
                128, rows that keep no key; the backward kernels read the
                tile classes the forward derives), then the path's
                flashmask_attention_fwd(...).backward(dO) through autograd
                against the plain functions (dQ, and dK, dV of the kv
                heads), the grouped GEMM (the gpt3_moe
                rung's four products with the group sizes of a real
                routing, bf16 and f32; groups with no and all live rows,
                partly live tiles, strides 16 and 48, K and N off the tile,
                dlhs against transposed weights) and varlen forward, dq
                and dk/dv (a pack of 8192 tokens in 8 causal documents at
                32/8 heads of 128; non-causal at T = 1000 in f32, causal
                cross attention with q lengths != k lengths, an empty k
                segment in f32 and in bf16, a one-tile pack; the backward
                kernels read the tile classes the forward derives, and the
                keys whose document starts in the second 64 of a 128-key
                dK/dV tile are held on their own); and
                bert_base's shapes: the flash forward, dq and dk/dv in bf16
                at [32, 512, 12, 64], not causal, with BERT's f32 key bias
                (-1e4 on a few padded keys a row, row 0 none; the library
                call with it as SDPA's additive mask), and the norm forward
                and dx in f32 at [16384, 768]; and unet_sd's shapes: the
                flash forward, dq and dk/dv in bf16 at heads of 80
                ([8, 1024, 8, 80], self-attention and cross-attention over
                77 keys) and 160 ([8, 256, 8, 160], both; the 192-wide
                tiles), at 160 in f32, the 192 width's edges (causal with
                the offset off the tiles and GQA, a padded key bias, D 192
                with Sq > Skv, f32 GQA), SDPA's time beside the four unet
                rows; the norm forward and dx in f32 at its [8192, 640]
                and [2048, 1280]; a flashmask and a varlen case at D 160;
                a head of 193 raising.
2b. faults    — the kernels built again from copies of csrc/, each with
                one planted fault (a kv or q tile skipped, long rows
                normalised 1% off; the flash backward's q steps without
                the bottom-right offset, and its dK/dV adding the key bias
                on partial tiles only; flashmask: a partial tile of the
                forward treated as full, the end bound of n = 2
                ignored, partly kept tiles of the f32 kernels skipped,
                every head reading mask head 0, and in the bf16 backward
                a q tile's last kv tile skipped in dQ, a partial tile
                treated as full and a kv head's group of query heads one
                short in dK/dV; varlen: each q tile's first kv tile skipped
                (f32), the segment test's upper bound dropped, in the sm90
                kernels a partial tile read as full and the forward's and
                dQ's loop one kv tile short, the tile classes' last kv tile
                full past Tk, and in the sm90 dK/dV a CTA's q steps ending
                at its first 64 keys' range and each key tile's first q
                step one step late; norm forward:
                the cross-warp sum without the group's last warp, the
                scalar tail skipped; norm dx: the paired exchange without
                the group's last warp, the prefetched row's dy taken from
                the current row, the scalar tail skipped; grouped GEMM: a
                partly
                live 64-row unit treated as dead, a tile's second unit
                taking the first one's liveness; dense decode: the combine
                without a chunk's rescale, a chunk's tokens counted to
                S_max instead of the length; paged decode: the combine
                without a chunk's rescale, a live chunk of -1 pages exiting
                without arriving, the last chunk leaving its arrival
                counter set, int8 probabilities taking the chunk's first
                page's v_scale; RoPE: the neox second half read one vector
                late, the table row taken as 0 with a table per row, the
                head chunk's start off by one where it crosses from q into
                k; at the 192 width: P V without the third 64-column panel,
                the forward's and dQ's second 64-key half of each kv tile
                skipped, the dK half of the split dK/dV computing dV
                alone; in the f16 instantiations: S = Q K^T and the
                register-A products on the bf16 wgmma, P packed to bf16,
                the grouped GEMM's transposed B on the bf16 wgmma): at its
                case every one must
                fail the limits of phase 2. Only the source a fault
                touches is compiled again, and only for what its case
                launches: an attention source at the case's dtype and
                head-dim tile width, the grouped GEMM at its dtype
                (csrc/common.cuh PTT_ONLY_DTYPE / PTT_ONLY_WIDTH); a fault
                in a header that the flash, flashmask, varlen and
                grouped-GEMM sources share reaches only the source its case
                runs (the others keep their objects).
3. serve      — gpt3_1p3b at full width and depth in bf16, random weights
                from a seed, through inference.create_serving_engine (paged,
                16 rows, 512 tokens, page size 32) over 12 requests of the
                serving benchmark's mix. Launch counters are zeroed just
                before and read just after: every LayerNorm and every decode
                attention must have gone through its kernel. Then
                torch.profiler over five decode ticks of a full batch:
                device-busy share and top kernels.
4. hold       — gpt3_1p3b width at 2 layers in f32 (TF32 off): the same
                greedy requests through the engine on the card (kernels) and
                on the CPU (plain versions); first-decode-tick logits within
                tolerance and identical tokens; model.generate on the card
                gives the card engine's tokens.
4b. serve-quant — bench.py's serving_quant A/B on gpt3_1p3b bf16: 64
                requests of the mix, 32 new tokens, B 16, S 512, page size
                32, an equal KV budget of (B*S)/(2*ps) bf16 pages. Leg A bf16
                pages, leg B kv_quant + serve_w8; each leg launches only its
                own paged decode kernel, ticks x 24 times, and the norm
                kernel (requests + ticks) x 49 times; leg B holds >= 1.9x
                the pages and no less peak concurrency. A profile of leg B's
                decode tick.
4c. dense     — the 12-request mix through create_serving_engine(paged=
                False): flash forward at Sq = 1 ticks x 24, norm (requests
                + ticks) x 49; model.generate on one greedy prompt, fed the
                engine's tokens, ranks each first or within a bf16 tie
                (BF16_TIE_ULPS) at every step; a profile of the dense
                decode tick.
4d. mmha      — 32 steps of incubate masked_multihead_attention at B 16,
                16 heads of 128, S_max 2048: the dense-cache kernel pair
                (split and combine, one launch of the wrapper) exactly 32
                times, every step within tolerance of the plain version.
4e. quant hold — phase 4 with kv_quant and serve_w8: tokens identical,
                logits within tolerance, int8 payloads within 1.
5. train      — gpt3_1p3b at full width and depth, batch 4 x 2048 tokens,
                the bench's 1.3B recipe: amp.decorate O2 (bf16 parameters,
                LayerNorm in f32), AdamW(lr 1e-4, bf16 moments), per-layer
                recompute, an O2 bf16 step through
                distributed.DistributedTrainStep. One warm-up step (every
                parameter must change; gradients must reach the token
                embedding and layer 0's input LayerNorm), then three timed
                steps with the launch counters zeroed just before and read
                just after: per step 48 flash forwards (24 + 24 in
                recompute), 24 dq, 24 dk/dv, 97 norm forwards (49 + 48 in
                recompute) and 49 norm dx. Step time, tokens/s, MFU, peak
                memory, and torch.profiler over one step.
6. train hold — gpt3_1p3b width at 2 layers, batch 2 x 256, f32 (TF32
                off), recompute on: three AdamW steps on the card (kernels)
                and on the CPU (plain versions) from the same weights; the
                losses and the step-1 gradients within tolerance.
6b. train sharded — phase 5's step through distributed.DistributedTrainStep
                on a 1-rank NCCL group (init_parallel_env, rendezvous at
                127.0.0.1 on a free port; build_mesh(sharding=1)), sharding
                stage 3 with offload: parameters gathered by each block for
                the forward and again for the backward, gradients
                reduce-scattered into the shards, the AdamW states in
                pinned host memory between steps. The same weights and
                tokens as phase 5; each loss within TRAIN_SHARDED_RTOL of
                phase 5's, phase 5's launches per step, all-gathers and
                reduce-scatters counted in every step, every state pinned
                on the host after every step, and the peak device memory
                below phase 5's by at least OFFLOAD_PEAK_SHARE of the
                host-held bytes. Step time, tokens/s, MFU, the collective
                counts and torch.profiler over one step; the process group
                is destroyed at the end.
6c. train tensor-parallel — phase 5's step with sequence_parallel through
                the mp code of DistributedTrainStep on a 1-rank NCCL group
                (build_mesh(mp=1)) at sharding stage 1: the model cut over
                the one-rank mp group, its column- and row-parallel layers,
                vocab-parallel embedding and parallel cross entropy
                calling their collectives, the activations between blocks
                the sequence shard. Phase 5's weights, carried into the cut
                model by convert.load_paddle_tpu_state, and tokens; each
                loss within TRAIN_SHARDED_RTOL of phase 5's, phase 5's
                launches per step, and each step's all-gathers,
                reduce-scatters and all-reduces exactly the ones
                tp_collectives predicts from the code. Step time,
                tokens/s, MFU, peak memory, the collective counts and
                torch.profiler over one step.
6d. train pipeline — phase 5's step as a 1F1B GPTForCausalLMPipe
                (num_microbatches 4: microbatches of 1 x 2048) through
                DistributedTrainStep on a 1-rank NCCL group
                (build_mesh(pp=1)): the schedule of
                parallel.pipeline_1f1b with one stage (no sends), each
                microbatch's forward without a graph and its backward
                running the stage again from the kept input, the final
                norm, head and loss on the stage's output, the shared
                parameters' gradients summed over the one-rank pp group
                and the loss broadcast over it. Phase 5's weights, carried
                in by models.stack_layered_state_dict and
                convert.load_paddle_tpu_state, and tokens; each loss
                within TRAIN_SHARDED_RTOL of phase 5's, per step phase 5's
                flash and norm launches times 4 (192 flash forwards, 96 dq,
                96 dk/dv, 388 norm forwards, 196 norm dx), and each step's
                pp collectives (parallel.pipeline.PP_CALLS) exactly the
                ones the code places: no send or receive, one broadcast,
                one all-reduce a bucket of shared gradients. Step time,
                tokens/s, MFU, peak memory, the most microbatches held in
                flight, the collective counts and torch.profiler over one
                step.
6e. train context-parallel — phase 5's step with context_parallel through
                the sep code of DistributedTrainStep on a 1-rank NCCL group
                (build_mesh(sep=1)): the inputs and labels cut over the one
                sep rank, the positions global, every attention through
                the ring of parallel.ring (its block update is plain
                torch in f32, as the reference's is jnp; the ring makes no
                hop at sep 1). Phase 5's weights and tokens; each loss
                within TRAIN_SHARDED_RTOL of phase 5's, per step phase 5's
                norm launches and no flash launch. Step time, tokens/s,
                MFU, peak memory, the ring's hops and torch.profiler over
                one step. Then ring_attention alone at [4, 2048, 16, 128]
                bf16, causal, forward and backward through autograd,
                against the dense attention in f32 on the same inputs
                (RING_TOL of each tensor's largest entry), its time beside
                the same attention through the flash kernels.
7. llama serve — llama_7b at full width and depth in bf16, random weights
                from a seed, through the paged engine (16 rows, 512 tokens,
                page size 32) over the 12-request mix: RoPE (prefills +
                ticks) x 32, paged decode ticks x 32, RMSNorm (prefills +
                ticks) x 65, no flash or flashmask launch; model.generate on
                one greedy prompt against the engine (the first decode
                step's logits within BF16_DECODE_LOGIT_RTOL, the tokens
                printed); a profile of five full-batch decode ticks; then
                llama_7b in f32 at full depth, where generate must give a
                one-row paged engine's tokens.
8. llama hold — llama_7b width at 2 layers in f32 (TF32 off): phase 4.
9. llama train — bench.py's llama_7bshape rung (hidden 4096, 3 layers, 32
                query heads over 8 kv heads, ffn 11008, flashmask attention
                with the trivial index) at batch 4 x 2048: f32 parameters
                and AdamW moments, AMP O2 bf16, sharding stage 2 on one
                device. As phase 5, with per step 3 flashmask forwards, 3
                dq, 3 dk/dv, 6 RoPE launches (3 forward, 3 backward), 7
                RMSNorm forwards and 7 dx, and no flash launch.
10. llama train hold — phase 6 at the llama_7bshape widths (2 layers,
                flashmask attention, two AdamW steps).
11. moe train — bench.py's gpt3_moe rung (run_moe_rung: 8 experts, GShard
                top-2 with random routing, width 1024, expert hidden 4096,
                4 attention-free layers, vocabulary 32000) at batch 8 x
                1024: f32 parameters and AdamW moments, AMP O2 bf16. As
                phase 5, with per step 16 grouped GEMMs (two a block
                forward, two dlhs), 4 LayerNorm forwards and 4 dx, and no
                attention launch; gradients must reach the embedding,
                every gate and every expert's w1 and w2.
11b. moe train expert-parallel — phase 11's rung with ep_axis="ep" and
                batch_axes ("dp", "ep") through DistributedTrainStep on a
                1-rank NCCL group (build_mesh(ep=1)): each MoE layer routed
                over the one token rank, its experts cut over the one ep
                rank, the buffer exchanged in 2 row chunks by all-to-all
                (dispatch and combine, and their backward) around the
                grouped GEMMs. Phase 11's weights, routing seeds and
                tokens; the losses against phase 11's (equal bit for bit,
                or each within TRAIN_SHARDED_RTOL), per step 32 grouped
                GEMMs (two a chunk forward, two dlhs, 2 chunks, 4 layers),
                4 norm forwards and 4 dx, and each step's all-to-alls
                exactly 4 x 2 chunks x 4 layers. Step time, tokens/s, peak
                memory, the all-to-all calls and bytes of a step and
                torch.profiler over one step.
12. moe train hold — phase 6 at the rung's widths (2 layers, random
                routing off on both sides).
13. varlen    — nn.functional.flash_attn_unpadded forward and backward at
                phase 2's main varlen case: one launch of each varlen
                kernel, output and q/k/v gradients within phase 2's limits
                of the plain path on the card; then the same tokens through
                flash_attn_varlen_qkvpacked(varlen_padded=False); then
                flash_attn_unpadded once in fp16 on phase 2's fp16 pack.
                Each entry's forward and forward + backward are timed
                eagerly.

14. bert train — bench.py's bert_base rung (run_bert_rung) at full
                size: bert_base, batch 32 x 512, 80 masked positions,
                dropouts 0, AdamW lr 1e-4, AMP O2 bf16 (f32 parameters)
                through DistributedTrainStep. As phase 5, with per step 12
                flash forwards, 12 dq and 12 dk/dv (all with the key bias)
                and 26 norm forwards and 26 dx, and nothing else;
                gradients must reach the word embedding and layer 0's
                norm1. Then one step on a padded attention mask: the same
                launches and a finite loss.
15. bert train hold — phase 6 at bert_base's widths (2 layers, batch
                2 x 128, a padded mask).
16. resnet train — bench.py's resnet50 rung (run_resnet_rung): resnet50,
                batch 128 x 3 x 224 x 224, Momentum lr 0.1 / 0.9, AMP O2
                bf16 through DistributedTrainStep: no hand-written kernel
                launches (cuDNN convs, plain batch norms), every conv
                weight changes and every batch norm's running statistics
                move, batch norms stay f32. Step time, images/s, MFU at
                3 x 4.1e9 FLOPs an image, peak memory, a profile.
17. resnet train hold — resnet18, batch 4 x 3 x 64 x 64, three Momentum
                steps on the card in f32 (TF32 off) against the CPU in
                float64 (RESNET_RUNG's note): losses, step-1 gradients and
                the running statistics within tolerance.
18. unet train — bench.py's unet_sd rung (run_unet_rung) at full size:
                the UNet at base 320, channels x (1, 2, 4), 2 res blocks a
                level, 8 heads (D 80 and 160), context 768, batch 8 of a
                64 x 64 x 4 latent, a context of 77, AdamW lr 1e-4 with
                bf16 moments, AMP O2 bf16 through DistributedTrainStep
                (parameters f32, as bench.py leaves them). Per step 22
                flash forwards, 22 dq, 22 dk/dv and 11 norm forwards and
                11 dx, nothing else; every conv weight changes; finite
                losses; the 46 group norms return f32. Step time,
                latents/s, peak memory, a profile, and the group norms'
                device time and share; then a GroupNorm that amp.decorate
                cast: bf16 parameters, an f32 output.
19. unet train hold — phase 18's widths at 1 res block a level, batch 2
                of a 16 x 16 latent, a context of 8, two AdamW steps in
                f32 (TF32 off) on the card (the f32 flash kernels at the
                128 and 192 widths) against the CPU (oneDNN off): losses
                and step-1 gradients within the train hold's tolerances.
20. random    — the port's draws on the card (framework.random's CUDA
                generator): dropout at p 0.1 and 0.5 on 2^26 f32 and bf16
                elements (the keep rate within 5 sigma, the kept values
                exactly x / (1 - p), the same mask from the same seed and
                another from the next draw, the draw's time), the mask
                shapes of dropout2d and `axis`, alpha_dropout's mean 0 and
                variance 1 within 5 sigma; then one gpt3_1p3b block in
                bf16 with hidden and attention dropout 0.1, batch 2 x 1024,
                whose gradients under per-layer recompute must equal bit
                for bit those without it from the same generator state.
21. bert dropout train — bert_base at its own config (hidden and
                attention dropout 0.1), batch 32 x 512, 80 masked
                positions a row of which a seeded ~15% of the row's
                tokens keep a label (the rest -100), AdamW on
                LinearWarmup(PolynomialDecay) with bf16 moments and the
                decay filter that leaves biases and norms alone, AMP O2
                bf16 through DistributedTrainStep: five steps with the
                scheduler stepped after each (the rate each step used
                printed and held to the scheduler's), the launch counters
                zeroed just before and read just after (26 norm forwards
                and 26 dx a step; attention with dropout is the composite,
                no flash launch), finite losses, the step time, peak
                memory and busy share of a profiled step. Then one eval
                forward: 12 flash forwards through the key-bias route and
                26 norm forwards.
22. optimizers hold — each of the ten optimizers of optimizer.py, and
                AdamW with the decay filter on a scheduler, three f32 steps
                (TF32 off) on a small MLP on the card and on the CPU from
                the same weights, each tensor's gap within OPT_HOLD_RTOL
                of its norm (the largest entry's gap printed beside it);
                Lamb and Lars at
                sharding stage 2 with offload (slices of 4096 elements) on
                a 1-rank NCCL group against the same step without
                offload; LBFGS (strong Wolfe) five closure steps of 4
                iterations on a quadratic of condition 100 on both,
                reaching the CPU's iterate (which must lie within 20%
                of the solution's norm from it, starting at 100%).
23. train fp16 — gpt3_1p3b at full width and depth, batch 4 x 2048, under
                amp.decorate(level="O2", dtype="float16") with AdamW's f32
                master weights and per-layer recompute, in the reference's
                eager fp16 loop (auto_cast O2 fp16, amp.GradScaler,
                scale(loss).backward(), step, update): phase 5's launches a
                step, the scale printed at each step, step time against
                phase 5's, tokens/s, MFU, peak, a profile; a step forced to
                overflow (scale 2^40) skips with the parameters and masters
                bit for bit and halves the scale, and the next steps train.
                Then 3 steps of the gpt3_moe rung in fp16 with a
                GradScaler: 16 fp16 grouped GEMMs a step.
24. serve fp16 — llama_7b at full width and depth in fp16 through the
                paged engine (fp16 pages; RoPE, RMSNorm and the paged
                decode in fp16) and gpt3_1p3b in fp16 through the dense
                engine (the flash forward at Sq = 1 in fp16), the 12-request
                mix; generate fed each engine's tokens: the first equal,
                the others within FP16_TIE_ULPS of its top logit.
25. half holds — 2 layers at gpt3_1p3b's and llama_7bshape's widths,
                batch 1 x 256: one training step on the card in bf16
                and in fp16 (under a GradScaler) on the tensor-core flash
                and flashmask kernels, AdamW on f32 master weights (decorate
                O2), each held to the CPU's f32 step from the same weights
                (exact in both types): the loss, every gradient and every
                update, at limits in units of the type's roundoff
                (HALF_HOLD_*).
26. serve block attention — llama_7b at full width and depth in bf16
                through BlockAttentionDecoder (the model's weights through
                the incubate functionals: fused_rms_norm, fused_linear,
                block_multihead_attention over pages of 64 with rope_emb,
                fused_bias_act swiglu): the serving mix's 12 prompts in one
                padded prefill call a layer, then 16 decode ticks; exactly
                16 x 32 paged decodes and 17 x 65 norm forwards; the first
                tokens equal the paged engine's, the later ones within
                BLHA_TIE_ULPS of generate's top logit fed them; the same
                decoder in f32 gives generate's tokens, every one; one
                tick with int8 pages and one with a prefix cache (the
                composite) against the CPU.
27. train fused encoder — 12 post-LN FusedTransformerEncoderLayers at
                bert_base's widths, batch 32 x 512, AMP O2 bf16, AdamW: 48
                launches of each flash kernel over a warm-up and 3 steps,
                nothing else; a 2-layer f32 step against the CPU.
28. incubate calls — fused_moe (and weight-only int8) at the gpt3_moe
                rung's widths, variable_length_memory_efficient_attention,
                fused_gate_attention, the softmax-mask fusions and PTQ /
                QAT on gpt3_tiny, each against its CPU run in f32;
                fused_dot_product_attention in bf16 (one flash forward);
                FusedMultiTransformer at gpt3_1p3b's widths, 2 layers,
                bf16, its cached decode against its uncached forward.
29. paddle idiom — bench.py's gpt3_1p3b recipe written as a Paddle
                script against the port (`import paddle_tpu_torch as
                paddle`, `paddle.seed(0)`, `paddle.to_tensor` batches on
                the card): the compiled DistributedTrainStep for a warm-up
                and 3 timed steps beside phase 5's time, then the eager
                loop (`crit(model(ids), labels)`, `backward()`,
                `opt.step()`, `opt.clear_grad()`) for 2 steps, one under
                `amp.debugging.collect_operator_stats()` (the kernels under
                the reference's op names, one report a launch), each with
                phase 5's exact launches; 2 layers in f32 on the card
                against the CPU from one state (3 AdamW steps); save/load
                bit for bit; the tensor checker on a planted inf weight.
30. observed train and resume — the train cell's recipe (phase 5's
                gpt3_1p3b, 24 layers, 4 x 2048, O2 bf16, bf16 moments,
                recompute) under the port's telemetry: (a) bench.py's
                --emit-metrics, a StepTimeline writing
                chiprun_out/phase30/steps.jsonl around a warm-up and 3
                timed steps (each record's dur_s, host syncs, spans,
                overlap fraction; phase 5's launches a step); (b)
                paddle_tpu_torch.profiler with the GPU target over two
                steps (make_scheduler(closed=0, ready=1, record=1)): its
                device trace (Kineto's, chiprun_out/phase30/device/, kept
                gzipped) holds the spans and the kernels, and the device
                Kernel Summary's calls of the hand-written kernels equal
                the launch counters over the recorded step; (c) a
                CheckpointManager(async_save=True) save of the whole
                training state (7.9 GB), two steps while it writes, a
                fresh model and step restored with restore_latest (every
                parameter and moment bit for bit) and its next two steps
                against the uninterrupted run's losses (bit for bit or
                within 1e-4 relative); the free disk space first, the
                bytes, the snapshot stall and the write, crc and load
                seconds; (d) the paged gpt3_1p3b engine over phase 3's mix
                with a timeline record a tick and the registry exported to
                chiprun_out/phase30/serve.jsonl a tick: the registry's
                window holds serving_tokens_total{engine="paged"} = the
                tokens made and the TTFT count = the requests, and phase
                3's paged decode launches; (e) the comm watchdog's host
                library built on the card's host with g++, enabled across
                (a)-(d): 0 timeouts and nothing in flight at the end.
31. resilient train under the launcher — phase 5's step (gpt3_1p3b's
                full width, O2 bf16, bf16 moments, recompute, phase 5's
                weights and tokens) under a ResilientTrainer (save_every 2,
                keep_last_n 2, synchronous saves, an ElasticManager over
                the native store) in a worker of this script
                (`--phase31-worker`) started by `python -m
                paddle_tpu_torch.distributed.launch --max_restart=2`; the
                worker takes its rendezvous from the launcher
                (init_parallel_env: NCCL, world size 1;
                create_or_get_global_tcp_store at the master port + 1).
                Two launches side by side: (a) 16 layers (P31_LAYERS: at
                24 the run neared its limit), 6 steps: the first life
                commits step 1 and is killed while committing step 3
                (`ckpt.before_commit:kill@2`); the launcher respawns it,
                the second life resumes from step 1 and trains steps 2-5.
                (b) 2 layers, a 30 s step deadline: the first life hangs
                90 s in step 2 (`trainer.before_step:sleep:90@3`); the
                watchdog's FatalError line reaches the launcher's
                LogWatcher, the pod is torn down (its watchdog report
                folded into the worker log) and respawned, and the second
                life resumes from step 1. Each: every step's loss against
                the same 6 steps run uninterrupted in this process (bit for
                bit or within 1e-4 relative), every step phase 5's
                launches at its depth, the heartbeat's age under twice its
                interval, no torn `.tmp` left, the newest checkpoint step
                5; printed: the free disk space first (three copies of both
                states must fit), each life's start step, the restore and
                save seconds, the seconds from the first life's death to
                the second life's first step, the step time beside phase
                5's. The checkpoints are deleted at the end.

A phase's peak device memory is its own: `reset_peak` collects what the
earlier phases left in reference cycles before the window opens.

The second-to-last line is a JSON object listing the kernels; the last line
is {"ok": true, "device": {...}}. Every number printed sits beside the
card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
# f32 CUDA cores; bf16 and f16 dense tensor cores (one rate for both)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# Kernel vs plain version, max |err| of outputs of magnitude <= ~4:
# f32 differs only in the order of the row/softmax sums (a few ulps);
# bf16 computes in f32 on identical inputs and rounds once, so the two may
# land on neighbouring bf16 values: two ulps at |y| < 4 (norm, 2^-6 each)
# and at |o| < 2 (decode, 2^-7 each).
NORM_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
DECODE_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# Engine on the card vs on the CPU, f32 with TF32 off: logits of magnitude
# ~1 summed in other orders over K <= 8192 differ by a few 1e-6; 1e-3
# leaves room for that while catching a wrong mask, page or layer.
HOLD_LOGIT_TOL = 1e-3
# llama_7b in bf16: `generate` (f32 dense caches, decode through the flash
# kernel at Sq = 1, which rounds P to bf16 before P V) against the paged
# engine (bf16 pages, the paged decode kernel, P in f32 as in the JAX
# kernel) at the first decode step of one prompt: the same function
# rounded differently. bf16 rounds each op to 2^-9 relative; over 32 layers
# of ~8 rounded ops the hidden state drifts by ~sqrt(256) x 2^-9 ~ 3% in
# the worst case, so the row's logits are held to 10% of their norm, which
# a wrong layer, cache or page, or non-finite values, exceed. With random
# weights the logits barely depend on attention (on llama_tiny in bf16 the
# two paths differ by 0.6% and a decode query rotated at the wrong
# position by 0.9-1.2%), so RoPE positions are held where that shows: the
# CPU tests (f32, against the JAX package, to 1e-5) and the f32 holds.
# Greedy tokens are compared and printed, not held: with 32000 logits of
# spread ~1.3 rounded to bf16 (2^-5 at |x| ~ 4), the top two of a step are
# within that rounding often enough that the two paths may pick different
# tokens. The tokens are held in f32: at full depth in the serve phase and
# in the holds.
BF16_DECODE_LOGIT_RTOL = 0.1
# gpt3_1p3b in bf16: `generate` (batch 1, the prompt unpadded, f32 caches)
# against the dense engine (the prompt padded to a bucket, decode batched
# over the live rows): the same kernels per row, but cuBLAS products of
# other shapes, which round differently. generate's model is fed the
# engine's tokens (teacher forcing, through generate's own calls) and at
# every step the engine's token must be generate's greedy pick or lie
# within BF16_TIE_ULPS bf16 steps of its top logit (a tie in bf16). A
# wrong kernel moves logits by far more than a step.
BF16_TIE_ULPS = 2
# The same hold in fp16 (phase 24): fp16's steps are 8 times finer than
# bf16's, and at llama_7b's depth the two paths (the paged decode with P
# in f32 against the flash forward at Sq = 1 with P in fp16, batch 16
# against batch 1 GEMMs) drift by about sqrt(32 layers x 8 rounded ops) x
# 2^-12 ~ 0.4% of the logit vector's norm, ~0.005 a logit at top logits
# of ~4, where a step is 2^-8: a token the engine picks may lie up to
# ~2.6 steps below generate's top. The limit is 8 fp16 steps, half the
# bf16 hold's reach in absolute terms (2 bf16 steps = 16 fp16 steps); a
# wrong kernel moves logits by far more. The first token comes from the
# same prefill computation on both sides and must be equal.
FP16_TIE_ULPS = 8
# The same with int8 KV pages and int8 weights: the weights quantize
# identically on both sides (elementwise, IEEE division), but K/V rows
# that differ by rounding can land on either side of a quantizer's rounding
# boundary, moving one payload by 1 (one scale step, <= 1/127 of its page's
# abs-max); a few such moves shift a logit by far less than 1e-2.
QUANT_HOLD_LOGIT_TOL = 1e-2
# Norm dx kernel vs plain, max |err| of outputs of magnitude <= ~4: the
# same f32 arithmetic, row sums in another order; bf16 rounds once, two
# ulps as for the forward.
NORM_DX_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# Flash attention kernels vs plain, every element held to its own row:
# |got - plain| <= FLASH_TOL * max |plain| over the row (a query row of O
# and dQ, a key row of dK and dV), a row whose largest |plain| is below a
# thousandth of the tensor's largest (a row of zeros, or a gradient that
# cancels to rounding noise, like dQ of a row that sees one key) being held
# to that thousandth instead. At the path shape the rows span two orders of
# magnitude (row 0 of O is v_0, a row past a thousand keys averages as
# many values to |O| ~ 0.03), so one limit set by the largest entry would
# pass a kernel that lost a kv tile. f32 differs only in the order of the
# sums over D and over the keys. bf16 rounds P and dS to bf16 on both
# sides, but the kernel rounds exp(s - running max) and the plain version
# exp(s - row max), and O and dQ round once more: one bf16 ulp (up to 2^-7
# relative) of a row's largest value; dK/dV come out in f32. The limit is
# two ulps. Beside it, the whole tensor: ||got - plain||_F / ||plain||_F
# <= FLASH_FROB_TOL. LSE is f32 on both sides, its sums in another order.
# Measured on an H100 80GB HBM3 over the cases below: row-relative 2^-7
# (O), 0.005 (dQ), 0.0042 (dK/dV); Frobenius at most 2.0e-3 (O) and
# 1.1e-4 (gradients), where a forward kernel that normalises its long rows
# 1% off gives 7.5e-3 (phase 2b); LSE 9.5e-7. f16 runs the same kernels
# with the same roundings on a grid 8 times finer (an ulp is 2^-10
# relative): the same two ulps, 2^-9, and the Frobenius limit scaled as
# bf16's is to its ulp (half an ulp, 2^-11).
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6, "float16": 2 ** -9}
FLASH_FROB_TOL = {"float32": 1e-5, "bfloat16": 4e-3, "float16": 2 ** -11}
FLASH_LSE_TOL = 1e-5
# Training step on the card vs on the CPU, f32 with TF32 off, 2 layers at
# the 1.3B width: the losses (~10.8) agree to a few 1e-6 relative; each
# gradient's max |diff| is held to 1e-3 of its largest entry (or of a
# thousandth of the largest gradient anywhere, for tensors whose gradient
# is analytically zero, like the k-projection biases).
TRAIN_HOLD_LOSS_RTOL = 1e-4
# the sharded step (stage 3, offload, world size 1) against phase 5's step:
# the same bf16 arithmetic, its losses within a bf16 step's reach
TRAIN_SHARDED_RTOL = 2e-3
# The ring's bf16 outputs and gradients against the dense attention in f32
# on the same bf16 inputs: both compute in f32, and the ring rounds each
# output once to bf16 (2^-8 relative, at most 2^-7 of the tensor's largest
# entry for entries below it).
RING_TOL = 2 ** -7
# the offloaded states must come off the card's peak, nearly all of them
OFFLOAD_PEAK_SHARE = 0.9
TRAIN_HOLD_GRAD_TOL = 1e-3
# RoPE kernel vs plain: both compute x_a c - x_b s and x_b c + x_a s in f32
# with one rounding per product and sum (the kernel uses no fused
# multiply-add) and round once to the tensor's dtype, so they should agree
# bit for bit; the limit allows one ulp at |x| < 8 (f32 5e-7, bf16 2^-5,
# f16 2^-8).
ROPE_TOL = {"float32": 1e-6, "bfloat16": 2 ** -5, "float16": 2 ** -8}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def say(card, msg):
    print(f"[{card}] {msg}", flush=True)


def _graph_ms(calls, reps):
    """Device time of one call: `calls` captured into a CUDA graph in
    order, the graph replayed `reps` times between CUDA events; the median
    replay over the number of calls. The graph takes the host (Python,
    ctypes, launch latency) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return float(np.median(times))


def reset_peak(torch):
    """Start a peak-memory window: first collect what earlier phases left
    in reference cycles (a DistributedTrainStep and its model refer to each
    other), so that the peak is this phase's own."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def time_ms(fn, reps=15, inner=20):
    """Device time of one call on a warm L2: `inner` calls of `fn` in a
    CUDA graph (`_graph_ms`)."""
    return _graph_ms([fn] * inner, reps)


# bytes read between two reads of one copy of a case's inputs in
# `time_ms_cold`: twice the H100's 50 MB L2
COLD_GAP_BYTES = 100e6


def time_ms_cold(fn, args, nbytes, reps=15, max_copies=256):
    """Device time of one call `fn(*args)` on a cold L2, as a serving tick
    finds a layer's pages (the weights stream through the L2 between two
    layers): the calls in a CUDA graph (`_graph_ms`) round-robin over n
    copies of `args` (tensors, tuples of tensors or None), n such that the
    other copies' calls move more than COLD_GAP_BYTES (`nbytes` a call)
    before a copy is read again. None if that needs more than `max_copies`
    copies."""
    n = int(COLD_GAP_BYTES // nbytes) + 2
    if n > max_copies:
        return None

    def clone(a):
        return a if a is None else (tuple(map(clone, a)) if isinstance(a, tuple)
                                    else a.clone())

    copies = [args] + [clone(args) for _ in range(n - 1)]
    calls = [lambda c=c: fn(*c) for c in copies]
    return _graph_ms(calls * max(1, -(-20 // n)), reps)


def eager_ms(fn, reps=15, inner=20):
    """Time of one call launched eagerly back to back (CUDA events): what
    the engine's eager loop pays, host overhead included when the host is
    slower than the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def ptxas_summary(log):
    """One line for nvcc's `-Xptxas -v` report: kernels compiled, the most
    registers any uses, and each kernel that spills (its name and mangled
    template arguments) with its spill-store bytes."""
    regs, spills, name = [], {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1] if "'" in ln else ln
            m = re.search(r"\d([a-z_]+_kernel)(I\w*?E)?", mangled)
            name = "".join(m.groups("")) if m else mangled[-60:]
        elif "Used" in ln and "registers" in ln:
            regs.append(int(ln.split("Used")[1].split("registers")[0]))
        elif "bytes spill stores" in ln:
            stored = int(ln.split("bytes spill stores")[0].split(",")[-1])
            if stored:
                spills[name or "?"] = stored
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": spills}


def ptxas_kernels(log, prefix, name_of=None):
    """Registers and spill-store bytes of each instantiation (its mangled
    template arguments kept) of the kernel named `prefix`, from nvcc's
    `-Xptxas -v` report (`log`, empty if this process did not build).
    `name_of`, if given, names an instantiation from its "Compiling entry
    function" line instead (None: not one of these kernels)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = None if name_of else re.search(rf"\d({prefix})(I\w*?E)?", ln)
            name = name_of(ln) if name_of else ("".join(m.groups("")) if m else None)
            if name:
                out[name] = {}
        elif name and "bytes spill stores" in ln:
            out[name]["spill_store_bytes"] = int(
                ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split("registers")[0])
    return out


SM90_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16"}
SM90_KERNEL = re.compile(
    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_sm90_kernel)I(13__nv_bfloat16|6__half)Li(\d+)E"
    r".*?(CausalBias|FlashMask|Varlen)")
SM90_GG_KERNEL = re.compile(r"(gg_sm90_kernel)I(13__nv_bfloat16|6__half)Lb([01])E")
# the Hopper kernels' instantiations chip_smoke.py expects, each in bf16 and
# f16: the forward (csrc/flash_fwd_sm90.cuh) and the dQ and dK/dV
# (csrc/flash_bwd_sm90.cuh) of flash, flashmask and varlen, at head dims 64,
# 128 and 192, and the grouped GEMM (csrc/grouped_gemm_sm90.cuh) against
# [E, K, N] weights (false) and transposed [E, N, K] ones (true)
SM90_EXPECTED = {
    "forward": [f"flash_fwd_sm90_kernel<{t}, {d}, {m}>" for t in ("bf16", "f16")
                for m in ("CausalBias", "FlashMask", "Varlen") for d in (64, 128, 192)],
    "backward": [f"{k}<{t}, {d}, {m}>" for t in ("bf16", "f16")
                 for m in ("CausalBias", "FlashMask", "Varlen")
                 for k in ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
                 for d in (64, 128, 192)],
    "grouped_gemm": [f"gg_sm90_kernel<{t}, {b}>" for t in ("bf16", "f16")
                     for b in ("false", "true")],
}


def sm90_report(card, lib_path, log):
    """The Hopper kernels' instantiations as built (SM90_EXPECTED): registers
    and spill-store bytes from nvcc's `-Xptxas -v` (`log`, empty if this
    process did not build), and the wgmma (HGMMA) and TMA-load (UTMALDG)
    instructions that `cuobjdump -sass` finds in each in the library. One
    line each for the attention forward, the attention backward and the
    grouped GEMM. Raises if an instantiation is missing, spills, or has no
    wgmma or no TMA load: it would not run on Hopper's tensor cores fed by
    TMA."""
    import shutil

    def name_of(ln):
        m = SM90_KERNEL.search(ln)
        if m:
            return f"{m[1]}<{SM90_TYPES[m[2]]}, {m[3]}, {m[4]}>"
        m = SM90_GG_KERNEL.search(ln)
        return (f"{m[1]}<{SM90_TYPES[m[2]]}, {'true' if m[3] == '1' else 'false'}>"
                if m else None)

    report, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = name_of(ln)
            if name:
                report[name] = {}
        elif name and "bytes spill stores" in ln:
            report[name]["spill_store_bytes"] = int(
                ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            report[name]["registers"] = int(
                ln.split("Used")[1].split("registers")[0])
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    name = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = name_of(ln)
            if name:
                report.setdefault(name, {}).update(HGMMA=0, UTMALDG=0)
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                report[name][op] += op in ln
    bad = []
    for part, names in SM90_EXPECTED.items():
        say(card, f"sm90 {part} " + json.dumps({n: report.get(n) for n in names}))
        for n in names:
            r = report.get(n) or {}
            if not (r.get("HGMMA") and r.get("UTMALDG")) or r.get("spill_store_bytes"):
                bad.append(n)
    if bad:
        raise AssertionError(f"sm90 instantiations missing, spilling, or "
                             f"without wgmma or TMA loads: {bad}")
    return report


TILE_KERNEL = re.compile(
    r"(flash_(?:fwd|dq|dkv)_kernel)IfLi(\d+)E.*?(CausalBias|FlashMask|Varlen)")


def tiles_ptxas(card, log):
    """The f32 CUDA-core attention kernels' instantiations at the 192 width
    (csrc/flash_tiles.cuh: forward, dQ and dK/dV under the three policies):
    registers and spill-store bytes from nvcc's `-Xptxas -v`. Raises if one
    is missing or spills (empty `log`: this process did not build)."""
    def name_of(ln):
        m = TILE_KERNEL.search(ln)
        return f"{m[1]}<float, {m[2]}, {m[3]}>" if m and m[2] == "192" else None

    got = ptxas_kernels(log, "", name_of)
    say(card, "flash_tiles 192 ptxas " + json.dumps(got))
    want = [f"{k}<float, 192, {m}>" for m in ("CausalBias", "FlashMask", "Varlen")
            for k in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")]
    bad = [n for n in want if log and (n not in got or got[n].get("spill_store_bytes"))]
    if bad:
        raise AssertionError(f"f32 tile instantiations at 192 missing or spilling: {bad}")


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


# (R, N, kind, dtypes, offset): rows of x = offset + N(0, 1). Decode rows
# and prefill rows at the 1.3B width, the training steps' rows under O2
# (f32, batch 4 x 2048: gpt3_1p3b's LayerNorm at 2048, llama_7bshape's
# RMSNorm at 4096, gpt3_moe's LayerNorm at 1024, and gpt3_1p3b's rows at
# a mean of 1000, which the two-pass centred variance exists for), the
# 13B width, an odd width (a scalar tail and rows off the 16-byte line),
# the RMSNorm form of the serving row, and a row wider than the register
# design's 8192 elements (the one-block-a-row kernel).
BOTH = ("float32", "bfloat16")
NORM_CASES = [(16, 2048, "ln", BOTH, 0.0), (512, 2048, "ln", BOTH, 0.0),
              (8192, 2048, "ln", BOTH, 0.0), (16, 5120, "ln", BOTH, 0.0),
              (37, 1031, "ln", BOTH, 0.0), (16, 2048, "rms", BOTH, 0.0),
              (8192, 4096, "rms", ("float32",), 0.0),
              (8192, 1024, "ln", ("float32",), 0.0),
              (8192, 2048, "ln", ("float32",), 1000.0),
              (64, 16384, "ln", BOTH, 0.0), (16384, 768, "ln", ("float32",), 0.0),
              # unet_sd's norm2 at level 1 and level 2 / the mid block
              (8192, 640, "ln", ("float32",), 0.0),
              (2048, 1280, "ln", ("float32",), 0.0)]


def _norm_inputs(torch, gen, R, N, kind, dtype, offset=0.0):
    """(x, weight, bias or None) of a NORM_CASES case on the card."""
    dt = getattr(torch, dtype)
    x = torch.randn(R, N, device="cuda", generator=gen)
    x = (x + offset if offset else x).to(dt)
    w = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    return x, w, (b if kind == "ln" else None)


def _norm_f64(torch, x, w, bias, kind, eps):
    """(out, rstd, mean or None) of the norm in float64 with the two-pass
    centred variance: a reference that shares no f32 sum with the kernel
    or with its plain version."""
    xd = x.double()
    mean = xd.mean(-1, keepdim=True) if kind == "ln" else None
    c = xd - mean if kind == "ln" else xd
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    out = c * rstd * w.double()
    if bias is not None:
        out = out + bias.double()
    return out, rstd[:, 0], None if mean is None else mean[:, 0]


def _one_pass_f32(torch, x, w, bias, kind, eps):
    """The norm with the one-pass variance E[x^2] - E[x]^2 in f32: the form
    the two-pass centred variance exists to avoid, a control for rows at
    an offset."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True) if kind == "ln" else None
    m = mean if kind == "ln" else 0.0
    var = ((xf * xf).mean(-1, keepdim=True) - m * m).clamp_min(0)
    rstd = torch.rsqrt(var + eps)
    out = (xf - m) * rstd * w.float()
    if bias is not None:
        out = out + bias.float()
    return out, rstd[:, 0], None if mean is None else mean[:, 0]


def _f64_errors(got, ref):
    """(max |out err|, rstd err relative to its largest value, max |mean
    err| or 0) of a norm result against `_norm_f64`'s."""
    out, rstd, mean = got
    out_r, rstd_r, mean_r = ref
    err = (out.double() - out_r).abs().max().item()
    rstd_err = ((rstd.double() - rstd_r).abs().max()
                / rstd_r.abs().max()).item()
    mean_err = 0.0 if mean is None else (mean.double() - mean_r).abs().max().item()
    return err, rstd_err, mean_err


def _norm_errors(fn, torch, x, w, bias, kind, dtype, offset=0.0):
    """(max |out err|, stats err, violations, what else the row reports) of
    the forward kernel. Centred rows against its plain version: the output
    to NORM_TOL, rstd to 1e-5 of its largest value, the mean to 1e-5. Rows
    at an offset (a mean of 1000) against float64 (`_norm_f64`): the
    output to NORM_TOL, rstd to 1e-5 of its largest value and the mean to
    one f32 ulp of its largest value, the closest an f32 mean can come;
    the plain version (an f32 sum) and a one-pass variance
    (`_one_pass_f32`) are read beside it as controls, and the one-pass
    control must fail those limits, or the case would not tell the two
    variances apart."""
    got = fn.norm_fwd(x, w, bias, kind, 1e-5)
    out, rstd, mean = got
    if not offset:
        ref, rstd_ref, mean_ref = fn.norm_fwd_plain(x, w, bias, kind, 1e-5)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err_stats = (rstd - rstd_ref).abs().max().item() / rstd_ref.abs().max().item()
        if kind == "ln":
            err_stats = max(err_stats, (mean - mean_ref).abs().max().item())
        bad = []
        if not (err <= NORM_TOL[dtype] and err_stats <= 1e-5):
            bad.append(f"fused_norm {kind} {dtype} [{x.shape[0]},{x.shape[1]}]: "
                       f"max|out err| {err} (tol {NORM_TOL[dtype]}), stats err "
                       f"{err_stats} (tol 1e-5)")
        return err, err_stats, bad, {}
    ref = _norm_f64(torch, x, w, bias, kind, 1e-5)
    top = ref[2].abs().max().item() if kind == "ln" else 0.0
    mean_tol = max(1e-5, 2.0 ** (math.floor(math.log2(top)) - 23) if top else 0.0)

    def held(result):
        err, rstd_err, mean_err = _f64_errors(result, ref)
        return {"max_abs_err": err, "rstd_err": rstd_err, "mean_err": mean_err,
                "ok": err <= NORM_TOL[dtype] and rstd_err <= 1e-5
                and mean_err <= mean_tol}

    kernel = held(got)
    controls = {"plain_f32": held(fn.norm_fwd_plain(x, w, bias, kind, 1e-5)),
                "one_pass_f32": held(_one_pass_f32(torch, x, w, bias, kind,
                                                   1e-5))}
    name = f"fused_norm {kind} {dtype} [{x.shape[0]},{x.shape[1]}] at {offset}"
    bad = []
    if not kernel["ok"]:
        bad.append(f"{name}: against float64 {kernel} (tol out "
                   f"{NORM_TOL[dtype]}, rstd 1e-5, mean {mean_tol})")
    if controls["one_pass_f32"]["ok"]:
        bad.append(f"{name}: the one-pass variance passes too")
    return (kernel["max_abs_err"], max(kernel["rstd_err"], kernel["mean_err"]),
            bad, {"held_to": "float64", "rstd_err": kernel["rstd_err"],
                  "mean_err": kernel["mean_err"], "mean_tol": mean_tol,
                  "controls": controls})


def check_norm(card, torch):
    """The forward kernel against its plain version over NORM_CASES. Bound:
    bytes, x read and the output written once, the weight, bias and stats.
    Library: F.layer_norm (LayerNorm), F.rms_norm where this PyTorch has
    it (RMSNorm)."""
    from paddle_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    main, training, failures = None, [], []
    F = torch.nn.functional
    for dtype in BOTH:
        for R, N, kind, dtypes, offset in NORM_CASES:
            if dtype not in dtypes:
                continue
            x, w, bias = _norm_inputs(torch, gen, R, N, kind, dtype, offset)
            err, err_stats, bad, extra = _norm_errors(
                fn, torch, x, w, bias, kind, dtype, offset)
            failures += bad
            worst = max(worst, err)
            es = x.element_size()
            nbytes = 2 * R * N * es + (2 if bias is not None else 1) * N * es \
                + R * 4 * (2 if kind == "ln" else 1)
            bnd, by = bound_ms(nbytes, 8 * R * N, "float32")
            k_ms = time_ms(lambda: fn.norm_fwd(x, w, bias, kind, 1e-5))
            k_eager = eager_ms(lambda: fn.norm_fwd(x, w, bias, kind, 1e-5))
            p_ms = time_ms(lambda: fn.norm_fwd_plain(x, w, bias, kind, 1e-5))
            lib_ms = None
            if kind == "ln":
                lib_ms = time_ms(lambda: F.layer_norm(x, (N,), w, bias, 1e-5))
            elif hasattr(F, "rms_norm"):
                lib_ms = time_ms(lambda: F.rms_norm(x, (N,), w, 1e-5))
            row = dict(kind=kind, dtype=dtype, R=R, N=N, offset=offset,
                       max_abs_err=err, stats_err=err_stats,
                       tol=NORM_TOL[dtype], ms=k_ms, eager_ms=k_eager,
                       plain_ms=p_ms, bound_ms=bnd, bound_by=by,
                       library_ms=lib_ms, **extra)
            say(card, "fused_norm " + json.dumps(row))
            if (R, N, kind, dtype) == (16, 2048, "ln", "bfloat16"):
                main = row
            if R == 8192 and dtype == "float32":
                training.append({k: row[k] for k in (
                    "kind", "N", "offset", "ms", "bound_ms", "library_ms")})
    say(card, "fused_norm training rows (f32 [8192, N], the steps' shapes) "
              + json.dumps(training))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst, "main": main}


# name: (B, H, Hkv, D, ps, P, lengths, holes, zero-scale page). The
# serving path: 16 rows, 16 heads of 128, page size 32, 512 tokens, ragged
# lengths with a zero-length row, a parked row (length 1, table all -1, by
# the holes) and -1 holes in the middle of rows' tables; GQA g = 4; D 64
# at page size 13; a page whose int8 scales are 0 (zero_scale_page_d64,
# the int8 route only); hole_chunk: a 300-token row whose pages 4-7 are all
# -1 (a whole bf16 chunk of holes) beside a parked row; tick_g1 and
# llama_tick_g1: a serving tick's rows (16-23 tokens, one page a row, and
# a zero-length row) at gpt3_1p3b's and llama_7b's heads; b1_512: one
# 512-token row; llama_path_g1: the path's rows at llama_7b's 32 heads,
# with a chunk of -1 pages in the 512-token row (the kernel's CTAs then
# take several chunks each).
DECODE_PATH_LENGTHS = [512, 1, 0, 33, 100, 255, 256, 257, 300, 31, 32, 64,
                       480, 129, 17, 200]
TICK_LENGTHS = [16, 17, 18, 19, 20, 21, 22, 23, 16, 17, 18, 19, 20, 21, 22, 0]
BLHA_TICK_LENGTHS = [138, 13, 14, 141, 16, 17, 144, 19, 20, 147, 22, 23]
PAGED_CASES = {
    "path_g1": (16, 16, 16, 128, 32, 16, DECODE_PATH_LENGTHS,
                [(1, 0), (3, 0), (8, 4)], None),
    "gqa_g4": (16, 16, 4, 128, 32, 16, DECODE_PATH_LENGTHS, [(12, 7)], None),
    "gqa_g2_d64_ps13": (5, 8, 4, 64, 13, 10, [130, 1, 0, 77, 14], [(3, 2)],
                        None),
    "zero_scale_page_d64": (5, 8, 4, 64, 16, 10, [130, 1, 0, 77, 14], [(3, 2)],
                            (0, 3)),
    "hole_chunk": (4, 16, 16, 128, 32, 16, [300, 1, 0, 77],
                   [(0, 4), (0, 5), (0, 6), (0, 7), (1, 0)], None),
    "tick_g1": (16, 16, 16, 128, 32, 16, TICK_LENGTHS, [], None),
    "llama_tick_g1": (16, 32, 32, 128, 32, 16, TICK_LENGTHS, [], None),
    "b1_512": (1, 16, 16, 128, 32, 16, [512], [], None),
    "llama_path_g1": (16, 32, 32, 128, 32, 16, DECODE_PATH_LENGTHS,
                      [(1, 0), (3, 0), (8, 4), (0, 4), (0, 5)], None),
    # block_multihead_attention's decode tick at llama_7b (phase 26): the
    # 12 prompts of the serving mix 8 ticks in, pages of 64
    "blha_llama_ps64": (12, 32, 32, 128, 64, 4, BLHA_TICK_LENGTHS, [], None),
}
PAGED_FULL = ["path_g1", "gqa_g4", "gqa_g2_d64_ps13", "hole_chunk", "tick_g1",
              "llama_tick_g1", "b1_512", "llama_path_g1", "blha_llama_ps64"]
PAGED_Q8 = ["path_g1", "gqa_g4", "zero_scale_page_d64", "hole_chunk",
            "tick_g1", "llama_tick_g1", "b1_512", "llama_path_g1"]


def _paged_inputs(torch, name, dtype, q8):
    """A PAGED_CASES case on the card, from a seed of its own: q, caches
    (int8: payloads in [-127, 127] and scales that put |K|, |V| up to ~3,
    the zero-scale page's set to 0), `scales` ((k_scale, v_scale) or
    None), block tables over the pages in a random order with the holes
    punched to -1, lengths; then the bytes the call must move (every valid
    token's K and V row, the int8 scales of each (page, head) read, q, out,
    tables, lengths) and the valid tokens."""
    B, H, Hkv, D, ps, P, lengths, holes, zero = PAGED_CASES[name]
    seed = 100 * list(PAGED_CASES).index(name) + 10 * (dtype == "bfloat16") + q8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * P + 1
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(getattr(torch, dtype))
    scales = None
    if q8:
        kc, vc = (torch.randint(-127, 128, (n_pages, Hkv, ps, D), device="cuda",
                                generator=gen, dtype=torch.int8) for _ in range(2))
        scales = tuple(0.005 + 0.02 * torch.rand(n_pages, Hkv, device="cuda",
                                                 generator=gen) for _ in range(2))
    else:
        kc, vc = (torch.randn(n_pages, Hkv, ps, D, device="cuda",
                              generator=gen).to(q.dtype) for _ in range(2))
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    tables = np.full((B, P), -1, np.int32)
    nxt = 0
    for b, L in enumerate(lengths):
        for j in range(min(P, -(-L // ps))):
            tables[b, j] = perm[nxt]
            nxt += 1
    for b, j in holes:
        tables[b, j] = -1
    if q8 and zero is not None:
        for sc in scales:
            sc[int(tables[zero])] = 0.0
    read = [(b, j) for b, L in enumerate(lengths) for j in range(P)
            if tables[b, j] >= 0 and j * ps < L]
    valid = sum(min(ps, lengths[b] - j * ps) for b, j in read)
    nbytes = (2 * valid * Hkv * D * kc.element_size()
              + (2 * 4 * len(read) * Hkv if q8 else 0)
              + 2 * q.numel() * q.element_size() + tables.size * 4 + B * 4)
    return ((q, kc, vc, torch.tensor(tables, device="cuda"),
             torch.tensor(lengths, dtype=torch.int32, device="cuda"), scales),
            nbytes, valid)


def _paged_call(da, q, kc, vc, tables, lens, scales):
    return da.paged_decode_attention(q, kc, vc, tables, lens, kv_scales=scales)


def _paged_plain(da, q, kc, vc, tables, lens, scales):
    if scales is None:
        return da.paged_decode_attention_plain(q, kc, vc, tables, lens,
                                               q.shape[-1] ** -0.5)
    return da.paged_decode_attention_q8_plain(q, kc, vc, tables, lens,
                                              q.shape[-1] ** -0.5, *scales)


def _paged_violations(torch, da, args, dtype):
    """What breaks the limits of a paged case `args`: two back-to-back
    calls, then the plain version. A non-finite value, a row without a
    readable token (length 0, or every page -1) not exactly zero, max |err|
    over DECODE_TOL, the second call not bit for bit the first (the
    arrival counters not reset), counters left non-zero."""
    out, again = _paged_call(da, *args), _paged_call(da, *args)
    ref = _paged_plain(da, *args)
    torch.cuda.synchronize()
    tables = args[3]
    err = (out.float() - ref.float()).abs().max().item()
    bad = []
    if not torch.isfinite(out.float()).all():
        bad.append("non-finite output")
    zero_rows = [b for b in range(tables.shape[0]) if (tables[b] < 0).all()]
    if any(out[b].abs().max().item() != 0 for b in zero_rows):
        bad.append("a row without valid tokens is not zero")
    if not err <= DECODE_TOL[dtype]:
        bad.append(f"max|err| {err} (tol {DECODE_TOL[dtype]})")
    if not torch.equal(out.view(torch.uint8), again.view(torch.uint8)):
        bad.append("a second call is not bit for bit the first")
    if any(bool(c.any()) for c in da._ARRIVALS.values()):
        bad.append("arrival counters left non-zero")
    return bad, err


def _check_paged(card, torch, q8):
    """The paged decode kernel (q8: int8 pages, `kv_scales=`) against its
    plain version over its PAGED_CASES, q in bf16 (the path) and f32: the
    limits of `_paged_violations`, then times warm (graph replays) and on a
    cold L2 (`time_ms_cold`), eager, plain, and the bound. A time under
    the bound is printed as a finding: the L2 held the pages."""
    from paddle_tpu_torch.ops import decode_attention as da

    kind = "paged_decode_q8" if q8 else "paged_decode"
    worst, main = 0.0, None
    for dtype in ("bfloat16", "float32"):
        for name in PAGED_Q8 if q8 else PAGED_FULL:
            B, H, Hkv, D, ps, P = PAGED_CASES[name][:6]
            args, nbytes, valid = _paged_inputs(torch, name, dtype, q8)
            bad, err = _paged_violations(torch, da, args, dtype)
            if bad:
                raise AssertionError(f"{kind} {name} {dtype}: " + "; ".join(bad))
            worst = max(worst, err)
            bnd, by = bound_ms(nbytes, 4 * valid * H * D, dtype)
            row = dict(case=name, dtype=dtype, B=B, H=H, Hkv=Hkv, D=D, ps=ps,
                       pages_a_chunk=min(P, da.paged_chunk_pages(
                           ps, D, args[1].element_size())),
                       valid_tokens=valid, max_abs_err=err,
                       tol=DECODE_TOL[dtype],
                       ms=time_ms(lambda: _paged_call(da, *args)),
                       cold_ms=time_ms_cold(lambda *a: _paged_call(da, *a), args,
                                            nbytes),
                       eager_ms=eager_ms(lambda: _paged_call(da, *args)),
                       plain_ms=time_ms(lambda: _paged_plain(da, *args),
                                        reps=5, inner=3),
                       bound_ms=bnd, bound_by=by, library_ms=None)
            say(card, f"{kind} " + json.dumps(row))
            for t in ("ms", "cold_ms"):
                if row[t] is not None and row[t] < bnd:
                    say(card, f"{kind} finding: {name} {dtype} {t} {row[t]} "
                              f"under its bound {bnd} ms: the L2 held pages")
            if (name, dtype) == ("path_g1", "bfloat16"):
                main = row
            del args
    torch.cuda.empty_cache()
    say(card, f"{kind} library_ms: none; no single PyTorch call attends "
              + ("over int8 pages " if q8 else "") + "through a block table "
              "over a paged cache")
    return {"worst": worst, "main": main}


def check_decode(card, torch):
    """The full-precision paged decode kernel: `_check_paged`."""
    return _check_paged(card, torch, q8=False)


def check_decode_q8(card, torch):
    """The int8 paged decode kernel: `_check_paged`."""
    return _check_paged(card, torch, q8=True)


# name: (B, H, Hkv, D, S_max, lengths)
DENSE_CASES = {
    "mmha_g1": (16, 16, 16, 128, 2048, [int(x) for x in np.linspace(1, 2048, 16)]),
    "gqa_g4": (16, 16, 4, 128, 2048, [int(x) for x in np.linspace(1, 2048, 16)]),
    "odd_s_max_d64": (4, 8, 8, 64, 301, [0, 1, 300, 301]),
}


def _dense_inputs(torch, gen, name, dtype):
    """(q, kc, vc, lengths) of a DENSE_CASES case on the card."""
    B, H, Hkv, D, S, lengths = DENSE_CASES[name]
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(dt)
    kc = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).to(dt)
    vc = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).to(dt)
    return q, kc, vc, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _dense_violations(torch, name, dtype, out, ref):
    """What breaks the limits: max |err| over DECODE_TOL, a non-finite value,
    a zero-length row not exactly zero."""
    err = (out.float() - ref.float()).abs().max().item()
    zero_rows = [b for b, L in enumerate(DENSE_CASES[name][5]) if L == 0]
    bad = []
    if not torch.isfinite(out.float()).all():
        bad.append("non-finite output")
    if any(out[b].abs().max().item() != 0 for b in zero_rows):
        bad.append("a zero-length row is not zero")
    if not err <= DECODE_TOL[dtype]:
        bad.append(f"max|err| {err} (tol {DECODE_TOL[dtype]})")
    return bad, err


def check_dense_decode(card, torch):
    """The dense-cache decode kernels against their plain version at the
    MMHA shape (B 16, 16 heads of 128, S_max 2048, lengths from 1 to 2048),
    at GQA g = 4 and at a short odd cache with a zero-length row; bf16 (the
    path) and f32. The library yardstick is F.scaled_dot_product_attention
    over the same keys with a bool key mask, at g = 1."""
    from paddle_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, main = 0.0, None
    for dtype in ("bfloat16", "float32"):
        for name, (B, H, Hkv, D, S, lengths) in DENSE_CASES.items():
            q, kc, vc, lens = _dense_inputs(torch, gen, name, dtype)
            out = da.dense_decode_attention(q, kc, vc, lens)
            ref = da.dense_decode_attention_plain(q, kc, vc, lens, D ** -0.5)
            torch.cuda.synchronize()
            bad, err = _dense_violations(torch, name, dtype, out, ref)
            if bad:
                raise AssertionError(f"dense_decode {name} {dtype}: "
                                     + "; ".join(bad))
            worst = max(worst, err)
            valid = sum(min(L, S) for L in lengths)
            es = q.element_size()
            nbytes = 2 * valid * Hkv * D * es + 2 * q.numel() * es + B * 4
            bnd, by = bound_ms(nbytes, 4 * valid * H * D, dtype)
            lib = None
            if Hkv == H:
                keep = (torch.arange(S, device="cuda")[None, :]
                        < lens[:, None])[:, None, None, :]
                q4 = q[:, :, None, :]
                lib = time_ms(lambda: sdpa(q4, kc, vc, attn_mask=keep))
            call = lambda: da.dense_decode_attention(q, kc, vc, lens)  # noqa: E731
            row = dict(case=name, dtype=dtype, B=B, H=H, Hkv=Hkv, D=D, S_max=S,
                       chunk=da.dense_chunk(D, es, S),
                       valid_tokens=valid, max_abs_err=err,
                       tol=DECODE_TOL[dtype], ms=time_ms(call),
                       eager_ms=eager_ms(call),
                       plain_ms=time_ms(lambda: da.dense_decode_attention_plain(
                           q, kc, vc, lens, D ** -0.5), reps=5, inner=3),
                       bound_ms=bnd, bound_by=by, library_ms=lib)
            say(card, "dense_decode " + json.dumps(row))
            if (name, dtype) == ("mmha_g1", "bfloat16"):
                main = row
            del q, kc, vc, out, ref
    say(card, "dense_decode library_ms: F.scaled_dot_product_attention on "
              "[B, H, 1, D] against the cache with a bool key mask (g = 1)")
    return {"worst": worst, "main": main}


def check_flash_decode(card, torch):
    """The flash forward kernel at the dense engine's decode shape: B 16,
    Sq 1, Skv 512, 16 heads of 128, bf16, a key bias that keeps each row's
    first lengths[b] + 1 keys (a parked row keeps key 0 only), held with
    check_flash's limits. Library: F.scaled_dot_product_attention with the
    same keys as a bool mask."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    B, Skv, H, D = 16, 512, 16, 128
    lengths = [0] + [int(x) for x in np.linspace(10, 510, B - 1)]
    q = torch.randn(B, 1, H, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, Skv, H, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, Skv, H, D, device="cuda", generator=gen).bfloat16()
    keep = (torch.arange(Skv, device="cuda")[None, :]
            <= torch.tensor(lengths, device="cuda")[:, None])
    kb = torch.where(keep, 0.0, -1e30).float()
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, False, scale, kb)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, False, scale, kb)
    torch.cuda.synchronize()
    errs = _flash_errs({"out": out, "lse": lse}, {"out": out_p, "lse": lse_p})
    bad = _flash_violations(errs, "bfloat16")
    valid = int(keep.sum())
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * valid * H * D * es + B * H * 4 + B * Skv * 4
    bnd, by = bound_ms(nbytes, 4 * valid * H * D, "bfloat16")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = keep[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    call = lambda: fa.flash_fwd(q, k, v, False, scale, kb)  # noqa: E731
    row = dict(case="dense_decode_sq1", B=B, Sq=1, Skv=Skv, H=H, D=D,
               dtype="bfloat16", key_bias=True, valid_keys=valid,
               max_abs_err=errs["out"][0], row_rel_err=errs["out"][1],
               frobenius_rel_err=errs["out"][2], lse_err=errs["lse"],
               tol=FLASH_TOL["bfloat16"], ms=time_ms(call),
               eager_ms=eager_ms(call),
               plain_ms=time_ms(lambda: fa.flash_fwd_plain(q, k, v, False,
                                                           scale, kb),
                                reps=5, inner=3),
               bound_ms=bnd, bound_by=by,
               library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask)))
    say(card, "flash_attention " + json.dumps(row))
    if bad:
        raise AssertionError(f"flash_fwd at Sq = 1: {bad}")
    return row


# name: (B, S, heads, D, table rows, interleaved, dtype, offset): q and k
# at the LLaMA-7B-shape training step (B 4, S 2048, 32 and 8 heads of 128,
# per-row tables, as the model builds them from position_ids) in bf16 (the
# path), f32 and f16, interleaved pairs, the llama_7b decode tick (B 16,
# one token, 32 + 32 heads, a table per row) and prefill (B 1, S 192, as
# the engine calls it), a ragged S with three tensors and one shared
# table, and the scalar route: D 36 (D/2 not a multiple of a vector) and
# every tensor a contiguous view `offset` elements (2 bytes) off the
# 16-byte line.
ROPE_CASES = {
    "train_neox": (4, 2048, (32, 8), 128, 4, False, "bfloat16", 0),
    "train_neox_f32": (4, 2048, (32, 8), 128, 4, False, "float32", 0),
    "train_interleaved": (4, 2048, (32, 8), 128, 4, True, "bfloat16", 0),
    "decode_per_row": (16, 1, (32, 32), 128, 16, False, "bfloat16", 0),
    "ragged_s37_qkv_shared_d64": (3, 37, (8, 2, 2), 64, 1, True, "float32", 0),
    "prefill_per_row": (1, 192, (32, 32), 128, 1, False, "bfloat16", 0),
    "train_neox_f16": (4, 2048, (32, 8), 128, 4, False, "float16", 0),
    "d36_scalar": (2, 512, (16, 4), 36, 2, False, "bfloat16", 0),
    "odd_offset_scalar": (4, 512, (32, 8), 128, 4, False, "bfloat16", 1),
}
# elements past each tensor's end in `_rope_inputs`: a planted fault that
# reads one vector past a head reads memory of its case
ROPE_SPARE = 64


def _rope_inputs(torch, gen, name):
    """The case's tensors (each cut from a buffer `offset` elements in,
    ROPE_SPARE elements longer) and its tables."""
    B, S, heads, D, Bt, _, dtype, off = ROPE_CASES[name]
    dt = getattr(torch, dtype)
    xs = []
    for h in heads:
        n = B * S * h * D
        buf = (2 * torch.randn(n + off + ROPE_SPARE, device="cuda",
                               generator=gen)).to(dt)
        xs.append(buf[off:off + n].view(B, S, h, D))
    ang = 2048 * torch.rand(Bt, S, D // 2, device="cuda", generator=gen)
    return xs, torch.cos(ang), torch.sin(ang)


def _rope_errors(torch, fr, name, xs, c, s):
    """max |kernel - plain| over the forward and the backward (sin
    negated), NaN where the kernel wrote a non-finite value."""
    il = ROPE_CASES[name][5]
    err = 0.0
    for sign in (1.0, -1.0):
        got = fr.rope(xs, c, s, il, sin_sign=sign)
        ref = fr.rope_plain(xs, c, s, il, sin_sign=sign)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            d = (a.float() - b.float()).abs()
            err = max(err, d.max().item()) if torch.isfinite(d).all() else math.nan
    return err


def _rope_violations(torch, fr, name, xs, c, s):
    dtype = ROPE_CASES[name][6]
    err = _rope_errors(torch, fr, name, xs, c, s)
    return err, ([] if err <= ROPE_TOL[dtype] else
                 [f"fused_rope {name}: max|err| {err} (tol {ROPE_TOL[dtype]})"])


def check_rope(card, torch):
    """The fused-RoPE kernel against its plain version, forward and
    backward (sin negated), at ROPE_CASES; each case's route (16-byte
    vectors or scalar), its grid (`ops.fused_rope.rope_plan`), its bound
    and its share of it. The kernel and the plain version round alike, so
    max|err| should be 0 (`bit_exact`); ROPE_TOL is the limit. No single
    PyTorch call computes it: library_ms is null."""
    from paddle_tpu_torch.ops import fused_rope as fr

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst, main, bad = 0.0, None, []
    for name, (B, S, heads, D, Bt, il, dtype, _) in ROPE_CASES.items():
        xs, c, s = _rope_inputs(torch, gen, name)
        err, why = _rope_violations(torch, fr, name, xs, c, s)
        bad += why
        worst = max(worst, err)
        es = xs[0].element_size()
        aligned = all(t.data_ptr() % 16 == 0 for t in (*xs, c, s))
        plan = fr.rope_plan(B, S, heads, D, es, aligned)
        pairs = sum(x.numel() for x in xs) // 2
        nbytes = 2 * 2 * pairs * es + 2 * c.numel() * 4
        bnd, by = bound_ms(nbytes, 6 * pairs, "float32")
        call = lambda: fr.rope(xs, c, s, il)  # noqa: E731
        ms = time_ms(call)
        row = dict(case=name, dtype=dtype, B=B, S=S, heads=list(heads), D=D,
                   table_rows=Bt, interleaved=il,
                   route="vector" if plan.vector > 1 else "scalar",
                   grid=list(plan.grid), block=list(plan.block),
                   heads_per_thread=plan.heads_per_thread,
                   max_abs_err=err, bit_exact=err == 0.0, tol=ROPE_TOL[dtype],
                   ms=ms, eager_ms=eager_ms(call),
                   plain_ms=time_ms(lambda: fr.rope_plain(xs, c, s, il),
                                    reps=5, inner=3),
                   bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
                   library_ms=None)
        say(card, "fused_rope " + json.dumps(row))
        if name == "train_neox":
            main = row
        del xs
    say(card, "fused_rope library_ms: none; no single PyTorch call rotates "
              "q and k by position tables")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"worst": worst, "main": main}


ROPE_KERNEL = re.compile(r"rope_kernelI(f|6__half|13__nv_bfloat16)Li(\d+)ELb([01])E")
ROPE_TYPES = {"f": "float", "6__half": "half", "13__nv_bfloat16": "bf16"}


def _rope_name(ln):
    m = ROPE_KERNEL.search(ln)
    return m and (f"rope_kernel<{ROPE_TYPES[m[1]]}, {m[2]}, "
                  f"{'interleaved' if m[3] == '1' else 'neox'}>")


def rope_ptxas(card, log):
    """Registers and spill-store bytes of each `rope_kernel<T, V,
    interleaved>` instantiation, from nvcc's `-Xptxas -v` report (`log`,
    empty if this process did not build). Raises on a spill, or on a
    missing instantiation when the log holds the build."""
    report = ptxas_kernels(log, None, _rope_name)
    say(card, "fused_rope ptxas " + json.dumps(report))
    spills = [n for n, r in report.items() if r.get("spill_store_bytes")]
    if spills:
        raise AssertionError(f"fused_rope instantiations spill: {spills}")
    if log and len(report) != 12:
        raise AssertionError(f"fused_rope: {len(report)} instantiations "
                             f"built, 12 expected")
    return report


# The dx kernel's cases (R, N, kind, dtype, mean of x, shift). The steps'
# shapes under O2 (f32, batch 4 x 2048 or 8 x 1024): gpt3_1p3b's LayerNorm
# at 2048, then llama_7bshape's RMSNorm at 4096 and gpt3_moe's LayerNorm at
# 1024, after the smaller cases so those keep their inputs; then rows at a
# mean of 1000 (x - mean stays exact in f32: x and the mean lie within a
# factor of 2), x and dy as [R, N] views one element into their buffers
# (off the 16-byte line: the scalar route), and rows past 8192 elements
# (the wide route).
NORM_DX_CASES = [
    (8192, 2048, "ln", "float32", 0.5, 0), (8192, 2048, "ln", "bfloat16", 0.5, 0),
    (37, 1031, "ln", "float32", 0.5, 0), (37, 1031, "ln", "bfloat16", 0.5, 0),
    (512, 2048, "rms", "bfloat16", 0.5, 0), (16, 5120, "rms", "float32", 0.5, 0),
    (8192, 4096, "rms", "float32", 0.5, 0), (8192, 1024, "ln", "float32", 0.5, 0),
    (8192, 1024, "ln", "float32", 1000.0, 0), (8192, 2048, "ln", "float32", 0.5, 1),
    (64, 12288, "ln", "float32", 0.5, 0), (16384, 768, "ln", "float32", 0.5, 0),
    (8192, 640, "ln", "float32", 0.5, 0), (2048, 1280, "ln", "float32", 0.5, 0)]
# the three steps' shapes, where FusedNorm.backward's dweight/dbias
# reductions are timed beside dx (`wdb_ms`)
NORM_DX_STEPS = [(8192, 2048, "ln"), (8192, 4096, "rms"), (8192, 1024, "ln")]


def _norm_dx_inputs(torch, fn, gen, R, N, kind, dtype, mean=0.5, shift=0):
    """x (mean `mean`), w, b, dy of a dx case on the card, x and dy [R, N]
    views `shift` elements into their buffers; rstd and mean from the plain
    forward."""
    dt = getattr(torch, dtype)
    x = (torch.randn(R, N, device="cuda", generator=gen) + mean).to(dt)
    w = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    dy = torch.randn(R, N, device="cuda", generator=gen).to(dt)
    if shift:
        def shifted(t):
            buf = torch.empty(R * N + shift, device="cuda", dtype=dt)
            return buf[shift:].view(R, N).copy_(t)

        x, dy = shifted(x), shifted(dy)
    _, rstd, mu = fn.norm_fwd_plain(x, w, b if kind == "ln" else None, kind,
                                    1e-5)
    return x, w, b, dy, rstd, mu


def _norm_dx_violations(fn, torch, x, w, dy, rstd, mu, kind, dtype):
    """(max |kernel - plain| of dx, the violations of NORM_DX_TOL), NaN
    where the kernel wrote a non-finite value."""
    dx = fn.norm_bwd_dx(x, w, dy, rstd, mu, kind)
    ref = fn.norm_bwd_dx_plain(x, w, dy, rstd, mu, kind)
    torch.cuda.synchronize()
    d = (dx.float() - ref.float()).abs()
    err = d.max().item() if torch.isfinite(d).all() else math.nan
    R, N = x.shape
    return err, ([] if err <= NORM_DX_TOL[dtype] else
                 [f"fused_norm_dx {kind} {dtype} [{R},{N}]: max|err| {err} "
                  f"(tol {NORM_DX_TOL[dtype]})"])


def check_norm_dx(card, torch):
    """The dx kernel against its plain version over NORM_DX_CASES, each
    with its route (`ops.fused_norm.dx_plan`). The main path's shape is f32
    [8192, 2048] (under O2 LayerNorm runs in f32, batch 4 x 2048). At the
    steps' shapes also `wdb_ms`: the dweight and dbias torch reductions of
    FusedNorm.backward, which run beside dx."""
    from paddle_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    main, bad = None, []
    for R, N, kind, dtype, mean, shift in NORM_DX_CASES:
        x, w, b, dy, rstd, mu = _norm_dx_inputs(torch, fn, gen, R, N, kind,
                                                dtype, mean, shift)
        err, why = _norm_dx_violations(fn, torch, x, w, dy, rstd, mu, kind,
                                       dtype)
        bad += why
        worst = max(worst, err)
        es = x.element_size()
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy))
        nbytes = 3 * R * N * es + N * es + R * 4 * (2 if kind == "ln" else 1)
        bnd, by = bound_ms(nbytes, 10 * R * N, "float32")
        k_ms = time_ms(lambda: fn.norm_bwd_dx(x, w, dy, rstd, mu, kind))
        k_eager = eager_ms(lambda: fn.norm_bwd_dx(x, w, dy, rstd, mu, kind))
        p_ms = time_ms(lambda: fn.norm_bwd_dx_plain(x, w, dy, rstd, mu, kind),
                       reps=5, inner=5)
        rstd2 = rstd[:, None]
        if kind == "ln":
            lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [N], mu[:, None], rstd2, w, b, [True, False, False]))
        else:
            lib_ms = time_ms(lambda: torch.ops.aten._fused_rms_norm_backward(
                dy, x, [N], rstd2, w, [True, False]))
        row = dict(kind=kind, dtype=dtype, R=R, N=N, mean=mean, shift=shift,
                   route=fn.dx_plan(R, N, es, aligned).route,
                   max_abs_err=err, tol=NORM_DX_TOL[dtype], ms=k_ms,
                   eager_ms=k_eager, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
                   bound_share=bnd / k_ms, library_ms=lib_ms)
        if (R, N, kind) in NORM_DX_STEPS and mean == 0.5 and not shift:
            def wdb():  # FusedNorm.backward's dweight and dbias lines
                x32 = x.float()
                if kind == "ln":
                    x32 = x32 - mu[:, None]
                (dy.float() * (x32 * rstd[:, None])).sum(0).to(w.dtype)
                if kind == "ln":
                    dy.float().sum(0).to(b.dtype)

            row["wdb_ms"] = time_ms(wdb, reps=5, inner=5)
        say(card, "fused_norm_dx " + json.dumps(row))
        if (R, N, kind, dtype, mean, shift) == NORM_DX_CASES[0]:
            main = row
        del x, dy
    say(card, "fused_norm_dx library_ms: torch.ops.aten.native_layer_norm_"
              "backward / _fused_rms_norm_backward (dx only); wdb_ms: the "
              "dweight (and LayerNorm's dbias) reductions beside dx")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"worst": worst, "main": main}


NORM_DX_KERNEL = re.compile(
    r"norm_bwd_dx_rows_kernelI(f|6__half|13__nv_bfloat16)"
    r"(f|6__half|13__nv_bfloat16|S\d*_)Lb([01])E")


def _norm_dx_name(ln):
    m = NORM_DX_KERNEL.search(ln)
    if not m:
        return None
    t = ROPE_TYPES[m[1]]
    return (f"norm_bwd_dx_rows_kernel<{t}, {ROPE_TYPES.get(m[2], t)}, "
            f"{'ln' if m[3] == '1' else 'rms'}>")


def norm_dx_ptxas(card, log):
    """Registers and spill-store bytes of each `norm_bwd_dx_rows_kernel<T,
    TW, kind>` instantiation (x, weight and kind: 18), from nvcc's
    `-Xptxas -v` report (`log`, empty if this process did not build).
    Raises on a spill, or on a missing instantiation when the log holds the
    build."""
    report = ptxas_kernels(log, None, _norm_dx_name)
    say(card, "fused_norm_dx ptxas " + json.dumps(report))
    spills = [n for n, r in report.items() if r.get("spill_store_bytes")]
    if spills:
        raise AssertionError(f"norm_bwd_dx_rows_kernel instantiations spill: "
                             f"{spills}")
    if log and len(report) != 18:
        raise AssertionError(f"norm_bwd_dx_rows_kernel: {len(report)} "
                             f"instantiations built, 18 expected")
    return report


def _flash_err(got, ref):
    """(max |got - ref|, the largest over rows (the last axis is a row) of
    max |got - ref| / max(max |ref| in the row, max |ref| / 1000),
    ||got - ref||_F / ||ref||_F)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    top = ref.abs().amax(-1)
    floor = max(top.max().item() * 1e-3, 1e-30)
    row = d.amax(-1) / top.clamp_min(floor)
    return (d.max().item(), row.max().item(),
            (d.norm() / ref.norm().clamp_min(1e-30)).item())


def _lse_err(got, ref):
    """max |got - ref| over the rows that see a key; inf if the rows that see
    none (LSE +inf) differ."""
    fin = ref.isfinite()
    if not bool((fin == got.isfinite()).all()):
        return math.inf
    return (got - ref)[fin].abs().max().item() if fin.any() else 0.0


def _flash_errs(got, ref):
    return {w: _lse_err(g, ref[w]) if w == "lse" else _flash_err(g, ref[w])
            for w, g in got.items()}


def _flash_violations(errs, dtype):
    """The outputs whose errors (as `_flash_errs` gives them) break the
    limits."""
    bad = []
    for what, e in errs.items():
        if what == "lse":
            if not e <= FLASH_LSE_TOL:
                bad.append(f"lse max|err| {e} (tol {FLASH_LSE_TOL})")
        elif not (e[1] <= FLASH_TOL[dtype] and e[2] <= FLASH_FROB_TOL[dtype]):
            bad.append(f"{what} row-relative {e[1]} (tol {FLASH_TOL[dtype]}), "
                       f"Frobenius {e[2]} (tol {FLASH_FROB_TOL[dtype]})")
    return bad


# name: (B, Sq, Skv, H, Hkv, D, causal, key bias, dtype). The bf16 kernels'
# tiles are 128 x 128: the edge cases put S off them (333, 517, 257, 200,
# 150), D at 64, below it (40, and 36, which is not a multiple of 8: the
# wrappers' copy route) and between the panels (96), Sq > Skv (rows that
# see no key; at 456 over 200 the first two 128-row q tiles see none, so
# their dQ CTAs visit no kv tile) and Skv > Sq with an offset Skv - Sq off
# the 64-row step (184), and q/k/v as views (FLASH_LAYOUTS).
FLASH_CASES = {
    "path": (4, 2048, 2048, 16, 16, 128, True, False, "bfloat16"),
    "f32": (1, 1024, 1024, 16, 16, 128, True, False, "float32"),
    "gqa_g4": (2, 512, 512, 16, 4, 128, True, False, "bfloat16"),
    "ragged_sq_lt_skv_g2_d64": (2, 333, 517, 8, 4, 64, True, False, "bfloat16"),
    "sq_gt_skv_f32_d64": (1, 300, 200, 4, 4, 64, True, False, "float32"),
    "key_bias_padded_row": (3, 257, 257, 8, 8, 128, False, True, "bfloat16"),
    "sq_gt_skv_d64": (1, 300, 200, 4, 4, 64, True, False, "bfloat16"),
    "sq_gt_skv_by_two_tiles_d64": (1, 456, 200, 4, 4, 64, True, False,
                                   "bfloat16"),
    "d40_causal": (2, 200, 200, 8, 8, 40, True, False, "bfloat16"),
    "d96_g2": (1, 384, 384, 8, 4, 96, True, False, "bfloat16"),
    "d36_copy": (1, 150, 150, 4, 2, 36, False, False, "bfloat16"),
    "fused_qkv_view": (2, 384, 384, 16, 16, 128, True, False, "bfloat16"),
    "unaligned_view_copy": (1, 200, 200, 8, 8, 64, True, False, "bfloat16"),
    # bert_base's attention at bench.py's rung: BERT's additive key bias
    "bert_key_bias": (32, 512, 512, 12, 12, 64, False, "bert", "bfloat16"),
    # bert_base's widths without a key bias: the fused encoder's attention
    # (fused_multi_head_attention, phase 27)
    "fused_encoder_d64": (32, 512, 512, 12, 12, 64, False, False, "bfloat16"),
    # unet_sd's attention at bench.py's rung (batch 8, a 64 x 64 latent, 8
    # heads, a context of 77): level 1 at 32 x 32 positions, heads of 80;
    # level 2 and the mid block at 16 x 16, heads of 160 (the 192 width)
    "unet_self_d80": (8, 1024, 1024, 8, 8, 80, False, False, "bfloat16"),
    "unet_cross_d80": (8, 1024, 77, 8, 8, 80, False, False, "bfloat16"),
    "unet_self_d160": (8, 256, 256, 8, 8, 160, False, False, "bfloat16"),
    "unet_cross_d160": (8, 256, 77, 8, 8, 160, False, False, "bfloat16"),
    "unet_self_d160_f32": (8, 256, 256, 8, 8, 160, False, False, "float32"),
    # the 192 width's edges: causal with the offset off the tiles, GQA, a
    # padded key bias, the full width, f32
    "d160_causal_ragged_g2": (1, 333, 517, 8, 4, 160, True, False, "bfloat16"),
    "d160_key_bias_padded_row": (3, 257, 257, 8, 8, 160, False, True,
                                 "bfloat16"),
    "d192_causal_sq_gt_skv": (1, 300, 200, 4, 4, 192, True, False, "bfloat16"),
    "d192_causal_f32_g2": (1, 200, 300, 4, 2, 192, True, False, "float32"),
    # float16, the same kernels' f16 instantiations: the path's shape (the
    # kernel table's f16 rows) and one edge at each tile width (64: ragged
    # Sq < Skv with GQA; 128: GQA 4; 192: a padded key bias)
    "path_f16": (4, 2048, 2048, 16, 16, 128, True, False, "float16"),
    "ragged_sq_lt_skv_g2_d64_f16": (2, 333, 517, 8, 4, 64, True, False,
                                    "float16"),
    "gqa_g4_f16": (2, 512, 512, 16, 4, 128, True, False, "float16"),
    "d160_key_bias_padded_row_f16": (3, 257, 257, 8, 8, 160, False, True,
                                     "float16"),
}
# the unet_sd rung's rows of the kernel table (PERF.md rows 1b-3e), each
# timed beside SDPA's forward and backward on the same inputs
FLASH_UNET = ("unet_self_d80", "unet_cross_d80", "unet_self_d160",
              "unet_cross_d160")
# how a case's q, k and v are laid out (default: three contiguous tensors):
# "fused_qkv" slices one [B, S, 3, H, D] tensor (strided views the TMA maps
# take as they are); "unaligned" views one flat buffer 2 bytes past its
# start (the wrappers copy them)
FLASH_LAYOUTS = {"fused_qkv_view": "fused_qkv",
                 "unaligned_view_copy": "unaligned"}


def _flash_inputs(torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype,
                  layout="contiguous"):
    """(q, k, v, dO, key bias or None, keep [B, Skv] bool). With `bias`,
    batch row b pads its last 17 (b + 1) keys and batch row 1 all of
    them; with `bias == "bert"` BERT's mask, (1 - m) * -1e4: row b pads
    its last (7 b) % 61 keys (a few a row; row 0 none)."""
    dt = getattr(torch, dtype)
    if layout == "fused_qkv":
        qkv = torch.randn(B, Sq, 3, H, D, device="cuda", generator=gen).to(dt)
        q, k, v = qkv.unbind(2)
    elif layout == "unaligned":
        nq, nkv = B * Sq * H * D, B * Skv * Hkv * D
        flat = torch.randn(nq + 2 * nkv + 1, device="cuda",
                           generator=gen).to(dt)[1:]
        q = flat[:nq].view(B, Sq, H, D)
        k = flat[nq:nq + nkv].view(B, Skv, Hkv, D)
        v = flat[nq + nkv:].view(B, Skv, Hkv, D)
    else:
        q = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dt)
        k = torch.randn(B, Skv, Hkv, D, device="cuda", generator=gen).to(dt)
        v = torch.randn(B, Skv, Hkv, D, device="cuda", generator=gen).to(dt)
    dout = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dt)
    kb = None
    keep = torch.ones(B, Skv, dtype=torch.bool, device="cuda")
    if bias == "bert":
        for bi in range(1, B):
            keep[bi, Skv - (7 * bi) % 61:] = False
        kb = torch.where(keep, 0.0, -1e4).float()
    elif bias:
        for bi in range(B):
            keep[bi, Skv - 17 * (bi + 1):] = False
        keep[1] = False
        kb = torch.where(keep, 0.0, -1e30).float()
    return q, k, v, dout, kb, keep


def _flash_outputs(fa, q, k, v, dout, kb, causal, scale):
    """(the kernels' outputs, the plain versions', delta) on the same
    inputs; the backward kernels get the plain forward's LSE and
    delta = rowsum(dO * O). dK and dV are the kv heads' f32 gradients
    [B, Skv, Hkv, D] on both sides."""
    out, lse = fa.flash_fwd(q, k, v, causal, scale, kb)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale, kb)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, kb, dout, lse_p, delta, causal, scale)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, kb, dout, lse_p, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, kb, dout, lse_p, delta, causal, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, kb, dout, lse_p, delta,
                                        causal, scale)
    return ({"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
            {"out": out_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
            delta)


def check_flash(card, torch):
    """Forward, dq and dk/dv kernels against their plain versions on the
    same inputs (the backward kernels get the plain forward's LSE and
    delta). Cases: the training path's shape (B 4, S 2048, 16 heads of 128,
    causal, bf16), f32, GQA g = 4, ragged Sq != Skv (bottom-right causal),
    Sq > Skv (rows that see no key), a key bias with a fully padded batch
    row."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {d: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0} for d in (False, True)}
    main = {}  # the path's rows, bf16 ("path") and f16 ("path_f16")
    failures = []  # raised together once every case has printed its row
    for name, (B, Sq, Skv, H, Hkv, D, causal, bias, dtype) in FLASH_CASES.items():
        q, k, v, dout, kb, keep = _flash_inputs(
            torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype,
            FLASH_LAYOUTS.get(name, "contiguous"))
        scale = D ** -0.5
        got, plain, delta = _flash_outputs(fa, q, k, v, dout, kb, causal, scale)
        torch.cuda.synchronize()
        out, dq, lse_p = got["out"], got["dq"], plain["lse"]
        errs = _flash_errs(got, plain)
        failures += [f"flash {name}: {b}" for b in _flash_violations(errs, dtype)]
        empty = torch.isinf(lse_p).transpose(1, 2)  # [B, Sq, H]
        n_empty = int(empty.sum())
        if n_empty and (out[empty].abs().max().item() != 0
                        or dq[empty].abs().max().item() != 0):
            failures.append(f"flash {name}: a row that sees no key is not zero")
        # pairs (query row, key) whose logit the function needs
        vis = fa._visible(Sq, Skv, causal, "cuda")
        pairs = int((vis[None] & keep[:, None, :]).sum()) * H
        es = q.element_size()
        qo = B * Sq * H * D * es
        kv = B * Skv * Hkv * D * es
        stats = B * H * Sq * 4
        kb_bytes = 0 if kb is None else B * Skv * 4
        shapes = dict(B=B, Sq=Sq, Skv=Skv, H=H, Hkv=Hkv, D=D, causal=causal,
                      key_bias=bias, dtype=dtype, pairs=pairs,
                      rows_without_keys=n_empty)
        heavy = pairs * D > 1e10
        reps, inner = (5, 3) if heavy else (10, 10)
        # kernel: (call, plain call, bytes, operations, outputs compared)
        rows = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, causal, scale, kb),
                    lambda: fa.flash_fwd_plain(q, k, v, causal, scale, kb),
                    2 * qo + 2 * kv + stats + kb_bytes, 4 * pairs * D,
                    ("out", "lse")),
            "dq": (lambda: fa.flash_bwd_dq(q, k, v, kb, dout, lse_p, delta,
                                           causal, scale),
                   lambda: fa.flash_bwd_dq_plain(q, k, v, kb, dout, lse_p,
                                                 delta, causal, scale),
                   3 * qo + 2 * kv + 2 * stats + kb_bytes, 6 * pairs * D,
                   ("dq",)),
            "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, kb, dout, lse_p, delta,
                                             causal, scale),
                    lambda: fa.flash_bwd_dkv_plain(q, k, v, kb, dout, lse_p,
                                                   delta, causal, scale),
                    2 * qo + 2 * kv + 2 * stats + kb_bytes
                    + 2 * B * Skv * Hkv * D * 4, 8 * pairs * D, ("dk", "dv")),
        }
        lib = {}
        if name == "path":
            lib = lib_path = library_sdpa(torch, q, k, v, dout, causal)
        elif name in FLASH_UNET or name in ("path_f16", "fused_encoder_d64"):
            lib = library_sdpa(torch, q, k, v, dout, causal)
        elif name == "bert_key_bias":
            # the same additive key bias as SDPA's attn_mask
            lib = library_sdpa(torch, q, k, v, dout, causal,
                               keep=kb.to(q.dtype)[:, None, None, :])
        for kernel, (fn_k, fn_p, nbytes, ops, outs) in rows.items():
            bnd, by = bound_ms(nbytes, ops, dtype)
            err = max(errs[o][0] if o != "lse" else errs[o] for o in outs)
            row = dict(kernel=kernel, case=name, **shapes, max_abs_err=err,
                       row_rel_err=max(errs[o][1] for o in outs if o != "lse"),
                       frobenius_rel_err=max(errs[o][2] for o in outs
                                             if o != "lse"),
                       tol=FLASH_TOL[dtype], frobenius_tol=FLASH_FROB_TOL[dtype],
                       ms=time_ms(fn_k, reps=reps, inner=inner),
                       eager_ms=eager_ms(fn_k, reps=reps, inner=inner),
                       plain_ms=time_ms(fn_p, reps=3, inner=2),
                       bound_ms=bnd, bound_by=by,
                       library_ms=lib.get(kernel))
            say(card, "flash_attention " + json.dumps(row))
            w = worst[dtype == "float16"]
            w[kernel] = max(w[kernel], err)
            if name in ("path", "path_f16"):
                main.setdefault(name, {})[kernel] = row
        del q, k, v, dout, got, plain, out, dq
        torch.cuda.empty_cache()
    # past the widest tiles the wrappers raise: no plain version on the card
    q = torch.zeros(1, 8, 1, fa.MAX_HEAD_DIM + 1, device="cuda",
                    dtype=torch.bfloat16)
    for fn in (lambda: fa.flash_fwd(q, q, q, False, 1.0),
               lambda: fa.flash_attention_fwd(q.float(), q.float(), q.float())):
        try:
            fn()
            failures.append(f"flash: head dim {q.shape[-1]} did not raise")
        except ValueError:
            pass
    say(card, "flash_attention library_ms: torch scaled_dot_product_attention"
              "(is_causal=True) forward (bert_key_bias: with the key bias as "
              "its additive attn_mask); its backward through autograd (device "
              "time, forward and backward in one CUDA graph less the forward), "
              "one figure for dq and dk/dv together, listed under both; the "
              "path's backward measured three times: "
              + json.dumps(lib_path["bwd_runs"]))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst[False], "main": main["path"],
            "worst_f16": worst[True], "main_f16": main["path_f16"]}


# the autograd check's shapes: (B, Sq, Skv, H, Hkv, D, causal, key bias,
# dtype), the training path's and one GQA shape
FLASH_AUTOGRAD_CASES = {
    "path": FLASH_CASES["path"],
    "gqa_32_8": (2, 1024, 1024, 32, 8, 128, True, False, "bfloat16"),
}


def check_flash_autograd(card, torch):
    """flash_attention_fwd(q, k, v).backward(dO) in bf16 through the kernels,
    at the training path's shape (B 4 x 2048, 16 heads of 128, causal) and
    at GQA 32/8 (B 2 x 1024), against the same autograd function's plain
    versions on the same inputs on the card (the plain forward's LSE and
    delta, dq, and dk/dv of the kv heads rounded to k's dtype as the
    backward rounds the kernel's), held with check_flash's limits. It holds
    what autograd adds around the kernels: dO as autograd hands it over and
    the kv heads' f32 gradients the dk/dv kernel writes. One launch of each
    flash kernel a call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    bad = []
    for name, (B, Sq, Skv, H, Hkv, D, causal, bias, dtype) in \
            FLASH_AUTOGRAD_CASES.items():
        q, k, v, dout, kb, _ = _flash_inputs(torch, gen, B, Sq, Skv, H, Hkv, D,
                                             bias, dtype)
        scale = D ** -0.5
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        out = fa.flash_attention_fwd(*leaves, causal=causal, scale=scale,
                                     key_bias=kb)
        out.backward(dout)
        torch.cuda.synchronize()
        launches = [a - b for a, b in zip(
            (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)]
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale, kb)
        delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
        dq_p = fa.flash_bwd_dq_plain(q, k, v, kb, dout, lse_p, delta, causal,
                                     scale)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, kb, dout, lse_p, delta,
                                            causal, scale)
        got = {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
               "dv": leaves[2].grad}
        plain = {"out": out_p, "dq": dq_p, "dk": dk_p.to(k.dtype),
                 "dv": dv_p.to(v.dtype)}
        errs = _flash_errs(got, plain)
        bad += [f"{name}: {b}" for b in _flash_violations(errs, dtype)]
        shapes = {w: list(t.shape) for w, t in got.items()}
        say(card, "flash autograd " + json.dumps({
            "case": name, "B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv,
            "D": D, "causal": causal, "launches_fwd_dq_dkv": launches,
            "shapes": shapes,
            "errors": {w: {"max_abs": e[0], "row_rel": e[1],
                           "frobenius_rel": e[2]} for w, e in errs.items()},
            "tol": FLASH_TOL[dtype], "frobenius_tol": FLASH_FROB_TOL[dtype]}))
        if launches != [1, 1, 1]:
            bad.append(f"{name}: launches (fwd, dq, dk/dv) {launches}, not "
                       "one each")
        for w, t in (("dk", k), ("dv", v)):
            if shapes[w] != list(t.shape) or got[w].dtype != t.dtype:
                bad.append(f"{name}: {w} {shapes[w]} {got[w].dtype}, not "
                           f"{list(t.shape)} {t.dtype}")
        del q, k, v, dout, leaves, out, got, plain, out_p, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("flash autograd: " + "; ".join(bad))


def library_sdpa(torch, q, k, v, dout, causal, keep=None):
    """Yardstick device times of PyTorch's own attention on the same inputs
    (never called by the port), CUDA-graph replays as for the kernels: the
    forward, and the backward through autograd as the time of forward and
    backward captured together less the forward's. k and v are expanded to
    the query heads first (not timed); `keep`, where given, is the
    attn_mask (bool [B, H, Sq, Skv], or additive and broadcasting to it),
    else `causal` is is_causal. The backward is
    measured three times; the median is the yardstick, `bwd_runs` the
    spread."""
    g = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    dh = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(is_causal=causal) if keep is None else dict(attn_mask=keep)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qh, kh, vh, **kw), (qh, kh, vh), dh)

    fwd = time_ms(lambda: sdpa(qh, kh, vh, **kw), reps=5, inner=5)
    bwd = sorted(time_ms(fwd_bwd, reps=5, inner=5) - fwd for _ in range(3))
    return {"fwd": fwd, "dq": bwd[1], "dkv": bwd[1], "bwd_runs": bwd}


def _docs(rng, S, n_docs):
    """Column -> first row of the next document (S in the last one)."""
    cuts = np.sort(rng.choice(np.arange(1, S), n_docs - 1, replace=False))
    bounds = np.concatenate([cuts, [S]])
    return bounds[np.searchsorted(bounds, np.arange(S), side="right")]


def flashmask_index(rng, B, Hm, S, n, kind):
    """startend_row_indices in the kernels' layout, int32 [B, Hm, n, S],
    of a mask kind: "trivial" (nothing masked beyond causal: the LLaMA
    step's index), "docs" (causal, 4 documents a row; with n = 2 only the
    next S/4 rows past a document are masked), "band" (non-causal n = 2:
    rows >= col + w1 or < col - w2), "two_holes" (non-causal n = 4) and
    "empty_rows" (non-causal n = 2: rows >= S - 5 keep no key)."""
    idx = np.empty((B, Hm, n, S), np.int32)
    cols = np.arange(S)
    for b in range(B):
        for hm in range(Hm):
            if kind == "trivial":
                idx[b, hm] = S
            elif kind == "docs":
                idx[b, hm, 0] = _docs(rng, S, 4)
                if n == 2:
                    idx[b, hm, 1] = np.minimum(idx[b, hm, 0] + S // 4, S)
            elif kind == "band":
                idx[b, hm, 0] = np.minimum(cols + int(rng.integers(64, 200)), S)
                idx[b, hm, 1] = np.maximum(cols - int(rng.integers(64, 200)), 0)
            elif kind == "two_holes":
                lts = rng.integers(0, S // 2, S)
                uts = rng.integers(S // 2, S, S)
                idx[b, hm] = [lts, lts + rng.integers(0, S // 4, S), uts,
                              uts + rng.integers(0, S // 4, S)]
            elif kind == "empty_rows":
                idx[b, hm, 0], idx[b, hm, 1] = S - 5, 0
    return idx


# name: (B, S, H, Hkv, Hm, D, causal, n, mask kind, dtype)
FLASHMASK_CASES = {
    "path": (4, 2048, 32, 8, 1, 128, True, 1, "trivial", "bfloat16"),
    "causal_n1_docs": (2, 1024, 8, 8, 1, 128, True, 1, "docs", "bfloat16"),
    "causal_n1_docs_d160": (2, 1024, 8, 8, 1, 160, True, 1, "docs",
                            "bfloat16"),
    "causal_n2_per_head_s1000_gqa": (1, 1000, 8, 2, 8, 128, True, 2, "docs",
                                     "bfloat16"),
    "full_n2_band_f32_d64": (1, 517, 4, 4, 1, 64, False, 2, "band", "float32"),
    "full_n4_gqa_32_8": (2, 300, 32, 8, 1, 128, False, 4, "two_holes",
                         "bfloat16"),
    "empty_rows_f32_d64": (2, 200, 4, 2, 1, 64, False, 2, "empty_rows",
                           "float32"),
    "full_n2_band_d64": (1, 517, 4, 4, 1, 64, False, 2, "band", "bfloat16"),
    "empty_rows_d64": (2, 200, 4, 2, 1, 64, False, 2, "empty_rows",
                       "bfloat16"),
    # float16: the path's shape (the kernel table's f16 rows) and documents
    # with a mask per head at S 1000 and GQA
    "path_f16": (4, 2048, 32, 8, 1, 128, True, 1, "trivial", "float16"),
    "causal_n2_per_head_s1000_gqa_f16": (1, 1000, 8, 2, 8, 128, True, 2,
                                         "docs", "float16"),
}


def _flashmask_inputs(torch, gen, name):
    """(q, k, v, dO, idx [B, Hm, n, S] int32 on the card, causal, dtype)
    of a FLASHMASK_CASES case."""
    B, S, H, Hkv, Hm, D, causal, n, kind, dtype = FLASHMASK_CASES[name]
    q, k, v, dout, _, _ = _flash_inputs(torch, gen, B, S, S, H, Hkv, D, False,
                                        dtype)
    idx = flashmask_index(np.random.default_rng(len(name)), B, Hm, S, n, kind)
    return q, k, v, dout, torch.as_tensor(idx, device="cuda"), causal, dtype


def _flashmask_classes(mf, torch, q, idx, causal):
    """The tile classes the 16-bit kernels read (None in f32), derived once
    as FlashmaskAttention's forward does for its backward."""
    if q.dtype == torch.float32:
        return None
    return mf.flashmask_tile_classes(idx, q.shape[1], q.shape[1], causal)


def _flashmask_outputs(mf, q, k, v, dout, idx, causal, scale, cls):
    """As `_flash_outputs`, for the flashmask kernels; the backward
    kernels read the tile classes `cls`."""
    out, lse = mf.flashmask_fwd(q, k, v, idx, causal, scale)
    out_p, lse_p = mf.flashmask_fwd_plain(q, k, v, idx, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = mf.flashmask_bwd_dq(q, k, v, idx, dout, lse_p, delta, causal, scale,
                             cls)
    dq_p = mf.flashmask_bwd_dq_plain(q, k, v, idx, dout, lse_p, delta, causal,
                                     scale)
    dk, dv = mf.flashmask_bwd_dkv(q, k, v, idx, dout, lse_p, delta, causal,
                                  scale, cls)
    dk_p, dv_p = mf.flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse_p, delta,
                                            causal, scale)
    return ({"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
            {"out": out_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
            delta)


def check_flashmask(card, torch):
    """Flashmask forward, dq and dk/dv kernels against their plain versions
    on the same inputs (the backward kernels get the plain forward's LSE and
    delta), held with check_flash's limits: the LLaMA-7B-shape training
    step's attention (B 4, S 2048, 32 query heads over 8 kv heads, the
    trivial causal index, bf16), causal n = 1 with four documents a row,
    causal n = 2 with a mask per query head at S 1000 (not a multiple of
    the 64-row tile) and GQA, non-causal n = 2 in f32, non-causal n = 4 at
    GQA 32/8, and rows that keep no key (zeros and a zero dq). The
    operation bound counts the pairs this run's masks keep. Library: torch
    scaled_dot_product_attention, is_causal for the trivial index, else the
    keep-mask as a bool attn_mask."""
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {d: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0} for d in (False, True)}
    main, failures, lib_path = {}, [], None
    for name, (B, S, H, Hkv, Hm, D, causal, n, kind, dtype) in \
            FLASHMASK_CASES.items():
        q, k, v, dout, idx, causal, dtype = _flashmask_inputs(torch, gen, name)
        scale = D ** -0.5
        cls = _flashmask_classes(mf, torch, q, idx, causal)
        got, plain, delta = _flashmask_outputs(mf, q, k, v, dout, idx, causal,
                                               scale, cls)
        torch.cuda.synchronize()
        errs = _flash_errs(got, plain)
        failures += [f"flashmask {name}: {b}"
                     for b in _flash_violations(errs, dtype)]
        empty = torch.isinf(plain["lse"]).transpose(1, 2)  # [B, S, H]
        n_empty = int(empty.sum())
        if n_empty and (got["out"][empty].abs().max().item() != 0
                        or got["dq"][empty].abs().max().item() != 0):
            failures.append(f"flashmask {name}: a row that keeps no key is "
                            "not zero")
        keep = mf.flashmask_keep(idx, S, S, causal).repeat_interleave(
            H // Hm, dim=1)
        pairs = int(keep.sum())
        es = q.element_size()
        qo, kv = B * S * H * D * es, B * S * Hkv * D * es
        stats, idx_bytes = B * H * S * 4, idx.numel() * 4
        reps, inner = (5, 3) if pairs * D > 1e10 else (10, 10)
        rows = {
            "fwd": (lambda: mf.flashmask_fwd(q, k, v, idx, causal, scale),
                    lambda: mf.flashmask_fwd_plain(q, k, v, idx, causal, scale),
                    2 * qo + 2 * kv + stats + idx_bytes, 4 * pairs * D,
                    ("out", "lse")),
            "dq": (lambda: mf.flashmask_bwd_dq(q, k, v, idx, dout, plain["lse"],
                                               delta, causal, scale, cls),
                   lambda: mf.flashmask_bwd_dq_plain(
                       q, k, v, idx, dout, plain["lse"], delta, causal, scale),
                   3 * qo + 2 * kv + 2 * stats + idx_bytes, 6 * pairs * D,
                   ("dq",)),
            "dkv": (lambda: mf.flashmask_bwd_dkv(q, k, v, idx, dout,
                                                 plain["lse"], delta, causal,
                                                 scale, cls),
                    lambda: mf.flashmask_bwd_dkv_plain(
                        q, k, v, idx, dout, plain["lse"], delta, causal, scale),
                    2 * qo + 2 * kv + 2 * stats + idx_bytes
                    + 2 * B * S * Hkv * D * 4, 8 * pairs * D, ("dk", "dv")),
        }
        lib = {}
        if name == "path":
            lib = lib_path = library_sdpa(torch, q, k, v, dout, True)
        elif name == "path_f16":
            lib = library_sdpa(torch, q, k, v, dout, True)
        elif name == "causal_n1_docs":
            lib = library_sdpa(torch, q, k, v, dout, causal, keep)
        shapes = dict(B=B, S=S, H=H, Hkv=Hkv, Hm=Hm, n=n, D=D, causal=causal,
                      mask=kind, dtype=dtype, pairs=pairs,
                      rows_without_keys=n_empty)
        for kernel, (fn_k, fn_p, nbytes, ops, outs) in rows.items():
            bnd, by = bound_ms(nbytes, ops, dtype)
            err = max(errs[o][0] if o != "lse" else errs[o] for o in outs)
            row = dict(kernel=kernel, case=name, **shapes, max_abs_err=err,
                       row_rel_err=max(errs[o][1] for o in outs if o != "lse"),
                       frobenius_rel_err=max(errs[o][2] for o in outs
                                             if o != "lse"),
                       tol=FLASH_TOL[dtype], frobenius_tol=FLASH_FROB_TOL[dtype],
                       ms=time_ms(fn_k, reps=reps, inner=inner),
                       eager_ms=eager_ms(fn_k, reps=reps, inner=inner),
                       plain_ms=time_ms(fn_p, reps=3, inner=2),
                       bound_ms=bnd, bound_by=by, library_ms=lib.get(kernel))
            if kernel == "fwd" and dtype != "float32":
                # the wrapper's share of `ms`: the tile classes it derives
                row["tile_classes_ms"] = time_ms(
                    lambda: mf.flashmask_tile_classes(idx, S, S, causal),
                    reps=reps, inner=inner)
            say(card, "flashmask " + json.dumps(row))
            w = worst[dtype == "float16"]
            w[kernel] = max(w[kernel], err)
            if name in ("path", "path_f16"):
                main.setdefault(name, {})[kernel] = row
        del q, k, v, dout, got, plain, keep
        torch.cuda.empty_cache()
    say(card, "flashmask library_ms: torch scaled_dot_product_attention on "
              "k and v expanded to the query heads, is_causal for the trivial "
              "index and the keep-mask as a bool attn_mask for the documents; "
              "its backward as in flash_attention, one figure for dq and "
              "dk/dv; the path's backward measured three times: "
              + json.dumps(lib_path["bwd_runs"]))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst[False], "main": main["path"],
            "worst_f16": worst[True], "main_f16": main["path_f16"]}


def check_flashmask_autograd(card, torch):
    """flashmask_attention_fwd(q, k, v, idx).backward(dO) at the path shape
    (FLASHMASK_CASES "path": bf16, B 4 x 2048, 32 query heads over 8 kv
    heads of 128, the trivial causal index) through the kernels, against
    the plain functions on the same inputs on the card, held with
    check_flash's limits: O, dQ, and dK and dV of the kv heads (the plain
    versions' group sums, rounded to k's dtype as the backward rounds the
    kernel's). It holds what autograd adds around the kernels: the tile
    classes the forward saves for the backward, dO as autograd hands it
    over, and the kv heads' f32 gradients the dk/dv kernel writes. One
    launch of each flashmask kernel."""
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, dout, idx, causal, dtype = _flashmask_inputs(torch, gen, "path")
    scale = q.shape[-1] ** -0.5
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (mf.FWD_LAUNCHES, mf.DQ_LAUNCHES, mf.DKV_LAUNCHES)
    out = mf.flashmask_attention_fwd(*leaves, idx.transpose(2, 3),
                                     causal=causal, scale=scale)
    out.backward(dout)
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(
        (mf.FWD_LAUNCHES, mf.DQ_LAUNCHES, mf.DKV_LAUNCHES), before)]
    out_p, lse_p = mf.flashmask_fwd_plain(q, k, v, idx, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq_p = mf.flashmask_bwd_dq_plain(q, k, v, idx, dout, lse_p, delta, causal,
                                     scale)
    dk_p, dv_p = mf.flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse_p, delta,
                                            causal, scale)
    got = {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
           "dv": leaves[2].grad}
    plain = {"out": out_p, "dq": dq_p, "dk": dk_p.to(k.dtype),
             "dv": dv_p.to(v.dtype)}
    errs = _flash_errs(got, plain)
    bad = _flash_violations(errs, dtype)
    shapes = {w: list(t.shape) for w, t in got.items()}
    say(card, "flashmask autograd " + json.dumps({
        "case": "path", "launches_fwd_dq_dkv": launches, "shapes": shapes,
        "errors": {w: {"max_abs": e[0], "row_rel": e[1], "frobenius_rel": e[2]}
                   for w, e in errs.items()},
        "tol": FLASH_TOL[dtype], "frobenius_tol": FLASH_FROB_TOL[dtype]}))
    if launches != [1, 1, 1]:
        bad.append(f"launches (fwd, dq, dk/dv) {launches}, not one each")
    if shapes["dk"] != list(k.shape) or got["dk"].dtype != k.dtype:
        bad.append(f"dk {shapes['dk']} {got['dk'].dtype}, not k's")
    del q, k, v, dout, leaves, out, got, plain
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("flashmask autograd: " + "; ".join(bad))


# Grouped GEMM kernel vs plain, every output row held to its own largest
# |plain| (or to a thousandth of the tensor's largest, for rows that are
# zero): f32 differs only in the order of the K-sums (K <= 4096 products of
# magnitude ~1: a few 1e-7 of the row); bf16 multiplies the same bf16
# operands exactly on both sides, accumulates in f32 and rounds once, so
# the two may land on neighbouring bf16 values: one ulp, at most 2^-7 of
# the row's largest value. The limit is two ulps. Rows past a group's
# computed rows (dead tiles) must be exactly zero.
# two ulps of the output type (bf16 2^-7 relative, f16 2^-10)
GG_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6, "float16": 2 ** -9}

# name: (E, R, K, N, live rows a group or "rung", rhs read transposed, dtype).
# K is lhs's depth and N the output's width; a transposed rhs is [E, N, K]
# (the backward's dlhs against the weights). The rung's cases take the
# group sizes of one routing of the gpt3_moe rung (rung_sizes).
GG_CASES = {
    "rung_w1": (8, 1280, 1024, 4096, "rung", False, "bfloat16"),
    "rung_w2": (8, 1280, 4096, 1024, "rung", False, "bfloat16"),
    "rung_w2_dlhs": (8, 1280, 1024, 4096, "rung", True, "bfloat16"),
    "rung_w1_dlhs": (8, 1280, 4096, 1024, "rung", True, "bfloat16"),
    "rung_w1_f32": (8, 1280, 1024, 4096, "rung", False, "float32"),
    "rung_w2_f32": (8, 1280, 4096, 1024, "rung", False, "float32"),
    "r16_k37_f32": (4, 16, 37, 50, [0, 16, 5, 9], False, "float32"),
    "r48_n136": (3, 48, 72, 136, [48, 0, 17], False, "bfloat16"),
    "r48_dlhs_k37_f32": (3, 48, 37, 70, [48, 0, 17], True, "float32"),
    "partial_tiles": (4, 256, 64, 200, [65, 130, 0, 256], False, "bfloat16"),
    "k100_dlhs": (2, 128, 100, 96, [100, 1], True, "bfloat16"),
    # float16: the rung's first forward product (the kernel table's f16
    # row) and its dlhs, partly live tiles, K off the TMA line
    "rung_w1_f16": (8, 1280, 1024, 4096, "rung", False, "float16"),
    "rung_w2_dlhs_f16": (8, 1280, 1024, 4096, "rung", True, "float16"),
    "partial_tiles_f16": (4, 256, 64, 200, [65, 130, 0, 256], False,
                          "float16"),
    "k100_dlhs_f16": (2, 128, 100, 96, [100, 1], True, "float16"),
}


def rung_sizes(torch):
    """([8] int32 live rows a group, the capacity) of one routing of the
    gpt3_moe rung: a GShard gate at width 1024 over 8 experts (weights and
    random routing from seed 0, training) on 8192 tokens of N(0, 1)
    activations, each expert's routed pairs cut at the capacity 1229."""
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate

    gen = torch.Generator(device="cuda").manual_seed(0)
    gate = GShardGate(1024, 8, device="cuda", generator=gen)
    x = torch.randn(8192, 1024, device="cuda", generator=gen)
    with torch.no_grad():
        topi, _, keep, _ = gate._route(x, gate.gate.weight, gate.gate.bias)
    counts = torch.bincount(topi[keep], minlength=8)
    cap = gate.capacity(8192)
    return torch.clamp(counts, max=cap).to(torch.int32), cap


def _gg_inputs(torch, gen, name, sizes_rung):
    """(lhs with values in every row, dead ones included, rhs, sizes) of a
    GG_CASES case on the card."""
    E, R, K, N, sizes, trans, dtype = GG_CASES[name]
    dt = getattr(torch, dtype)
    sz = sizes_rung if sizes == "rung" else torch.tensor(
        sizes, dtype=torch.int32, device="cuda")
    lhs = torch.randn(E * R, K, device="cuda", generator=gen).to(dt)
    shape = (E, N, K) if trans else (E, K, N)
    rhs = (torch.randn(*shape, device="cuda", generator=gen) * K ** -0.5).to(dt)
    return lhs, rhs, sz


def _gg_violations(gg, torch, name, out, ref, sz):
    """What breaks the limits: the row-relative error, a non-zero dead row,
    a non-finite value."""
    E, R, _, _, _, _, dtype = GG_CASES[name]
    err = _flash_err(out, ref)
    live = gg._computed_mask(sz, E, R, gg.BM, out.device).reshape(E * R)
    bad = []
    if not err[1] <= GG_TOL[dtype]:
        bad.append(f"row-relative {err[1]} (tol {GG_TOL[dtype]})")
    if bool(out[~live].any()):
        bad.append("a dead row is not zero")
    if not bool(torch.isfinite(out).all()):
        bad.append("non-finite output")
    return bad, err


def check_grouped_gemm(card, torch):
    """The grouped GEMM kernel against its plain version: the gpt3_moe
    rung's four products (the two forward GEMMs of an MoE block and their
    dlhs against the transposed weights, with the group sizes of a real
    routing) in bf16, the two forward ones in f32, and edge cases: a group
    with no live rows, one with all R, partly live tiles, the small strides
    R = 16 and 48 that row_stride gives, and K and N not multiples of the
    tile (K not a multiple of 8: the wrapper pads it for the bf16 kernel's
    TMA maps). The bound counts the rows this run's sizes make the kernel
    compute. Library: one torch.bmm
    over [E, R, K] x [E, K, N], which computes the dead rows too."""
    from paddle_tpu_torch.ops import grouped_gemm as gg

    gen = torch.Generator(device="cuda").manual_seed(11)
    sizes_rung, cap = rung_sizes(torch)
    say(card, f"grouped_gemm rung routing: sizes {sizes_rung.tolist()}, "
              f"capacity {cap}, row stride {gg.row_stride(cap)}")
    worst, main, failures = {False: 0.0, True: 0.0}, {}, []
    for name, (E, R, K, N, sizes, trans, dtype) in GG_CASES.items():
        lhs, rhs, sz = _gg_inputs(torch, gen, name, sizes_rung)
        out = gg.grouped_gemm(lhs, rhs, sz, trans)
        ref = gg.grouped_matmul_plain(lhs, rhs, sz, gg.BM, trans)
        torch.cuda.synchronize()
        bad, err = _gg_violations(gg, torch, name, out, ref, sz)
        failures += [f"grouped_gemm {name}: {b}" for b in bad]
        rows = int(gg.computed_rows(sz, R).sum())
        es = lhs.element_size()
        nbytes = (rows * K + int((sz > 0).sum()) * K * N + E * R * N) * es + E * 4
        ops = 2 * rows * K * N
        bnd, by = bound_ms(nbytes, ops, dtype)
        reps, inner = (5, 5) if ops > 1e10 else (10, 10)
        lib = None
        if sizes == "rung":
            w, l3 = (rhs.transpose(1, 2) if trans else rhs), lhs.view(E, R, K)
            lib = time_ms(lambda: torch.bmm(l3, w), reps=reps, inner=inner)
        row = dict(case=name, E=E, R=R, K=K, N=N, trans_rhs=trans, dtype=dtype,
                   sizes=sz.tolist(), computed_rows=rows, max_abs_err=err[0],
                   row_rel_err=err[1], tol=GG_TOL[dtype],
                   ms=time_ms(lambda: gg.grouped_gemm(lhs, rhs, sz, trans),
                              reps=reps, inner=inner),
                   eager_ms=eager_ms(lambda: gg.grouped_gemm(lhs, rhs, sz, trans),
                                     reps=reps, inner=inner),
                   plain_ms=time_ms(lambda: gg.grouped_matmul_plain(
                       lhs, rhs, sz, gg.BM, trans), reps=3, inner=2),
                   bound_ms=bnd, bound_by=by, library_ms=lib)
        say(card, "grouped_gemm " + json.dumps(row))
        worst[dtype == "float16"] = max(worst[dtype == "float16"], err[0])
        if name in ("rung_w1", "rung_w1_f16"):
            main[name] = row
        del lhs, rhs, out, ref
    torch.cuda.empty_cache()
    say(card, "grouped_gemm library_ms: torch.bmm over [E, R, K] x [E, K, N] "
              "(the transposed weights as a view for dlhs), dead rows "
              "computed too")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst[False], "main": main["rung_w1"],
            "worst_f16": worst[True], "main_f16": main["rung_w1_f16"]}


# name: (q document lengths, or ("docs", T, documents) cut as `_docs` cuts
# them; k lengths, None for the q lengths; H, Hkv, D, causal, dtype)
VARLEN_CASES = {
    "path": (("docs", 8192, 8), None, 32, 8, 128, True, "bfloat16"),
    "full_docs_t1000_f32_d64": (("docs", 1000, 4), None, 4, 2, 64, False,
                                "float32"),
    "cross_causal_gqa": ([300, 200, 500], [100, 400, 250], 8, 2, 128, True,
                         "bfloat16"),
    "cross_causal_gqa_d160": ([300, 200, 500], [100, 400, 250], 8, 2, 160,
                              True, "bfloat16"),
    "empty_k_segment_f32_d64": ([100, 60, 140], [120, 0, 100], 4, 4, 64,
                                True, "float32"),
    "empty_k_segment_bf16": ([100, 60, 140], [120, 0, 100], 8, 2, 128, True,
                             "bfloat16"),
    "single_tile_d32": ([7, 9, 11], None, 2, 1, 32, True, "bfloat16"),
    # float16: the path's pack (the kernel table's f16 rows) and causal
    # cross attention with GQA
    "path_f16": (("docs", 8192, 8), None, 32, 8, 128, True, "float16"),
    "cross_causal_gqa_f16": ([300, 200, 500], [100, 400, 250], 8, 2, 128,
                             True, "float16"),
}


def _varlen_lens(rng, spec):
    if isinstance(spec, tuple):
        _, T, n = spec
        ends = np.unique(_docs(rng, T, n))
        return np.diff(np.concatenate([[0], ends])).tolist()
    return list(spec)


def _varlen_inputs(torch, gen, name):
    """(q, k, v, dO, layout, cu_q, cu_k, causal, dtype) of a VARLEN_CASES
    case on the card."""
    from paddle_tpu_torch.ops import masked_flash as mf

    spec_q, spec_k, H, Hkv, D, causal, dtype = VARLEN_CASES[name]
    # an f16 case cuts its documents as its bf16 twin does
    rng = np.random.default_rng(len(name.removesuffix("_f16")))
    lens_q = _varlen_lens(rng, spec_q)
    lens_k = lens_q if spec_k is None else _varlen_lens(rng, spec_k)
    cu_q, cu_k = (torch.tensor(np.concatenate([[0], np.cumsum(l)]),
                               dtype=torch.int32, device="cuda")
                  for l in (lens_q, lens_k))
    Tq, Tk = sum(lens_q), sum(lens_k)
    dt = getattr(torch, dtype)
    q = torch.randn(Tq, H, D, device="cuda", generator=gen).to(dt)
    k = torch.randn(Tk, Hkv, D, device="cuda", generator=gen).to(dt)
    v = torch.randn(Tk, Hkv, D, device="cuda", generator=gen).to(dt)
    dout = torch.randn(Tq, H, D, device="cuda", generator=gen).to(dt)
    layout = mf.varlen_layout(cu_q, cu_k, Tq, Tk, causal)
    return q, k, v, dout, layout, cu_q, cu_k, causal, dtype


def _varlen_classes(mf, torch, q, k, layout, causal):
    """The tile classes the 16-bit kernels read (None in f32), derived once
    by the kernel the forward's entry runs, as VarlenAttention keeps the
    forward's for its backward."""
    if q.dtype == torch.float32:
        return None
    return mf.varlen_tile_classes(layout, q.shape[0], k.shape[0], causal)


def _varlen_outputs(mf, q, k, v, dout, layout, causal, scale, cls):
    """As `_flash_outputs`, for the varlen kernels; the backward kernels
    read the tile classes `cls`."""
    out, lse = mf.varlen_fwd(q, k, v, layout, causal, scale)
    out_p, lse_p = mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(0, 1).contiguous()
    dq = mf.varlen_bwd_dq(q, k, v, layout, dout, lse_p, delta, causal, scale,
                          cls)
    dq_p = mf.varlen_bwd_dq_plain(q, k, v, layout, dout, lse_p, delta, causal,
                                  scale)
    dk, dv = mf.varlen_bwd_dkv(q, k, v, layout, dout, lse_p, delta, causal,
                               scale, cls)
    dk_p, dv_p = mf.varlen_bwd_dkv_plain(q, k, v, layout, dout, lse_p, delta,
                                         causal, scale)
    return ({"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
            {"out": out_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
            delta)


def _varlen_class_violations(torch, mf, name, layout, Tq, Tk, causal):
    """The tile classes the card derives (`varlen_classes_kernel`, which
    the bf16 forward launches before it) against their plain version:
    equal, tile for tile."""
    got = mf.varlen_tile_classes(layout, Tq, Tk, causal)
    ref = mf.varlen_tile_classes_plain(layout, Tq, Tk, causal)
    wrong = int((got != ref).sum())
    return [f"varlen {name}: {wrong} of {ref.numel()} tile classes differ "
            "from the plain version's"] if wrong else []


def _second_half_keys(torch, layout, Tk):
    """bool [Tk]: the keys in the second 64 of a 128-key tile whose 64-key
    tile is seen by q rows past the first 64 keys' last q step (a document
    that starts there): the dK/dV kernel reaches those rows only through
    the CTA-wide `q_tiles(p, k0, 128)`."""
    end = (layout.krange[1].long() + 63) // 64  # each 64-key tile's q-step end
    t = torch.arange(end.numel(), device=end.device)
    late = (t % 2 == 1) & (end > end[(t - 1).clamp_min(0)])
    return late.repeat_interleave(64)[:Tk]


def check_varlen(card, torch):
    """Varlen forward, dq and dk/dv kernels against their plain versions on
    the same inputs (the backward kernels get the plain forward's LSE and
    delta), held with check_flash's limits: a pack of 8192 tokens in 8
    documents at the LLaMA-7B head shape (32 query heads over 8 kv heads of
    128, causal, bf16), non-causal documents at T = 1000 (not a multiple
    of the 64-row tile) in f32, causal cross attention with q lengths !=
    k lengths and GQA, an empty k segment in f32 and in bf16 (its rows:
    zeros, zero dq) and a pack of 27 tokens (one tile). The bf16 forward
    runs the sm90 kernel on the tile classes its entry derives first
    (`varlen_classes_kernel`); those classes are held equal to
    `varlen_tile_classes_plain` in every case, and the classes kernel's
    time alone is printed beside the forward's row (`tile_classes_ms`,
    part of `ms`). The operation bound counts the pairs the segments
    keep. Library: torch scaled_dot_product_attention on the main
    case with k and v expanded to the query heads and the keep-mask as a
    bool [T, T] attn_mask (block-diagonal, causal within each block).
    The bf16 dq and dk/dv run the sm90 backward on the forward's classes;
    the keys whose document starts in the second 64 of a 128-key dK/dV
    tile (`_second_half_keys`) are held on their own too, and
    cross_causal_gqa must have some."""
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {d: {"fwd": 0.0, "dq": 0.0, "dkv": 0.0} for d in (False, True)}
    main, failures, lib_path = {}, [], None
    for name, (_, _, H, Hkv, D, _, _) in VARLEN_CASES.items():
        q, k, v, dout, layout, cu_q, cu_k, causal, dtype = _varlen_inputs(
            torch, gen, name)
        scale = D ** -0.5
        cls = _varlen_classes(mf, torch, q, k, layout, causal)
        got, plain, delta = _varlen_outputs(mf, q, k, v, dout, layout, causal,
                                            scale, cls)
        torch.cuda.synchronize()
        errs = _flash_errs(got, plain)
        failures += [f"varlen {name}: {b}"
                     for b in _flash_violations(errs, dtype)]
        empty = torch.isinf(plain["lse"]).transpose(0, 1)  # [Tq, H]
        n_empty = int(empty.sum())
        if n_empty and (got["out"][empty].abs().max().item() != 0
                        or got["dq"][empty].abs().max().item() != 0):
            failures.append(f"varlen {name}: a row that keeps no key is not "
                            "zero")
        Tq, Tk = q.shape[0], k.shape[0]
        failures += _varlen_class_violations(torch, mf, name, layout, Tq, Tk,
                                             causal)
        late = _second_half_keys(torch, layout, Tk)
        n_late = int(late.sum())
        if n_late:
            late_errs = {w: _flash_err(got[w][late], plain[w][late])
                         for w in ("dk", "dv")}
            say(card, f"varlen {name} second-half keys " + json.dumps(
                {"keys": n_late, "errs": late_errs}))
            failures += [f"varlen {name} second-half keys: {b}"
                         for b in _flash_violations(late_errs, dtype)]
        elif name.startswith("cross_causal_gqa"):
            failures.append(f"varlen {name}: no document starts in "
                            "the second half of a 128-key tile")
        keep = mf.varlen_keep(layout, Tq, causal)
        pairs = int(keep.sum()) * H
        es = q.element_size()
        qo, kv = Tq * H * D * es, Tk * Hkv * D * es
        stats = H * Tq * 4
        lay = sum(t.numel() * 4 for t in layout)
        reps, inner = (5, 3) if pairs * D > 1e10 else (10, 10)
        lse_p = plain["lse"]
        rows = {
            "fwd": (lambda: mf.varlen_fwd(q, k, v, layout, causal, scale),
                    lambda: mf.varlen_fwd_plain(q, k, v, layout, causal, scale),
                    2 * qo + 2 * kv + stats + lay, 4 * pairs * D,
                    ("out", "lse")),
            "dq": (lambda: mf.varlen_bwd_dq(q, k, v, layout, dout, lse_p,
                                            delta, causal, scale, cls),
                   lambda: mf.varlen_bwd_dq_plain(q, k, v, layout, dout, lse_p,
                                                  delta, causal, scale),
                   3 * qo + 2 * kv + 2 * stats + lay, 6 * pairs * D, ("dq",)),
            "dkv": (lambda: mf.varlen_bwd_dkv(q, k, v, layout, dout, lse_p,
                                              delta, causal, scale, cls),
                    lambda: mf.varlen_bwd_dkv_plain(q, k, v, layout, dout,
                                                    lse_p, delta, causal,
                                                    scale),
                    2 * qo + 2 * kv + 2 * stats + lay + 2 * Tk * Hkv * D * 4,
                    8 * pairs * D, ("dk", "dv")),
        }
        lib = {}
        if name in ("path", "path_f16"):
            lib = library_sdpa(torch, q[None], k[None], v[None], dout[None],
                               causal, keep[None, None])
            lib_path = lib_path or lib
        shapes = dict(Tq=Tq, Tk=Tk, documents=cu_q.numel() - 1,
                      lengths_q=np.diff(cu_q.tolist()).tolist()
                      if cu_q.numel() <= 9 else None,
                      H=H, Hkv=Hkv, D=D, causal=causal, dtype=dtype,
                      pairs=pairs, rows_without_keys=n_empty,
                      second_half_keys=n_late)
        for kernel, (fn_k, fn_p, nbytes, ops, outs) in rows.items():
            bnd, by = bound_ms(nbytes, ops, dtype)
            err = max(errs[o][0] if o != "lse" else errs[o] for o in outs)
            row = dict(kernel=kernel, case=name, **shapes, max_abs_err=err,
                       row_rel_err=max(errs[o][1] for o in outs if o != "lse"),
                       frobenius_rel_err=max(errs[o][2] for o in outs
                                             if o != "lse"),
                       tol=FLASH_TOL[dtype], frobenius_tol=FLASH_FROB_TOL[dtype],
                       ms=time_ms(fn_k, reps=reps, inner=inner),
                       eager_ms=eager_ms(fn_k, reps=reps, inner=inner),
                       plain_ms=time_ms(fn_p, reps=3, inner=2),
                       bound_ms=bnd, bound_by=by, library_ms=lib.get(kernel))
            if kernel == "fwd" and dtype != "float32":
                # the classes kernel's share of `ms`
                row["tile_classes_ms"] = time_ms(
                    lambda: mf.varlen_tile_classes(layout, Tq, Tk, causal),
                    reps=reps, inner=inner)
            say(card, "varlen " + json.dumps(row))
            w = worst[dtype == "float16"]
            w[kernel] = max(w[kernel], err)
            if name in ("path", "path_f16"):
                main.setdefault(name, {})[kernel] = row
        del q, k, v, dout, got, plain, keep
        torch.cuda.empty_cache()
    say(card, "varlen library_ms: torch scaled_dot_product_attention on k and "
              "v expanded to the query heads with the segments' keep-mask as "
              "a bool [T, T] attn_mask; its backward as in flash_attention, "
              "one figure for dq and dk/dv; measured three times: "
              + json.dumps(lib_path["bwd_runs"]))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst[False], "main": main["path"],
            "worst_f16": worst[True], "main_f16": main["path_f16"]}


# Faults planted in copies of csrc/ (phase 2b), name: (the source file, the
# text that anchors the fault, the text replaced at its first occurrence
# after the anchor, the replacement, the case that must catch it: "flash
# <FLASH_CASES name>", "varlen <VARLEN_CASES name>", "grouped_gemm
# <GG_CASES name>", "dense_decode <DENSE_CASES name>" (bf16), "norm
# <R>x<N> <kind> <dtype>" (a NORM_CASES shape, offset 0), "norm_dx <R>x<N>
# <kind> <dtype>" (a NORM_DX_CASES shape, mean 0.5, on the 16-byte line)
# or a FLASHMASK_CASES name). They follow the kernels'
# code: a change there that moves the replaced text must move these with
# it. The `Varlen` policy's faults reach every kernel that reads what they
# change: `first_kv_tile` only the f32 kernels (so its case is f32),
# `keep`, `tile_class` and the 128-row `kv_tiles` the sm90 forward and
# the sm90 dQ and dK/dV (or dQ alone), `first_q_tile` and the CTA-wide
# `q_tiles(p, k0, bn)` the sm90 dK/dV.
KERNEL_FAULTS = {
    "fwd: q tiles past the first skip their last kv tile": (
        "flash_fwd_sm90.cuh", "flash_fwd_sm90_kernel(",
        "mask.kv_tiles(p, q0, kBM, kBN);",
        "mask.kv_tiles(p, q0, kBM, kBN) - (q0 > 0);", "flash path"),
    "fwd: rows past the first q tile normalised 1% off": (
        "flash_fwd_sm90.cuh", "void consume(", "1.f / l;",
        "1.f / (l * (q0 > 0 ? 1.01f : 1.f));", "flash path"),
    "flashmask fwd: a partial tile treated as full": (
        "masked_flash.cu", "tile_class(", "return c;",
        "return c == kPartialTile ? kFullTile : c;", "causal_n1_docs"),
    "flash bwd: first_q_tile without the bottom-right offset": (
        "flash_attention.cu", "struct CausalBias",
        "const int first = k0 - (p.Skv - p.Sq);", "const int first = k0;",
        "flash ragged_sq_lt_skv_g2_d64"),
    "flash bwd dk/dv: the key bias on partial tiles only": (
        "flash_bwd_sm90.cuh", "void dkv_consume(",
        "if (partial || mask.has_bias()) {", "if (partial) {",
        "flash key_bias_padded_row"),
    "flashmask: the end bound of causal n = 2 ignored": (
        "masked_flash.cu", "struct FlashMask", "(row >= k.i0 && row < k.i1)",
        "(row >= k.i0)", "causal_n2_per_head_s1000_gqa"),
    "flashmask f32: a tile whose keep-mask is partly empty skipped": (
        "flash_tiles.cuh", "bool any_kept(", "__syncthreads_or(mine) != 0",
        "__syncthreads_and(mine) != 0", "empty_rows_f32_d64"),
    "flashmask: every query head reads mask head 0": (
        "masked_flash.cu", "struct FlashMask", "h / (p.H / Hm)", "0 * h",
        "causal_n2_per_head_s1000_gqa"),
    "flashmask bwd dq: q tiles past the first skip their last kv tile": (
        "flash_bwd_sm90.cuh", "flash_bwd_dq_sm90_kernel(",
        "mask.kv_tiles(p, q0, kBM, kBN);",
        "mask.kv_tiles(p, q0, kBM, kBN) - (q0 > 0);", "path"),
    "flashmask bwd dk/dv: a partial tile treated as full": (
        "flash_bwd_sm90.cuh", "void dkv_consume(",
        "const bool partial = cls == kPartialTile;",
        "const bool partial = false;", "causal_n1_docs"),
    "flashmask bwd dk/dv: the group loop stops one query head short": (
        "flash_bwd_sm90.cuh", "flash_bwd_dkv_sm90_kernel(", "h1 = h0 + p.g;",
        "h1 = h0 + p.g - 1;", "causal_n2_per_head_s1000_gqa"),
    "varlen: each q tile's first kv tile skipped": (
        "varlen_flash.cu", "struct Varlen", "return qrange[q0 / kTile] / kTile;",
        "return qrange[q0 / kTile] / kTile + 1;", "varlen full_docs_t1000_f32_d64"),
    "varlen: the segment test's upper bound dropped": (
        "varlen_flash.cu", "struct Varlen", "row >= k.lo && row < k.hi",
        "row >= k.lo", "varlen path"),
    "varlen fwd: a partial tile read as full": (
        "varlen_flash.cu", "int tile_class(", "return c;",
        "return c == kPartialTile ? kFullTile : c;", "varlen path"),
    "varlen classes: the last kv tile full past Tk": (
        "varlen_flash.cu", "varlen_classes_kernel(",
        "bool full = lo_max <= r0 && r1 <= hi_min && !pad;",
        "bool full = lo_max <= r0 && r1 <= hi_min;", "varlen cross_causal_gqa"),
    "varlen fwd: the loop ends one kv tile short": (
        "varlen_flash.cu", "int kv_tiles(const Problem&, int q0, int bm, int bn)",
        "return (end + bn - 1) / bn;", "return (end + bn - 1) / bn - 1;",
        "varlen path"),
    "varlen dk/dv: a CTA's q steps end at its first 64 keys' range": (
        "varlen_flash.cu", "int q_tiles(const Problem&, int k0, int bn)",
        "t < min((k0 + bn) / kTile, n_kt);", "t < min(k0 / kTile + 1, n_kt);",
        "varlen cross_causal_gqa"),
    "varlen dk/dv: each key tile's first q step one step late": (
        "varlen_flash.cu", "int first_q_tile(", "return krange[k0 / kTile] / kTile;",
        "return krange[k0 / kTile] / kTile + 1;", "varlen path"),
    "norm fwd: the cross-warp sum drops the group's last warp": (
        "fused_norm.cu", "float group_sum(", "w < gw;", "w < gw - 1;",
        "norm 8192x2048 ln float32"),
    "norm fwd: the scalar tail skipped": (
        "fused_norm.cu", "the scalar tail",
        "v[j][e] = c0 + e < n ? ptt::to_f32(xr[c0 + e]) : 0.f;",
        "v[j][e] = 0.f;", "norm 37x1031 ln float32"),
    "norm dx: the paired exchange drops the group's last warp": (
        "fused_norm.cu", "float2 group_sum2(", "w < gw;", "w < gw - 1;",
        "norm_dx 8192x2048 ln float32"),
    "norm dx: the prefetched row's dy taken from the current row": (
        "fused_norm.cu", "the next row's loads go out before",
        "load_dx_row<T, kLN>(x, dy, rstd_in, mean_in, r + stride",
        "load_dx_row<T, kLN>(x, dy - stride * n, rstd_in, mean_in, r + stride",
        "norm_dx 8192x4096 rms float32"),
    "norm dx: the scalar tail skipped": (
        "fused_norm.cu", "void load_dx_row(", "const bool in = c0 + e < n;",
        "const bool in = false;", "norm_dx 37x1031 ln float32"),
    "grouped_gemm: a partly live tile treated as dead": (
        "grouped_gemm_sm90.cuh", "bool unit_live(", "return sizes[g] > off;",
        "return sizes[g] >= off + kGgUnit;", "grouped_gemm partial_tiles"),
    "grouped_gemm: a tile's second 64-row unit takes the first one's liveness": (
        "grouped_gemm_sm90.cuh", "GgTile gg_tile(",
        "unit_live(p.sizes, x.g, x.r0 + kGgUnit)", "unit_live(p.sizes, x.g, x.r0)",
        "grouped_gemm partial_tiles"),
    "dense decode: the combine drops a chunk's rescale exp(m_i - M)": (
        "dense_decode.cu", "float chunk_weight(", "return expf(m - top);",
        "return 1.f;", "dense_decode mmha_g1"),
    "dense decode: a chunk's valid tokens counted to S_max, not the length": (
        "dense_decode.cu", "decode_split_kernel(",
        "const int nv = min(chunk, length - c0);",
        "const int nv = min(chunk, s_max - c0);", "dense_decode odd_s_max_d64"),
    "paged decode: the combine drops a chunk's rescale exp(m_i - M)": (
        "decode_attention.cu", "float chunk_weight(", "return expf(m - top);",
        "return 1.f;", "paged_decode path_g1"),
    "paged decode: a live chunk of -1 pages exits without arriving": (
        "decode_attention.cu", "paged_split_kernel(",
        "if (loaded) sm90::mbar_wait(&bars[0], phase);",
        "if (!loaded) return;\n    sm90::mbar_wait(&bars[0], phase);",
        "paged_decode hole_chunk"),
    "paged decode: the last chunk to arrive leaves its counter set": (
        "decode_attention.cu", "paged_split_kernel(",
        "if (tid == 0) *arrived = 0;", "", "paged_decode path_g1"),
    "paged decode int8: probabilities take the chunk's first page's v_scale": (
        "decode_attention.cu", "paged_split_kernel(",
        "const float vsc = kQ8 ? vs_s[s] : 1.f;",
        "const float vsc = kQ8 ? vs_s[0] : 1.f;", "paged_decode_q8 path_g1"),
    "rope: the neox second half read one vector late": (
        "fused_rope.cu", "void load_head(", "(kIL ? V : a.half)",
        "(kIL ? V : a.half + V)", "rope train_neox"),
    "rope: the table row taken as 0 with a table per row": (
        "fused_rope.cu", "rope_kernel(const RopeArgs a)",
        "a.table_b > 1 ? r : r % a.S", "r % a.S", "rope decode_per_row"),
    "rope: the head chunk's start off by one where it crosses from q into k": (
        "fused_rope.cu", "the chunk crosses into the next tensor", "h = 0;",
        "h = 1;", "rope train_neox"),
    "fwd 192: P V drops the third 64-column panel": (
        "flash_fwd_sm90.cuh", "// 16 keys: 2048 bytes of V rows",
        "c < L::kPanels;", "c < (L::kPanels > 2 ? 2 : L::kPanels);",
        "flash unet_self_d160"),
    "fwd and dq 192: the second 64-key half of each kv tile skipped": (
        "flash_fwd_sm90.cuh", "int sub_class(", "return kSkipTile;",
        "return kSkipTile;\n  if (u % L::kHalves) return kSkipTile;",
        "flash unet_cross_d160"),
    "dk/dv 192: the dK half's CTAs compute dV alone": (
        "flash_bwd_sm90.cuh", "flash_bwd_dkv_sm90_kernel(",
        "kParts == 2 && blockIdx.x % 2 == 1;", "kParts == 2;",
        "flash unet_self_d160"),
    # the f16 instantiations: an f16 operand read by a bf16 instruction,
    # and P packed to the other 16-bit type (both compile and run)
    "f16: S = Q K^T of f16 operands on the bf16 wgmma": (
        "sm90.cuh", "void wgmma_ss_n128(", 'PTT_SS_N128("f16", "0");',
        'PTT_SS_N128("bf16", "0");', "flash path_f16"),
    "f16: the register-A products (P V, dS K) on the bf16 wgmma": (
        "sm90.cuh", "void wgmma_rs_n64_t(", 'PTT_RS_N64_T("f16");',
        'PTT_RS_N64_T("bf16");', "flash gqa_g4_f16"),
    "f16 fwd: P packed to bf16": (
        "flash_fwd_sm90.cuh", "void consume(", "pa[kk][0] = pack2<T>(",
        "pa[kk][0] = pack2<bf16>(", "flash path_f16"),
    "f16 grouped_gemm: the forward's transposed B on the bf16 wgmma": (
        "sm90.cuh", "void wgmma_ss_n128_t(", 'PTT_SS_N128("f16", "1");',
        'PTT_SS_N128("bf16", "1");', "grouped_gemm partial_tiles_f16"),
}


def _fault_violations(torch, case):
    """Phase 2's violations at a fault's case ("flash <FLASH_CASES name>",
    "varlen <VARLEN_CASES name>", "grouped_gemm <GG_CASES name>",
    "dense_decode <DENSE_CASES name>", "paged_decode <PAGED_FULL name>" or
    "paged_decode_q8 <PAGED_Q8 name>" in bf16, "norm <R>x<N> <kind>
    <dtype>", "norm_dx <R>x<N> <kind> <dtype>", "rope <ROPE_CASES name>",
    or a FLASHMASK_CASES name), run on
    the library load_library() holds."""
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_gemm as gg
    from paddle_tpu_torch.ops import masked_flash as mf

    kind, _, name = case.partition(" ")
    if kind == "rope":
        from paddle_tpu_torch.ops import fused_rope as fr

        gen = torch.Generator(device="cuda").manual_seed(8)
        return _rope_violations(torch, fr, name,
                                *_rope_inputs(torch, gen, name))[1]
    if kind in ("paged_decode", "paged_decode_q8"):
        da._ARRIVALS.clear()  # counters a fault left set go with it
        args = _paged_inputs(torch, name, "bfloat16", kind == "paged_decode_q8")[0]
        bad = _paged_violations(torch, da, args, "bfloat16")[0]
        da._ARRIVALS.clear()
        return bad
    if kind == "norm":
        from paddle_tpu_torch.ops import fused_norm as fn

        shape, norm_kind, dtype = name.split()
        R, N = (int(s) for s in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, w, bias = _norm_inputs(torch, gen, R, N, norm_kind, dtype)
        return _norm_errors(fn, torch, x, w, bias, norm_kind, dtype)[2]
    if kind == "norm_dx":
        from paddle_tpu_torch.ops import fused_norm as fn

        shape, norm_kind, dtype = name.split()
        R, N = (int(s) for s in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(2)
        x, w, _, dy, rstd, mu = _norm_dx_inputs(torch, fn, gen, R, N,
                                                norm_kind, dtype)
        return _norm_dx_violations(fn, torch, x, w, dy, rstd, mu, norm_kind,
                                   dtype)[1]
    if kind == "flash":
        B, Sq, Skv, H, Hkv, D, causal, bias, dtype = FLASH_CASES[name]
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, dout, kb, _ = _flash_inputs(
            torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype,
            FLASH_LAYOUTS.get(name, "contiguous"))
        got, plain, _ = _flash_outputs(fa, q, k, v, dout, kb, causal,
                                       D ** -0.5)
    elif kind == "varlen":
        gen = torch.Generator(device="cuda").manual_seed(13)
        q, k, v, dout, layout, _, _, causal, dtype = _varlen_inputs(
            torch, gen, name)
        got, plain, _ = _varlen_outputs(
            mf, q, k, v, dout, layout, causal, q.shape[-1] ** -0.5,
            _varlen_classes(mf, torch, q, k, layout, causal))
        return _varlen_class_violations(
            torch, mf, name, layout, q.shape[0], k.shape[0], causal
        ) + _flash_violations(_flash_errs(got, plain), dtype)
    elif kind == "grouped_gemm":
        gen = torch.Generator(device="cuda").manual_seed(11)
        lhs, rhs, sz = _gg_inputs(torch, gen, name, None)
        trans = GG_CASES[name][5]
        out = gg.grouped_gemm(lhs, rhs, sz, trans)
        ref = gg.grouped_matmul_plain(lhs, rhs, sz, gg.BM, trans)
        return _gg_violations(gg, torch, name, out, ref, sz)[0]
    elif kind == "dense_decode":
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, kc, vc, lens = _dense_inputs(torch, gen, name, "bfloat16")
        out = da.dense_decode_attention(q, kc, vc, lens)
        ref = da.dense_decode_attention_plain(q, kc, vc, lens, q.shape[-1] ** -0.5)
        return _dense_violations(torch, name, "bfloat16", out, ref)[0]
    else:
        gen = torch.Generator(device="cuda").manual_seed(9)
        q, k, v, dout, idx, causal, dtype = _flashmask_inputs(torch, gen, case)
        got, plain, _ = _flashmask_outputs(
            mf, q, k, v, dout, idx, causal, q.shape[-1] ** -0.5,
            _flashmask_classes(mf, torch, q, idx, causal))
    return _flash_violations(_flash_errs(got, plain), dtype)


def _fault_source(case):
    """The source whose kernels a fault's case launches, where a header is
    shared by several: flash, varlen or flashmask attention's, or the
    grouped GEMM's (sm90.cuh reaches all four)."""
    kind = case.partition(" ")[0]
    sources = {"flash": "flash_attention.cu", "varlen": "varlen_flash.cu",
               "grouped_gemm": "grouped_gemm.cu"}
    if kind in sources:
        return sources[kind]
    return "masked_flash.cu" if case in FLASHMASK_CASES else None


def _route_fault(csrc, fname, source):
    """Let only `source` see the fault planted in the header `fname` of the
    copy csrc/: the faulty text moves to `fault_<fname>`, every header
    that includes it (directly or not) gets a `fault_` copy including the
    faulty ones, `source` includes those, and `fname` is restored. The
    other sources hash as before, so their cached objects are reused
    instead of compiled again with a fault their cases never run."""
    import shutil

    from paddle_tpu_torch.ops import _build

    heads = {p.name: set(_build._INCLUDE.findall(p.read_text()))
             for p in csrc.glob("*.cuh")}
    reach, grew = {fname}, True
    while grew:
        grew = False
        for h, deps in heads.items():
            if h not in reach and deps & reach:
                reach.add(h)
                grew = True

    def rerouted(text):
        for h in reach:
            text = text.replace(f'#include "{h}"', f'#include "fault_{h}"')
        return text

    for h in reach:
        (csrc / f"fault_{h}").write_text(rerouted((csrc / h).read_text()))
    shutil.copyfile(_build.CSRC / fname, csrc / fname)
    (csrc / source).write_text(rerouted((csrc / source).read_text()))


_DTYPE_CODE = {"float32": 0, "bfloat16": 1, "float16": 2}


def _fault_flags(case):
    """nvcc flags that keep, in a fault's faulty source, only what its case
    launches (csrc/common.cuh's PTT_ONLY_DTYPE / PTT_ONLY_WIDTH): the
    attention kernels at the case's dtype and head-dim tile width, the
    grouped GEMM at its dtype; none for the other kernels, which build in
    seconds."""
    kind, _, name = case.partition(" ")
    if kind == "grouped_gemm":
        return [f"-DPTT_ONLY_DTYPE={_DTYPE_CODE[GG_CASES[name][6]]}"]
    if kind == "flash":
        D, dtype = FLASH_CASES[name][5], FLASH_CASES[name][8]
    elif kind == "varlen":
        D, dtype = VARLEN_CASES[name][4], VARLEN_CASES[name][6]
    elif case in FLASHMASK_CASES:
        D, dtype = FLASHMASK_CASES[case][5], FLASHMASK_CASES[case][9]
    else:
        return []
    width = 64 if D <= 64 else 128 if D <= 128 else 192
    return [f"-DPTT_ONLY_DTYPE={_DTYPE_CODE[dtype]}",
            f"-DPTT_ONLY_WIDTH={width}"]


def planted_kernel_faults(card, torch):
    """The attention, grouped-GEMM, dense-decode and norm limits must fail
    faulty kernels: for each fault of KERNEL_FAULTS, the kernels are built again
    from a copy of csrc/ (in a temporary directory, all builds in parallel)
    with the fault planted, and held at its case against the plain versions
    with phase 2's limits. A fault in a header that several attention
    sources share is seen by its case's source alone (`_route_fault`), and
    the faulty source is built only for the instantiations its case
    launches (`_fault_flags`); the other sources reuse the sound build's
    objects."""
    import pathlib
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da

    sound = _build.load_library()
    passed = []
    with tempfile.TemporaryDirectory() as tmp:
        csrcs, flags = {}, {}
        for i, (fault, (fname, anchor, old, new, _)) in enumerate(
                KERNEL_FAULTS.items()):
            csrc = pathlib.Path(tmp) / str(i) / "csrc"
            shutil.copytree(_build.CSRC, csrc)
            src = csrc / fname
            text = src.read_text()
            at = text.index(old, text.index(anchor))
            src.write_text(text[:at] + new + text[at + len(old):])
            case = KERNEL_FAULTS[fault][4]
            source = _fault_source(case)
            if fname.endswith(".cuh") and source:
                _route_fault(csrc, fname, source)
            faulty = source if fname.endswith(".cuh") else fname
            csrcs[fault] = csrc
            flags[fault] = {faulty: _fault_flags(case)} if faulty else {}
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(csrcs)) as pool:
            libs = dict(zip(csrcs, pool.map(
                lambda f: _build.build_library(
                    csrcs[f], csrcs[f].parent / "build",
                    _build.BUILD_DIR / "obj", source_flags=flags[f]),
                csrcs)))
        say(card, f"planted kernel faults: {len(libs)} builds in "
                  f"{time.perf_counter() - t0:.2f} s")
        try:
            for fault, lib in libs.items():
                # the wrappers launch from the library load_library() holds
                _build._LIB = _build.open_library(lib)
                case = KERNEL_FAULTS[fault][4]
                bad = _fault_violations(torch, case)
                say(card, "planted kernel fault " + json.dumps(
                    {"fault": fault, "case": case, "failed": bool(bad),
                     "violations": bad}))
                if not bad:
                    passed.append(fault)
                torch.cuda.empty_cache()
        finally:
            _build._LIB = sound
            da._ARRIVALS.clear()
    if passed:
        raise AssertionError(f"the kernel limits pass faulty kernels: {passed}")


# --------------------------------------------------------------------------- #
# phase 3: serve gpt3_1p3b
# --------------------------------------------------------------------------- #


def serving_workload(vocab_size, S, n_req):
    """The serving benchmark's request mix (bench.py _serving_workload):
    every third prompt extends one long common prefix, lengths staggered,
    every fourth request sampled at T=0.7, the rest greedy."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab_size, S // 4).astype(np.int32)
    out = []
    for i in range(n_req):
        tail = rng.integers(1, vocab_size, 2 + i % (S // 8)).astype(np.int32)
        prompt = (np.concatenate([shared, tail]) if i % 3 == 0
                  else rng.integers(1, vocab_size, 4 + i % (S // 4)).astype(np.int32))
        out.append((prompt, 0.7 if i % 4 == 0 else 0.0))
    return out


def serve(card, torch, which="gpt3_1p3b"):
    """`which` ("gpt3_1p3b" or "llama_7b") at full width and depth in bf16,
    random weights from seed 0, through inference.create_serving_engine
    (paged, 16 rows, 512 tokens, page size 32) over 12 requests of the
    serving mix, 16 new tokens each. Counters zeroed just before and read
    just after: every norm ((prefills + ticks) x (2L + 1)), every decode
    attention (ticks x L) and, with RoPE, every rotation ((prefills +
    ticks) x L) went through its kernel, and no other kernel ran (prefill
    attention is the composite). For llama_7b, model.generate on one greedy
    prompt of the mix is held against the engine: in bf16 by the first
    decode step's logits (`generate_against_engine`), in f32 at full depth
    by its tokens (`generate_f32_full_depth`). A profile of five
    full-batch decode ticks comes between the two."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    cfg = getattr(models, which)()
    B, S, ps, n_req, max_new = 16, 512, 32, 12, 16
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(card, f"serve: {which} bf16, {n_params} parameters, "
              f"{_state_bytes(model)} bytes, built in "
              f"{time.perf_counter() - t0:.3f} s")

    # warm-up engine (cuBLAS handles, allocator): one short request
    warm = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                 page_size=ps)
    warm.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    warm.run()
    del warm

    eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                page_size=ps, seed=0)
    workload = serving_workload(cfg.vocab_size, S, n_req)
    for prompt, temp in workload:
        eng.add_request(prompt, max_new_tokens=max_new, temperature=temp)
    torch.cuda.synchronize()
    _zero_counters()
    since = _registry().snapshot()
    t_start = time.perf_counter()
    peak_used = 0
    steps = []
    while eng.has_work():
        t = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - t)
        peak_used = max(peak_used, eng.pool.pages_total - eng.pool.pages_free)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = _counters()

    done = eng.finished
    slo = _serving_delta(since, "paged")
    decode_ticks = slo["decode_ticks"]
    L = cfg.num_layers
    want = _expected(fused_norm=(n_req + decode_ticks) * (2 * L + 1),
                     paged_decode_attention=decode_ticks * L,
                     fused_rope=(n_req + decode_ticks) * L if cfg.use_rope
                     else 0)
    if len(done) != n_req or any(len(r.generated) != max_new for r in done):
        raise AssertionError(f"serve {which}: not every request finished with "
                             f"{max_new} tokens")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise AssertionError(f"serve {which}: non-finite logits")
    if launches != want:
        raise AssertionError(f"serve {which}: kernel launches {launches}, "
                             f"expected {want}")
    tokens = slo["tokens"]
    ttft = [r._t_first - r._t_arrival for r in done]
    line = {
        "model": which, "dtype": "bfloat16", "batch": B,
        "max_seq_len": S, "page_size": ps, "requests": len(done),
        "tokens": tokens, "seconds": total_s, "tokens_per_s": tokens / total_s,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "step_p99_s": float(np.percentile(steps, 99)),
        "decode_ticks": decode_ticks, "pages_total": eng.pool.pages_total,
        "kv_bytes_per_token": eng.pool.bytes_per_token,
        "peak_pages_used": peak_used, "page_allocs": eng.pool.allocs_total,
        "prefix_hits": slo["prefix_hits"],
        "preemptions": slo["preemptions"], "launches": launches,
    }
    say(card, f"serve {which} (smoke run, not a benchmark) " + json.dumps(line))
    del eng
    torch.cuda.empty_cache()
    if cfg.use_rope:
        by_prompt = {tuple(r.prompt): r.generated for r in done}
        prompt = next(p for p, temp in workload if temp == 0.0)
        generate_against_engine(card, torch, model, prompt, max_new,
                                by_prompt[tuple(prompt)], which,
                                create_serving_engine(model, max_batch_size=B,
                                                      max_seq_len=S,
                                                      page_size=ps, seed=0))
    profile_decode(card, torch, model, B, S, label=f"paged {which}",
                   page_size=ps)
    del model
    torch.cuda.empty_cache()
    if cfg.use_rope:
        generate_f32_full_depth(card, torch, cfg, prompt, max_new, which)
    return launches


def generate_f32_full_depth(card, torch, cfg, prompt, max_new, which):
    """`generate` against the paged engine at full width and depth in f32
    (TF32 off), where the two paths differ by f32 rounding only: on the
    greedy prompt of the serve phase the tokens must be identical (a
    one-row engine: its pages are 34 MB each in f32)."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    ps = 32
    S = -(-(len(prompt) + max_new + 1) // ps) * ps
    eng = create_serving_engine(model, max_batch_size=1, max_seq_len=S,
                                page_size=ps, seed=0)
    rid = eng.add_request(prompt, max_new_tokens=max_new)
    engine_tokens = {r.req_id: r.generated for r in eng.run()}[rid]
    del eng
    torch.cuda.empty_cache()
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    same = gen == engine_tokens
    say(card, f"generate {which} f32 " + json.dumps({
        "layers": cfg.num_layers, "prompt_tokens": len(prompt),
        "new_tokens": max_new, "tokens_identical_to_engine": same,
        "tokens": gen, "engine_tokens": engine_tokens}))
    del model
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"generate {which} f32: greedy tokens differ from "
                             "the paged engine's")


def generate_against_engine(card, torch, model, prompt, max_new, engine_tokens,
                            which, eng):
    """bf16 `generate` against the paged engine on one greedy prompt:
    the greedy tokens of both (printed: see BF16_DECODE_LOGIT_RTOL), and
    the logits of the first decode step, held to BF16_DECODE_LOGIT_RTOL of
    their norm: `eng` (a fresh engine; its decode step is [B, 1] whatever
    the live rows, so the prompt's row computes what it computed in the
    full mix) admits the prompt alone and runs one tick; generate's path
    (a prefill into f32 caches, one decode step at the prompt's length) is
    replayed through the model's own calls, fed the engine's first token
    so that both decode the same input."""
    t0 = time.perf_counter()
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    gen_s = time.perf_counter() - t0
    diverge = next((i for i, (a, b) in enumerate(zip(gen, engine_tokens))
                    if a != b), None)
    rid = eng.add_request(prompt, max_new_tokens=3)
    eng.step()  # admission (the first token) and the first decode tick
    row = next(i for i, r in enumerate(eng.active) if r is not None
               and r.req_id == rid)
    first = eng.active[row].generated[0]
    with torch.no_grad():
        ids = torch.as_tensor(prompt, device="cuda").long()[None]
        n = ids.shape[1]
        caches = model.init_kv_caches(1, n + max_new, dtype=torch.float32)
        model(ids, torch.arange(n, device="cuda")[None], caches, 0)
        logits, _ = model(torch.full((1, 1), first, device="cuda"),
                          torch.full((1, 1), n, device="cuda"), caches, n)
    lg, le = logits[0, -1].float(), eng.last_logits[row].float()
    rel = ((lg - le).norm() / le.norm()).item()

    def gap(x):
        top = x.topk(2).values
        return (top[0] - top[1]).item()

    say(card, f"generate {which} " + json.dumps({
        "prompt_tokens": len(prompt), "new_tokens": max_new,
        "seconds": gen_s, "tokens_identical_to_engine": diverge is None,
        "first_divergence": diverge, "tokens": gen,
        "engine_tokens": engine_tokens,
        "first_token_identical": gen[0] == first,
        "first_decode_logit_rel_diff": rel,
        "first_decode_max_abs_logit_diff": (lg - le).abs().max().item(),
        "rtol": BF16_DECODE_LOGIT_RTOL,
        "first_decode_top2_gap_generate": gap(lg),
        "first_decode_top2_gap_engine": gap(le)}))
    if not rel <= BF16_DECODE_LOGIT_RTOL:
        raise AssertionError(f"generate {which}: the first decode step differs "
                             "from the paged engine's beyond bf16 rounding")


def profile_decode(card, torch, model, B, S, ticks=5, label="paged",
                   **engine_kw):
    """Where a decode tick's time goes: torch.profiler over `ticks` decode
    ticks of a full batch (B live rows, 16-token prompts; the admission
    tick is left out) of the engine `create_serving_engine(model,
    **engine_kw)` builds. Prints the wall time per tick, the device-busy
    time per tick (the sum of device activity; one stream, so nothing
    overlaps), the kernels that take the most device time, and every
    kernel of the port (PORT_KERNEL) with its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import create_serving_engine

    eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                seed=0, **engine_kw)
    rng = np.random.default_rng(1)
    for _ in range(B):
        eng.add_request(rng.integers(1, model.config.vocab_size, 16),
                        max_new_tokens=ticks + 2)
    eng.step()  # admission (B prefills) and the first decode tick
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return e.self_device_time_total

    # device-side events only (kernels, copies); the CPU ops that launched
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    ranked = sorted(events, key=dev_us, reverse=True)

    def rows(evs):
        return [{"name": e.key[:80], "ms_per_tick": dev_us(e) / 1e3 / ticks,
                 "calls_per_tick": e.count / ticks} for e in evs]

    say(card, "decode tick profile " + json.dumps({
        "engine": label, "rows": B, "ticks": ticks, "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_busy_ms_per_tick": busy_us / 1e3 / ticks,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "top_device_kernels": rows(ranked[:8]),
        "port_kernels": rows(e for e in ranked if PORT_KERNEL.search(e.key))}))


# --------------------------------------------------------------------------- #
# phase 4: the same engine on the card (kernels) and on the CPU (plain)
# --------------------------------------------------------------------------- #


def hold(card, torch, which="gpt3_1p3b"):
    """The paged engine on the card (kernels) and on the CPU (plain
    versions): `which` ("gpt3_1p3b" or "llama_7b") at its full width and 2
    layers, f32 with TF32 off, four greedy requests of the mix; identical
    tokens and first-decode-tick logits within HOLD_LOGIT_TOL, and
    `generate` on the card (dense f32 caches, the flash kernel at Sq = 1)
    gives the card engine's tokens."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(getattr(models, which)(), num_layers=2)
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=1)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = [p for p, _ in serving_workload(cfg.vocab_size, 128, 4)]
    results = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        eng = create_serving_engine(model, max_batch_size=4, max_seq_len=128,
                                    page_size=32, seed=0)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.step()  # admission + the first decode tick
        first = eng.last_logits.float().cpu()
        by = {r.req_id: r for r in eng.run()}
        results[name] = (first, [by[i].generated for i in ids])
    diff = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    same = results["cuda"][1] == results["cpu"][1]
    # generate on the card (dense f32 caches, the flash kernel at Sq = 1)
    # gives the card engine's tokens
    gen = [gpu.generate(p[None], max_new_tokens=8, temperature=0.0)[
        0, len(p):].tolist() for p in prompts]
    gen_same = gen == results["cuda"][1]
    say(card, f"hold {which} " + json.dumps({
        "model": f"{which} width, 2 layers", "dtype": "float32",
        "first_tick_max_abs_logit_diff": diff, "tol": HOLD_LOGIT_TOL,
        "tokens_identical": same, "generate_tokens_identical": gen_same,
        "tokens_cuda": results["cuda"][1]}))
    if not (diff <= HOLD_LOGIT_TOL and same and gen_same):
        raise AssertionError(f"hold {which}: the card's engine disagrees with "
                             "the CPU's")


# --------------------------------------------------------------------------- #
# phase 4b-4e: the rest of serving (int8, dense engine, generate, MMHA)
# --------------------------------------------------------------------------- #


def _state_bytes(model):
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def _drain(torch, eng, workload, max_new):
    """Add the workload, drain the engine with the launch counters zeroed
    just before and read just after. Returns (finished requests, seconds,
    peak live rows, launches)."""
    for prompt, temp in workload:
        eng.add_request(prompt, max_new_tokens=max_new, temperature=temp)
    torch.cuda.synchronize()
    _zero_counters()
    since = _registry().snapshot()
    t0 = time.perf_counter()
    peak = 0
    steps = []
    while eng.has_work():
        t = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - t)
        peak = max(peak, sum(r is not None for r in eng.active))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counters()
    eng._smoke_window = (_serving_delta(since, eng.engine_label), steps)
    done = eng.finished
    if len(done) != len(workload) or any(len(r.generated) != max_new
                                         for r in done):
        raise AssertionError(f"{eng.engine_label}: not every request finished "
                             f"with {max_new} tokens")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise AssertionError(f"{eng.engine_label}: non-finite logits")
    return done, seconds, peak, launches


def _registry():
    from paddle_tpu_torch.observability.metrics import default_registry

    return default_registry()


def _serving_delta(since, lab):
    """The serving families' change since `since` (a registry snapshot) for
    engine label `lab`: the families are process-wide, so a phase reads its
    own window (tokens, requests, TTFT observations, decode ticks = the
    step-seconds observations, prefix hits, preemptions)."""
    d = _registry().delta(since)

    def get(name, engine=True):
        return int(d.get(f"{name}{{engine={lab}}}" if engine else name, 0))

    return {"tokens": get("serving_tokens_total"),
            "requests": get("serving_requests_total"),
            "ttft_count": get("serving_ttft_seconds"),
            "decode_ticks": get("serving_step_seconds"),
            "prefix_hits": get("serving_prefix_hits_total", False),
            "preemptions": get("serving_preemptions_total", False)}


def _serve_line(eng, done, seconds, peak, launches):
    """The phase's serving line: the registry's window of `_drain` and the
    per-tick host times it measured (the p99 is of those; the TTFT p50 of
    the requests' own first-token times)."""
    slo, steps = eng._smoke_window
    tokens = slo["tokens"]
    return {"requests": len(done), "tokens": tokens, "seconds": seconds,
            "tokens_per_s": tokens / seconds,
            "ttft_p50_s": float(np.percentile(
                [r._t_first - r._t_arrival for r in done], 50)),
            "step_p99_s": float(np.percentile(steps, 99)),
            "decode_ticks": slo["decode_ticks"],
            "peak_concurrency": peak, "launches": launches}


def serve_quant(card, torch):
    """bench.py's serving_quant A/B on gpt3_1p3b bf16 with the rung's own
    settings: B 16, S 512, page size 32, the serving mix of 64 requests, 32
    new tokens each, an equal KV budget of (B*S)/(2*ps) bf16 pages. Leg A:
    bf16 pages; leg B: kv_quant (int8 pages) and serve_w8 (int8 weights).
    Each leg must launch only its own paged decode kernel, ticks x 24
    times, and the norm kernel (requests + ticks) x 49 times; leg B must
    hold >= 1.9x the pages and no less peak concurrency."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.inference.paged import BlockPool
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    B, S, ps, n_req, max_new = 16, 512, 32, 64, 32
    L = cfg.num_layers
    budget = (B * S) // (2 * ps) * BlockPool.page_nbytes(
        L, cfg.kv_heads, cfg.head_dim, ps, torch.bfloat16)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    workload = serving_workload(cfg.vocab_size, S, n_req)
    legs = {}
    for leg, quant in (("A_bf16", False), ("B_int8_w8", True)):
        w_before = _state_bytes(model)
        eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                    page_size=ps, seed=0, kv_quant=quant,
                                    serve_w8=quant, kv_budget_bytes=budget)
        w_after = _state_bytes(model)
        done, seconds, peak, launches = _drain(torch, eng, workload, max_new)
        line = _serve_line(eng, done, seconds, peak, launches)
        ticks = line["decode_ticks"]
        decode = ("paged_decode_attention_q8" if quant
                  else "paged_decode_attention")
        want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                         **{decode: ticks * L})
        line.update({
            "kv_budget_bytes": budget, "pages_total": eng.pool.pages_total,
            "bytes_per_page": eng.pool.bytes_per_page,
            "kv_bytes_per_token": eng.pool.bytes_per_token,
            "preemptions": eng._smoke_window[0]["preemptions"],
            "weight_bytes_before": w_before, "weight_bytes_after": w_after,
            "kv_dtype": str(eng.pool.kv[0][0].dtype)})
        say(card, f"serve_quant leg {leg} (smoke run, not a benchmark) "
                  + json.dumps(line))
        if launches != want:
            raise AssertionError(f"serve_quant {leg}: kernel launches "
                                 f"{launches}, expected {want}")
        legs[leg] = line
        del eng
        torch.cuda.empty_cache()
        if quant:
            profile_decode(card, torch, model, B, S, label="paged int8+w8",
                           page_size=ps, kv_quant=True, serve_w8=True)
    total = {k: legs["A_bf16"]["launches"][k] + legs["B_int8_w8"]["launches"][k]
             for k in legs["A_bf16"]["launches"]}
    a, b = legs["A_bf16"], legs["B_int8_w8"]
    ratio = b["pages_total"] / a["pages_total"]
    say(card, "serve_quant A/B " + json.dumps({
        "pages_ratio": ratio, "peak_concurrency": [a["peak_concurrency"],
                                                   b["peak_concurrency"]],
        "tokens_per_s": [a["tokens_per_s"], b["tokens_per_s"]]}))
    if not (ratio >= 1.9 and b["peak_concurrency"] >= a["peak_concurrency"]):
        raise AssertionError("serve_quant: the int8 leg must hold >= 1.9x the "
                             "pages and no less peak concurrency")
    del model
    torch.cuda.empty_cache()
    return total


def _teacher_forced_margins(torch, model, prompt, tokens, dtype="bfloat16"):
    """`model.generate`'s greedy steps fed `tokens` instead of its own
    picks (its calls: a prefill into f32 caches, then one decode step a
    token): per step, how far tokens[i]'s logit lies below the top one, in
    steps of `dtype` at the top logit, and whether that is within
    BF16_TIE_ULPS (bf16) or FP16_TIE_ULPS (f16)."""
    bits, tie, key = ((7, BF16_TIE_ULPS, "bf16_steps_below_top")
                      if dtype == "bfloat16" else
                      (10, FP16_TIE_ULPS, "fp16_steps_below_top"))
    was_training = model.training
    model.eval()
    steps = []
    with torch.no_grad():
        ids = torch.as_tensor(prompt, device="cuda").long()[None]
        n = ids.shape[1]
        caches = model.init_kv_caches(1, n + len(tokens), dtype=torch.float32)
        logits, _ = model(ids, torch.arange(n, device="cuda")[None], caches,
                          0)
        for i, tok in enumerate(tokens):
            if i:
                logits, _ = model(
                    torch.full((1, 1), tokens[i - 1], device="cuda"),
                    torch.full((1, 1), n + i - 1, device="cuda"), caches,
                    n + i - 1)
            row = logits[0, -1].float()
            top = row.max().item()
            ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - bits)
            below = (top - row[tok].item()) / ulp
            steps.append({"token": tok, "argmax": int(row.argmax()),
                          key: below, "ok": below <= tie})
    model.train(was_training)
    return steps


def serve_dense(card, torch):
    """gpt3_1p3b bf16 through create_serving_engine(paged=False) (16 slots of
    512 tokens) over the 12-request mix of phase 3: every decode attention
    goes through the flash forward kernel at Sq = 1 (ticks x 24) and every
    LayerNorm through the norm kernel ((requests + ticks) x 49). Then
    model.generate runs one greedy prompt of the mix, and fed the engine's
    tokens it must rank each of them first or within a bf16 tie of first
    (BF16_TIE_ULPS), at every step."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    B, S, n_req, max_new = 16, 512, 12, 16
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    workload = serving_workload(cfg.vocab_size, S, n_req)
    eng = create_serving_engine(model, paged=False, max_batch_size=B,
                                max_seq_len=S, seed=0)
    done, seconds, peak, launches = _drain(torch, eng, workload, max_new)
    line = _serve_line(eng, done, seconds, peak, launches)
    ticks = line["decode_ticks"]
    want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                     flash_fwd=ticks * L)
    say(card, "serve_dense (smoke run, not a benchmark) " + json.dumps(line))
    if launches != want:
        raise AssertionError(f"serve_dense: kernel launches {launches}, "
                             f"expected {want}")
    by_prompt = {tuple(r.prompt): r.generated for r in done}
    prompt = next(p for p, temp in workload if temp == 0.0)
    t0 = time.perf_counter()
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    seconds = time.perf_counter() - t0
    engine_tokens = by_prompt[tuple(prompt)]
    steps = _teacher_forced_margins(torch, model, prompt, engine_tokens)
    say(card, "generate " + json.dumps({
        "prompt_tokens": len(prompt), "new_tokens": max_new,
        "seconds": seconds, "tokens_identical_to_engine": gen == engine_tokens,
        "tokens": gen, "engine_tokens": engine_tokens,
        "teacher_forced": steps}))
    bad = [i for i, st in enumerate(steps) if not st["ok"]]
    if len(engine_tokens) != max_new or bad:
        raise AssertionError(
            f"generate: fed the dense engine's {len(engine_tokens)} tokens, "
            f"steps {bad} rank the engine's token more than {BF16_TIE_ULPS} "
            "bf16 steps below the top logit")
    del eng
    profile_decode(card, torch, model, B, S, label="dense", paged=False)
    del model
    torch.cuda.empty_cache()
    return launches


def mmha(card, torch):
    """32 decode steps of incubate masked_multihead_attention at the MMHA
    shape (B 16, 16 heads of 128, S_max 2048, bf16, start lengths spread
    over 0..2016, no src_mask): every step must launch the dense-cache
    kernel pair once and agree with the plain version on the updated cache."""
    from paddle_tpu_torch.incubate.nn.functional import (
        masked_multihead_attention,
    )
    from paddle_tpu_torch.ops import decode_attention as da

    B, H, D, S, steps = 16, 16, 128, 2048, 32
    gen = torch.Generator(device="cuda").manual_seed(7)
    cache = torch.randn(2, B, H, S, D, device="cuda", generator=gen).bfloat16()
    bias = (0.1 * torch.randn(3 * H * D, device="cuda", generator=gen)).bfloat16()
    start = np.linspace(0, S - steps, B).astype(np.int32)
    xs = [torch.randn(B, 3 * H * D, device="cuda", generator=gen).bfloat16()
          for _ in range(steps)]
    torch.cuda.synchronize()
    _zero_counters()
    worst = 0.0
    t0 = time.perf_counter()
    for t, x in enumerate(xs):
        seq = torch.tensor(start + t, device="cuda")
        out, cache = masked_multihead_attention(x, cache, bias=bias,
                                                sequence_lengths=seq)
        q = (x + bias).reshape(B, 3, H, D)[:, 0]
        ref = da.dense_decode_attention_plain(q, cache[0], cache[1], seq + 1,
                                              D ** -0.5)
        worst = max(worst, (out.float() - ref.reshape(B, H * D).float())
                    .abs().max().item())
    torch.cuda.synchronize()
    launches = _counters()
    say(card, "mmha " + json.dumps({
        "B": B, "H": H, "D": D, "S_max": S, "steps": steps, "dtype": "bfloat16",
        "max_abs_err": worst, "tol": DECODE_TOL["bfloat16"],
        "seconds_with_checks": time.perf_counter() - t0,
        "launches": launches}))
    if launches != _expected(dense_decode_attention=steps):
        raise AssertionError(f"mmha: kernel launches {launches}, expected "
                             f"{steps} dense-cache launches and no other")
    if not worst <= DECODE_TOL["bfloat16"]:
        raise AssertionError(f"mmha: max|err| {worst} against the plain version")
    return launches


def quant_hold(card, torch):
    """gpt3_1p3b width at 2 layers in f32 (TF32 off) with kv_quant and
    serve_w8: the same greedy requests through the paged engine on the card
    (kernels) and on the CPU (plain versions). Tokens identical, first-tick
    logits within QUANT_HOLD_LOGIT_TOL, int8 payloads within 1 of each
    other (the card's and the CPU's K/V differ by rounding, which can move
    a value across a rounding boundary of the quantizer)."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=1)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = [p for p, _ in serving_workload(cfg.vocab_size, 128, 4)]
    res = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        eng = create_serving_engine(model, max_batch_size=4, max_seq_len=128,
                                    page_size=32, seed=0, kv_quant=True,
                                    serve_w8=True)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.step()
        first = eng.last_logits.float().cpu()
        by = {r.req_id: r for r in eng.run()}
        pay = [t.cpu() for layer in eng.pool.kv for t in layer]
        res[name] = (first, [by[i].generated for i in ids], pay,
                     eng.pool.scales)
    diff = (res["cuda"][0] - res["cpu"][0]).abs().max().item()
    same = res["cuda"][1] == res["cpu"][1]
    pay_diff = max((a.int() - b.int()).abs().max().item()
                   for a, b in zip(res["cuda"][2], res["cpu"][2]))
    n_diff = sum(int((a != b).sum()) for a, b in zip(res["cuda"][2],
                                                     res["cpu"][2]))
    scale_rel = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    .item() for sa, sb in zip(res["cuda"][3], res["cpu"][3])
                    for a, b in zip(sa, sb))
    say(card, "quant hold " + json.dumps({
        "model": "gpt3_1p3b width, 2 layers", "dtype": "float32",
        "kv_quant": True, "serve_w8": True,
        "first_tick_max_abs_logit_diff": diff, "tol": QUANT_HOLD_LOGIT_TOL,
        "tokens_identical": same, "max_int8_payload_diff": pay_diff,
        "int8_payloads_differing": n_diff, "max_scale_rel_diff": scale_rel,
        "tokens_cuda": res["cuda"][1]}))
    if not (diff <= QUANT_HOLD_LOGIT_TOL and same and pay_diff <= 1):
        raise AssertionError("quant hold: the card's int8 engine disagrees "
                             "with the CPU's")


# --------------------------------------------------------------------------- #
# phase 5: train gpt3_1p3b
# --------------------------------------------------------------------------- #

PEAK_BF16 = PEAK_OPS["bfloat16"]


def decoder_flops(cfg, batch, seq):
    """bench.py `_decoder_flops`: 6ND for forward and backward plus the
    attention term 12*L*h*seq per token, N = the non-embedding weights of
    `GPTConfig.num_params(include_embeddings=False)` plus one
    vocab x hidden table (bench.py counts one for the untied LLaMA head
    too)."""
    n_params = (cfg.num_params(include_embeddings=False)
                + cfg.vocab_size * cfg.hidden_size)
    tokens = batch * seq
    return (6.0 * n_params * tokens
            + 12.0 * cfg.num_layers * cfg.hidden_size * seq * tokens)


def _counters():
    """Every kernel's launch counter, by the name of the kernels line."""
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import fused_rope as fr
    from paddle_tpu_torch.ops import grouped_gemm as gg
    from paddle_tpu_torch.ops import masked_flash as mf

    return {"fused_norm": fn.LAUNCHES, "fused_norm_dx": fn.DX_LAUNCHES,
            "paged_decode_attention": da.LAUNCHES,
            "paged_decode_attention_q8": da.Q8_LAUNCHES,
            "dense_decode_attention": da.DENSE_LAUNCHES,
            "flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES, "fused_rope": fr.LAUNCHES,
            "flashmask_fwd": mf.FWD_LAUNCHES,
            "flashmask_bwd_dq": mf.DQ_LAUNCHES,
            "flashmask_bwd_dkv": mf.DKV_LAUNCHES,
            "grouped_gemm": gg.LAUNCHES, "varlen_fwd": mf.VL_FWD_LAUNCHES,
            "varlen_bwd_dq": mf.VL_DQ_LAUNCHES,
            "varlen_bwd_dkv": mf.VL_DKV_LAUNCHES}


def _zero_counters():
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import fused_rope as fr
    from paddle_tpu_torch.ops import grouped_gemm as gg
    from paddle_tpu_torch.ops import masked_flash as mf

    fn.LAUNCHES = fn.DX_LAUNCHES = 0
    da.LAUNCHES = da.Q8_LAUNCHES = da.DENSE_LAUNCHES = 0
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fr.LAUNCHES = 0
    mf.FWD_LAUNCHES = mf.DQ_LAUNCHES = mf.DKV_LAUNCHES = 0
    mf.VL_FWD_LAUNCHES = mf.VL_DQ_LAUNCHES = mf.VL_DKV_LAUNCHES = 0
    gg.LAUNCHES = 0


def _expected(**counts):
    """The launch counts a path must show: `counts`, and 0 for every other
    kernel."""
    return {**dict.fromkeys(_counters(), 0), **counts}


def _train_setup(torch, cfg, device, dtype, seed, recipe, **step_kw):
    """(model, criterion, step) of a training recipe: None (f32, the
    holds), "gpt3_1p3b" (bench.py's low-memory 1.3B recipe: amp.decorate
    O2, bf16 AdamW moments) or "llama_7bshape" (bench.py's LLaMA rung: f32
    parameters and moments, AMP O2 bf16, sharding stage 2 on one device);
    AdamW lr 1e-4, DistributedTrainStep without a mesh unless `step_kw`
    gives one (and its sharding stage and offload)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed)
    if recipe == "gpt3_1p3b":
        amp.decorate(model, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16" if recipe == "gpt3_1p3b" else None)
    kw = dict(mesh=None, sharding_stage=2 if recipe == "llama_7bshape"
              else None)
    kw.update(step_kw)
    step = DistributedTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                                amp_level="O2" if recipe else None,
                                amp_dtype="bfloat16", **kw)
    return model, crit, step


def _train_config(which):
    """(config, launches per step, parameters whose gradient must be
    seen, recipe text) of a training path."""
    from paddle_tpu_torch.models import LlamaConfig, gpt3_1p3b

    if which == "gpt3_1p3b":
        cfg = gpt3_1p3b(max_position_embeddings=2048, use_recompute=True)
        L = cfg.num_layers
        per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                    "fused_norm": (2 * L + 1) + 2 * L,
                    "fused_norm_dx": 2 * L + 1}
        return (cfg, per_step, ("gpt.embed_tokens.weight",
                                "gpt.layers.0.input_layernorm.weight"),
                "O2 bf16 params (LayerNorm f32), AdamW bf16 moments, "
                "per-layer recompute")
    # bench.py:339-353, run_llama_rung: the 7B widths at depth 3
    cfg = LlamaConfig(hidden_size=4096, num_layers=3, num_heads=32,
                      num_kv_heads=8, intermediate_size=11008,
                      max_position_embeddings=2048, attn_variant="flashmask")
    L = cfg.num_layers
    per_step = {"flashmask_fwd": L, "flashmask_bwd_dq": L,
                "flashmask_bwd_dkv": L, "fused_rope": 2 * L,
                "fused_norm": 2 * L + 1, "fused_norm_dx": 2 * L + 1}
    return (cfg, per_step, ("gpt.embed_tokens.weight",
                            "gpt.layers.0.input_layernorm.weight",
                            "lm_head.weight"),
            "f32 params and AdamW moments, AMP O2 bf16, sharding stage 2 on "
            "one device, flashmask attention (trivial index)")


def train(card, torch, which):
    """A training path of bench.py on the card, batch 4 x 2048 (see
    `_train_config`): a warm-up step (every parameter must change; the
    watched gradients must be finite and non-zero), then three timed steps
    with the launch counters zeroed just before and read just after, and a
    profile of one step."""
    cfg, per_step, watch, recipe_text = _train_config(which)
    B, S, timed = 4, 2048, 3
    t0 = time.perf_counter()
    model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0, which)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    torch.cuda.synchronize()
    say(card, f"train {which}: {n_params} parameters "
              f"({sorted({str(p.dtype) for p in named.values()})}), built in "
              f"{time.perf_counter() - t0:.3f} s")

    # warm-up step: every parameter must change, and the gradient must
    # reach the bottom of the graph (the token embedding, layer 0's norm)
    # and the head
    before = {k: p.detach().clone() for k, p in named.items()}
    seen = {}
    hooks = [named[k].register_post_accumulate_grad_hook(
        lambda t, k=k: seen.__setitem__(k, t.grad.float().norm().item()))
        for k in watch]
    t0 = time.perf_counter()
    loss0 = step(ids, labels).item()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    unchanged = [k for k, p in named.items() if torch.equal(p.detach(), before[k])]
    del before
    if unchanged:
        raise AssertionError(f"train {which}: parameters unchanged by step 1: "
                             f"{unchanged}")
    if sorted(seen) != sorted(watch) or not all(
            math.isfinite(g) and g > 0 for g in seen.values()):
        raise AssertionError(f"train {which}: gradient norms {seen}")

    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    want = _expected(**{k: v * timed for k, v in per_step.items()})
    losses = [loss0] + [l.item() for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train {which}: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train {which}: kernel launches {launches} over "
                             f"{timed} steps, expected {want}")
    step_s = total_s / timed
    flops = decoder_flops(cfg, B, S)
    line = {
        "model": which, "recipe": recipe_text, "batch": B, "seq": S,
        "parameters": n_params, "losses": losses, "warmup_step_s": warm_s,
        "timed_steps": timed, "step_s": step_s, "tokens_per_s": B * S / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / PEAK_BF16,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "grad_norms_watched": seen, "launches": launches,
        "launches_per_step": per_step,
    }
    say(card, f"train {which} (smoke run, not a benchmark) " + json.dumps(line))
    profile_step(card, torch, lambda: step(ids, labels), f"train {which} step")
    del step, model, named
    torch.cuda.empty_cache()
    return launches, line


# the kernels of csrc/ by name, as torch.profiler reports them (the sm90
# ones: flash_fwd_sm90_kernel, flash_bwd_dq_sm90_kernel,
# flash_bwd_dkv_sm90_kernel, gg_sm90_kernel; the decodes: paged_split_,
# decode_split_ and decode_combine_kernel; varlen_classes_kernel)
PORT_KERNEL = re.compile(
    r"^void \(anonymous namespace\)::(sm90::)?"
    r"(flash_|norm_|decode_|paged_|rope_|gg_|varlen_)")


def profile_step(card, torch, fn, what):
    """torch.profiler over one call of `fn`: wall time, device-busy time
    (the sum of device activity; one stream, so nothing overlaps), the
    kernels that take the most device time, every kernel of the port
    (csrc/: PORT_KERNEL in the trace's names) with its time, and the host
    operations that take the most host time of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    ranked = sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)

    def rows(evs):
        return [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in evs]

    line = {
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "top_device_kernels": rows(ranked[:10]),
        "port_kernels": rows(e for e in ranked if PORT_KERNEL.search(e.key)),
        "top_host_ops": [
            {"name": e.key[:80], "self_host_ms": e.self_cpu_time_total / 1e3,
             "calls": e.count}
            for e in sorted((e for e in prof.key_averages()
                             if e.self_cpu_time_total > 0),
                            key=lambda e: e.self_cpu_time_total,
                            reverse=True)[:12]]}
    say(card, f"{what} profile " + json.dumps(line))
    return line


# --------------------------------------------------------------------------- #
# phase 6: the training step on the card (kernels) and on the CPU (plain)
# --------------------------------------------------------------------------- #


def train_hold(card, torch, which):
    """The training step on the card (kernels) and on the CPU (plain
    versions), f32 with TF32 off, batch 2 x 256, 2 layers at the path's
    widths: three AdamW steps from the same weights (llama_7bshape two:
    its CPU side, AdamW over 616M f32 parameters, is the run's longest
    hold); the losses and the step-1 gradients within tolerance. "gpt3_1p3b" runs with recompute,
    "llama_7bshape" with flashmask attention; both run the f32 CUDA-core
    forms of the attention kernels (the bf16 tensor-core forms are held by
    the kernel phase only)."""
    cfg = dataclasses.replace(_train_config(which)[0], num_layers=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, steps = 2, 256, 2 if which == "llama_7bshape" else 3
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    results = {}
    state = None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model, crit, step = _train_setup(torch, cfg, dev, torch.float32, 2,
                                         None)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        ids_t = torch.as_tensor(ids, device=dev)
        labels_t = torch.as_tensor(labels, device=dev)
        crit(model(ids_t), labels_t).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        losses = [step(ids_t, labels_t).item() for _ in range(steps)]
        results[dev] = (losses, grads, time.perf_counter() - t0)
        del model, step
    _hold_verdict(card, which, results, B, S)


def _hold_verdict(card, which, results, B, S, model=None):
    """Print and hold a training hold: `results` maps "cuda" and "cpu" to
    (losses, step-1 gradients by name, seconds); the losses within
    TRAIN_HOLD_LOSS_RTOL, each gradient's max |diff| within
    TRAIN_HOLD_GRAD_TOL of its largest entry (or of a thousandth of the
    largest gradient anywhere)."""
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    grad_rel = {k: (g_gpu[k] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-3 * gmax)
                for k, g in g_cpu.items()}
    worst = max(grad_rel, key=grad_rel.get)
    say(card, f"train hold {which} " + json.dumps({
        "model": model or f"{which} widths, 2 layers", "dtype": "float32",
        "batch": B, "seq": S, "losses_cuda": l_gpu, "losses_cpu": l_cpu,
        "max_loss_rel_diff": loss_rel, "loss_rtol": TRAIN_HOLD_LOSS_RTOL,
        "max_grad_rel_diff": grad_rel[worst], "worst_grad": worst,
        "grad_tol": TRAIN_HOLD_GRAD_TOL, "seconds_cuda": s_gpu,
        "seconds_cpu": s_cpu}))
    if not (loss_rel <= TRAIN_HOLD_LOSS_RTOL
            and grad_rel[worst] <= TRAIN_HOLD_GRAD_TOL):
        raise AssertionError(f"train hold {which}: the card's training step "
                             "disagrees with the CPU's")


# --------------------------------------------------------------------------- #
# phase 6b: the sharded step (ZeRO stage 3 with offload) at world size 1
# --------------------------------------------------------------------------- #


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_sharded(card, torch, train_line):
    """Phase 5's gpt3_1p3b step through the sharded code of
    `DistributedTrainStep` on a 1-rank NCCL group (rendezvous at 127.0.0.1
    on a free port; `build_mesh(sharding=1)`, as bench.py:270 builds its
    one-device mesh): sharding stage 3 (every parameter gathered by its
    block for the forward and again for the backward, each gradient
    reduce-scattered into its shard) with offload (the AdamW states in
    pinned host memory between steps). The same weights and tokens as
    phase 5: a warm-up step, then three timed steps with the kernel and
    collective counters zeroed just before and read just after. Each loss
    within TRAIN_SHARDED_RTOL of phase 5's at the same step, the flash and
    norm launches phase 5's per step x 3, all-gathers and reduce-scatters
    in every step, every state tensor on the CPU and pinned after every
    step, and the peak device memory below phase 5's by at least
    OFFLOAD_PEAK_SHARE of the bytes the states hold on the host."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.observability.metrics import default_registry

    cfg, per_step, _, recipe_text = _train_config("gpt3_1p3b")
    B, S, timed = 4, 2048, 3
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        mesh = pdist.build_mesh(sharding=1)
        t0 = time.perf_counter()
        model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0,
                                      "gpt3_1p3b", mesh=mesh,
                                      sharding_stage=3, offload=True)
        opt = step.optimizer
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0

        def states_pinned():
            bad = [k for k, p in step.params.items()
                   for v in opt._states[id(p)].values()
                   if v.device.type != "cpu" or not v.is_pinned()]
            if bad:
                raise AssertionError(f"train_sharded: states not pinned on "
                                     f"the host: {bad[:4]}")

        t0 = time.perf_counter()
        losses = [step(ids, labels).item()]
        warm_s = time.perf_counter() - t0
        states_pinned()
        host_bytes = sum(v.numel() * v.element_size()
                         for st in opt._states.values() for v in st.values())

        _zero_counters()
        since = default_registry().snapshot()
        reset_peak(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = []
        for _ in range(timed):
            before = coll.traffic(since)["calls"]
            losses.append(step(ids, labels).item())
            states_pinned()
            now = coll.traffic(since)["calls"]
            calls.append({op: now.get(op, 0) - before.get(op, 0)
                          for op in ("all_gather", "reduce_scatter",
                                     "all_reduce")})
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        step_s = total_s / timed
        flops = decoder_flops(cfg, B, S)
        ref = train_line["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        want = _expected(**{k: v * timed for k, v in per_step.items()})
        drop = train_line["peak_memory_bytes"] - peak
        line = {
            "model": "gpt3_1p3b", "recipe": recipe_text,
            "mesh": pdist.env.mesh_shape(mesh), "sharding_stage": 3,
            "offload": True, "comm_overlap": step.comm_overlap,
            "batch": B, "seq": S, "built_s": built_s, "warmup_step_s": warm_s,
            "losses": losses, "train_losses": ref, "max_loss_rel_diff": rel,
            "loss_rtol": TRAIN_SHARDED_RTOL, "timed_steps": timed,
            "step_s": step_s, "tokens_per_s": B * S / step_s,
            "mfu": flops / step_s / PEAK_BF16,
            "collectives_per_step": calls,
            "collective_bytes": coll.traffic(since)["bytes"],
            "host_state_bytes": host_bytes, "peak_memory_bytes": peak,
            "train_peak_memory_bytes": train_line["peak_memory_bytes"],
            "peak_drop_bytes": drop,
            "peak_drop_share_of_host_bytes": drop / host_bytes,
            "launches": launches, "launches_per_step": per_step}
        say(card, "train_sharded gpt3_1p3b (smoke run, not a benchmark) "
            + json.dumps(line))
        if rel > TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train_sharded: losses {losses} against "
                                 f"phase 5's {ref}")
        if launches != want:
            raise AssertionError(f"train_sharded: kernel launches {launches}, "
                                 f"expected {want}")
        if not all(c["all_gather"] > 0 and c["reduce_scatter"] > 0
                   for c in calls):
            raise AssertionError(f"train_sharded: collectives {calls}")
        if drop < OFFLOAD_PEAK_SHARE * host_bytes:
            raise AssertionError(
                f"train_sharded: peak {peak} B against phase 5's "
                f"{train_line['peak_memory_bytes']} B, a drop of {drop} B; "
                f"the states hold {host_bytes} B on the host")
        profile_step(card, torch, lambda: step(ids, labels),
                     "train_sharded gpt3_1p3b step")
        del step, model, opt
        torch.cuda.empty_cache()
        return launches
    finally:
        pdist.destroy_process_group()


# --------------------------------------------------------------------------- #
# phase 6c: the tensor- and sequence-parallel step at world size 1
# --------------------------------------------------------------------------- #


def tp_collectives(cfg, step):
    """The collectives that one step of `DistributedTrainStep` on a GPT
    cut over mp makes, by op, as the code places them (sharding stage 0
    or 1, no clip; sequence parallelism on):

    - each block's column-parallel inputs (q, k, v, fc1; gate and up with
      SwiGLU) all-gather the sequence in the forward, and again in the
      recomputed forward, and reduce-scatter in the backward; its two
      row-parallel outputs (out_proj, fc2 / down) reduce-scatter in both
      forwards and all-gather in the backward;
    - the model all-gathers the sequence twice more: the embedding's cut
      (ScatterOp) in the backward, the final norm's output (GatherOp) in
      the forward;
    - all-reduces: the embedding's output, the head's input gradient
      (c_identity), the cross entropy's row max and its sums (two);
    - the step: the loss's count and the reported loss (all-reduces),
      one all-reduce per gradient bucket, one more over mp per bucket of
      sequence-parallel gradients, and at stage 1 one all-gather per
      parameter cut into sharding shards (the update's restore)."""
    L = cfg.num_layers
    col = 5 if cfg.activation == "swiglu" else 4
    row, fwd = 2, 2 if cfg.use_recompute else 1
    cut = sum(step._cut(k) is not None for k in step.params)
    return {
        "all_gather": L * (col * fwd + row) + 2
        + (cut if step.sharding_stage == 1 else 0),
        "reduce_scatter": L * (row * fwd + col),
        "all_reduce": 4 + 2 + len(step._buckets)
        + sum(b.sp for b in step._buckets)}


def train_tensor_parallel(card, torch, train_line):
    """Phase 5's gpt3_1p3b step with sequence parallelism through the mp
    code of `DistributedTrainStep` on a 1-rank NCCL group
    (`build_mesh(mp=1)`, sharding stage 1): the model cut over the mp
    group of one rank, its tensor-parallel layers calling their
    all-reduces, all-gathers and reduce-scatters, the activations between
    blocks the sequence shard (all of it at mp=1). The weights are phase
    5's (seed 0, f32, then O2), carried into the cut model by
    `convert.load_paddle_tpu_state` from a model built with another seed;
    the tokens are phase 5's. A warm-up step, then three timed steps with
    the kernel and collective counters zeroed just before and read just
    after: each loss within TRAIN_SHARDED_RTOL of phase 5's at the same
    step, the flash and norm launches phase 5's per step x 3, and each
    step's collectives the ones `tp_collectives` predicts."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.observability.metrics import default_registry
    from paddle_tpu_torch.models import GPTForCausalLM

    cfg, per_step, _, recipe_text = _train_config("gpt3_1p3b")
    cfg = dataclasses.replace(cfg, sequence_parallel=True)
    B, S, timed = 4, 2048, 3
    t0 = time.perf_counter()
    state = {k: v.cpu().numpy() for k, v in GPTForCausalLM(
        cfg, device="cuda", seed=0).state_dict().items()}
    torch.cuda.empty_cache()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        mesh = pdist.build_mesh(mp=1)
        model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 1,
                                      "gpt3_1p3b", mesh=mesh,
                                      sharding_stage=1)
        load_paddle_tpu_state(model, state)
        del state
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        losses = [step(ids, labels).item()]
        warm_s = time.perf_counter() - t0
        predicted = tp_collectives(cfg, step)

        _zero_counters()
        since = default_registry().snapshot()
        reset_peak(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = []
        for _ in range(timed):
            before = coll.traffic(since)["calls"]
            losses.append(step(ids, labels).item())
            now = coll.traffic(since)["calls"]
            calls.append({op: now.get(op, 0) - before.get(op, 0)
                          for op in sorted(set(now) | set(before))})
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        step_s = total_s / timed
        flops = decoder_flops(cfg, B, S)
        ref = train_line["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        want = _expected(**{k: v * timed for k, v in per_step.items()})
        line = {
            "model": "gpt3_1p3b", "recipe": recipe_text,
            "mesh": pdist.env.mesh_shape(mesh), "sequence_parallel": True,
            "sharding_stage": 1, "batch": B, "seq": S, "built_s": built_s,
            "warmup_step_s": warm_s, "losses": losses, "train_losses": ref,
            "max_loss_rel_diff": rel, "loss_rtol": TRAIN_SHARDED_RTOL,
            "timed_steps": timed, "step_s": step_s,
            "tokens_per_s": B * S / step_s, "mfu": flops / step_s / PEAK_BF16,
            "peak_memory_bytes": peak,
            "train_peak_memory_bytes": train_line["peak_memory_bytes"],
            "collectives_per_step": calls,
            "collectives_predicted": predicted,
            "collective_bytes": coll.traffic(since)["bytes"],
            "gradient_buckets": len(step._buckets),
            "launches": launches, "launches_per_step": per_step}
        say(card, "train_tensor_parallel gpt3_1p3b (smoke run, not a "
            "benchmark) " + json.dumps(line))
        if rel > TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train_tensor_parallel: losses {losses} "
                                 f"against phase 5's {ref}")
        if launches != want:
            raise AssertionError(f"train_tensor_parallel: kernel launches "
                                 f"{launches}, expected {want}")
        if any(c != predicted for c in calls):
            raise AssertionError(f"train_tensor_parallel: collectives {calls}"
                                 f", predicted {predicted} a step")
        profile_step(card, torch, lambda: step(ids, labels),
                     "train_tensor_parallel gpt3_1p3b step")
        del step, model
        torch.cuda.empty_cache()
        return launches
    finally:
        pdist.destroy_process_group()


# --------------------------------------------------------------------------- #
# phase 6d: the pipelined step (1F1B) at world size 1
# --------------------------------------------------------------------------- #

PIPE_MICROBATCHES = 4


def train_pipeline(card, torch, train_line):
    """Phase 5's gpt3_1p3b step as a 1F1B `GPTForCausalLMPipe` through the
    pp code of `DistributedTrainStep` on a 1-rank NCCL group
    (`build_mesh(pp=1)`): PIPE_MICROBATCHES microbatches of one row, each
    run forward without a graph and backward from its kept input, the
    stage the only one. Phase 5's weights (seed 0, f32, stacked by
    `stack_layered_state_dict`, then O2) and tokens. A warm-up step, then
    three timed steps with the kernel and pp counters zeroed just before
    and read just after: each loss within TRAIN_SHARDED_RTOL of phase 5's,
    phase 5's flash and norm launches per step times the microbatches, and
    each step's pp collectives the ones the code places."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.convert import load_paddle_tpu_state
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.observability.metrics import default_registry
    from paddle_tpu_torch.models import (GPTForCausalLM, GPTForCausalLMPipe,
                                         GPTPretrainingCriterion,
                                         stack_layered_state_dict)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import pipeline as pp

    cfg, per_mb, _, recipe_text = _train_config("gpt3_1p3b")
    M = PIPE_MICROBATCHES
    per_step = {k: v * M for k, v in per_mb.items()}
    B, S, timed = 4, 2048, 3
    t0 = time.perf_counter()
    state = stack_layered_state_dict(GPTForCausalLM(
        cfg, device="cuda", seed=0).state_dict(), cfg.num_layers)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        mesh = pdist.build_mesh(pp=1)
        model = GPTForCausalLMPipe(cfg, num_microbatches=M,
                                   pp_schedule="1f1b", device="cuda", seed=1)
        amp.decorate(model, level="O2", dtype="bfloat16")
        crit = GPTPretrainingCriterion(cfg)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                    moment_dtype="bfloat16")
        step = pdist.DistributedTrainStep(
            model, lambda lg, lb: crit(lg, lb), opt, mesh=mesh,
            amp_level="O2", amp_dtype="bfloat16")
        load_paddle_tpu_state(model, state)
        del state
        torch.cuda.empty_cache()
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        losses = [step(ids, labels).item()]
        warm_s = time.perf_counter() - t0
        predicted = {"broadcast": 1,
                     "all_reduce": sum(b.pp for b in step._buckets)}

        _zero_counters()
        since = default_registry().snapshot()
        reset_peak(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = []
        for _ in range(timed):
            before = dict(pp.PP_CALLS)
            losses.append(step(ids, labels).item())
            calls.append({op: n - before.get(op, 0)
                          for op, n in pp.PP_CALLS.items()
                          if n != before.get(op, 0)})
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        step_s = total_s / timed
        flops = decoder_flops(cfg, B, S)
        ref = train_line["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        want = _expected(**{k: v * timed for k, v in per_step.items()})
        line = {
            "model": "gpt3_1p3b", "recipe": recipe_text,
            "mesh": pdist.env.mesh_shape(mesh), "pp_schedule": "1f1b",
            "num_microbatches": M, "stages": model.num_stages(),
            "batch": B, "seq": S, "built_s": built_s,
            "warmup_step_s": warm_s, "losses": losses, "train_losses": ref,
            "max_loss_rel_diff": rel, "loss_rtol": TRAIN_SHARDED_RTOL,
            "timed_steps": timed, "step_s": step_s,
            "tokens_per_s": B * S / step_s, "mfu": flops / step_s / PEAK_BF16,
            "peak_memory_bytes": peak,
            "train_peak_memory_bytes": train_line["peak_memory_bytes"],
            "in_flight_most": pp.IN_FLIGHT.get("1f1b"),
            "pp_collectives_per_step": calls,
            "pp_collectives_predicted": predicted,
            **{f"collective_{k}": v for k, v in coll.traffic(since).items()},
            "launches": launches, "launches_per_step": per_step}
        say(card, "train_pipeline gpt3_1p3b (smoke run, not a benchmark) "
            + json.dumps(line))
        if rel > TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train_pipeline: losses {losses} against "
                                 f"phase 5's {ref}")
        if launches != want:
            raise AssertionError(f"train_pipeline: kernel launches "
                                 f"{launches}, expected {want}")
        if any(c != predicted for c in calls):
            raise AssertionError(f"train_pipeline: pp collectives {calls}, "
                                 f"predicted {predicted} a step")
        if pp.IN_FLIGHT.get("1f1b") != 1:
            raise AssertionError(f"train_pipeline: {pp.IN_FLIGHT} "
                                 "microbatches in flight at one stage")
        profile_step(card, torch, lambda: step(ids, labels),
                     "train_pipeline gpt3_1p3b step")
        del step, model, opt
        torch.cuda.empty_cache()
        return launches
    finally:
        pdist.destroy_process_group()


# --------------------------------------------------------------------------- #
# phase 6e: the context-parallel step (ring attention) at world size 1
# --------------------------------------------------------------------------- #


def train_context_parallel(card, torch, train_line):
    """Phase 5's gpt3_1p3b step with `context_parallel` through the sep
    code of `DistributedTrainStep` on a 1-rank NCCL group
    (`build_mesh(sep=1)`): every attention through `parallel.ring`, the
    sequence cut over the one sep rank. Phase 5's weights (seed 0) and
    tokens: a warm-up step, then three timed steps with the kernel and
    ring counters zeroed just before and read just after. Each loss within
    TRAIN_SHARDED_RTOL of phase 5's, phase 5's norm launches per step and
    no flash launch. Then `ring_attention_alone`."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.parallel import ring

    cfg, per_mb, _, recipe_text = _train_config("gpt3_1p3b")
    cfg.context_parallel = True
    per_step = {k: v for k, v in per_mb.items() if k.startswith("fused_norm")}
    B, S, timed = 4, 2048, 3
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        mesh = pdist.build_mesh(sep=1)
        t0 = time.perf_counter()
        model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0,
                                      "gpt3_1p3b", mesh=mesh)
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        losses = [step(ids, labels).item()]
        warm_s = time.perf_counter() - t0

        _zero_counters()
        ring.RING_CALLS.clear()
        reset_peak(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(ids, labels).item() for _ in range(timed)]
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        step_s = total_s / timed
        flops = decoder_flops(cfg, B, S)
        ref = train_line["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        want = _expected(**{k: v * timed for k, v in per_step.items()})
        line = {
            "model": "gpt3_1p3b", "recipe": recipe_text,
            "context_parallel": True, "mesh": pdist.env.mesh_shape(mesh),
            "batch": B, "seq": S, "built_s": built_s,
            "warmup_step_s": warm_s, "losses": losses, "train_losses": ref,
            "max_loss_rel_diff": rel, "loss_rtol": TRAIN_SHARDED_RTOL,
            "timed_steps": timed, "step_s": step_s,
            "train_step_s": train_line["step_s"],
            "tokens_per_s": B * S / step_s, "mfu": flops / step_s / PEAK_BF16,
            "peak_memory_bytes": peak,
            "train_peak_memory_bytes": train_line["peak_memory_bytes"],
            "ring_calls": dict(ring.RING_CALLS),
            "launches": launches, "launches_per_step": per_step}
        say(card, "train_context_parallel gpt3_1p3b (smoke run, not a "
            "benchmark) " + json.dumps(line))
        if rel > TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train_context_parallel: losses {losses} "
                                 f"against phase 5's {ref}")
        if launches != want:
            raise AssertionError(f"train_context_parallel: kernel launches "
                                 f"{launches}, expected {want}")
        if ring.RING_CALLS:
            raise AssertionError(f"train_context_parallel: a ring of one "
                                 f"hopped {ring.RING_CALLS}")
        profile_step(card, torch, lambda: step(ids, labels),
                     "train_context_parallel gpt3_1p3b step")
        del step, model
        torch.cuda.empty_cache()
        ring_attention_alone(card, torch, pdist.env.mesh_group(mesh, "sep"))
        return launches
    finally:
        pdist.destroy_process_group()


def ring_attention_alone(card, torch, group):
    """`ring_attention` over `group` (sep 1) at the step's shape, [4, 2048,
    16, 128] bf16, causal: the output and dQ, dK, dV through autograd
    against the dense attention in f32 on the same inputs (RING_TOL of
    each tensor's largest entry), and the forward and forward + backward
    times (eager, CUDA events) beside those of the same attention through
    the flash kernels (rows 1-3 of PERF.md's table)."""
    from paddle_tpu_torch.nn.functional.flash_attention import _ref_attention
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.parallel import ring

    B, S, H, D = 4, 2048, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))

    def grads(fn, dtype):
        xs = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        out = fn(*xs)
        return (out, *torch.autograd.grad(out, xs, do.to(dtype)))

    got = grads(lambda a, b, c: ring.ring_attention(a, b, c, group), q.dtype)
    ref = grads(lambda a, b, c: _ref_attention(a, b, c, causal=True),
                torch.float32)
    errs = {}
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        errs[name] = ((g.float() - r).abs().max() / r.abs().max()).item()
    del got, ref
    torch.cuda.empty_cache()

    def fwd_bwd(fn):
        def run():
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fn(*xs), xs, do)
        return run

    ring_fn = lambda a, b, c: ring.ring_attention(a, b, c, group)  # noqa: E731
    flash_fn = lambda a, b, c: flash_attention_fwd(a, b, c, causal=True)  # noqa: E731
    times = {
        "ring_fwd_ms": eager_ms(lambda: ring_fn(q, k, v), reps=5, inner=3),
        "ring_fwd_bwd_ms": eager_ms(fwd_bwd(ring_fn), reps=5, inner=3),
        "flash_fwd_ms": eager_ms(lambda: flash_fn(q, k, v), reps=5, inner=3),
        "flash_fwd_bwd_ms": eager_ms(fwd_bwd(flash_fn), reps=5, inner=3)}
    line = {"shape": [B, S, H, D], "dtype": "bfloat16", "causal": True,
            "sep": 1, "max_err_share_of_max": errs, "tol": RING_TOL, **times,
            "ring_over_flash_fwd_bwd": times["ring_fwd_bwd_ms"]
            / times["flash_fwd_bwd_ms"]}
    say(card, "ring_attention " + json.dumps(line))
    bad = {k: e for k, e in errs.items() if not e <= RING_TOL}
    if bad:
        raise AssertionError(f"ring_attention: errors {bad} above {RING_TOL} "
                             "of the dense attention's largest entry")


# --------------------------------------------------------------------------- #
# phases 11-12: bench.py's gpt3_moe rung
# --------------------------------------------------------------------------- #

# bench.py run_moe_rung (:491): experts, top-k, width, expert hidden, depth,
# vocabulary, batch and sequence of the rung on a TPU
MOE_RUNG = dict(E=8, topk=2, M=1024, H=4096, L=4, V=32000, batch=8, seq=1024)


def moe_decoder(torch, device, L=MOE_RUNG["L"], gate=None, seed=0,
                ep_axis=None):
    """bench.py's MoEDecoder (:533-549) at the rung's widths: a token
    embedding, L pre-LN residual MoE blocks (ExpertFFN, a GShard top-2
    gate; attention-free) and a Linear head. Weights from one generator
    made from `seed` on `device`; layer i's gate routes with seed + i; the
    experts cut over `ep_axis` under a mesh."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertFFN,
                                                                  MoELayer)

    c = MOE_RUNG
    M, H, V, E = c["M"], c["H"], c["V"], c["E"]
    gen = torch.Generator(device=device).manual_seed(seed)

    class MoEDecoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = pnn.Embedding(V, M, generator=gen, device=device)
            self.norms = pnn.LayerList([pnn.LayerNorm(M, device=device)
                                        for _ in range(L)])
            self.moes = pnn.LayerList([
                MoELayer(M, ExpertFFN(E, M, H, ep_axis=ep_axis, generator=gen,
                                      device=device),
                         gate=dict(gate or {"type": "gshard",
                                            "top_k": c["topk"]}),
                         ep_axis=ep_axis, seed=seed + i, generator=gen,
                         device=device)
                for i in range(L)])
            self.head = pnn.Linear(M, V, generator=gen, device=device)

        def forward(self, ids):
            x = self.embed(ids)
            for norm, moe in zip(self.norms, self.moes):
                x = x + moe(norm(x))
            return self.head(x)

    return MoEDecoder()


def moe_step(torch, model, amp_level, mesh=None):
    """bench.py's step of the rung: AdamW lr 1e-4 (f32 moments), cross
    entropy over the flattened logits, DistributedTrainStep with the batch
    over ("dp", "ep"): with no mesh one device, where batch_axes changes
    nothing."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    V = MOE_RUNG["V"]
    return DistributedTrainStep(
        model, lambda lg, lb: F.cross_entropy(lg.reshape(-1, V),
                                              lb.reshape(-1, 1)),
        AdamW(learning_rate=1e-4, parameters=model.parameters()), mesh=mesh,
        batch_axes=("dp", "ep"), amp_level=amp_level, amp_dtype="bfloat16")


def moe_flops():
    """bench.py's FLOP count of a rung step (:576-582): the expert GEMMs
    over the routed rows, the router and the head, forward x 3."""
    c = MOE_RUNG
    tokens = c["batch"] * c["seq"]
    cap = math.ceil(1.2 * tokens / c["E"])
    routed = min(c["topk"] * tokens, c["E"] * cap)
    fwd = (c["L"] * routed * 4.0 * c["M"] * c["H"]
           + c["L"] * tokens * 2.0 * c["M"] * c["E"]
           + tokens * 2.0 * c["M"] * c["V"])
    return 3.0 * fwd


def train_moe(card, torch):
    """bench.py's gpt3_moe rung on the card at full width and depth (8
    experts, GShard top-2 with random routing, width 1024, expert hidden
    4096, 4 layers, vocabulary 32000, batch 8 x 1024), AMP O2 bf16 over f32
    parameters, AdamW lr 1e-4: a warm-up step (every parameter must change;
    gradients must reach the embedding, every gate and every expert's w1
    and w2), then three timed steps with the launch counters zeroed just
    before and read just after: per step 16 grouped GEMMs (two a block
    forward, two dlhs backward), 4 norm forwards and 4 dx, nothing else."""
    c = MOE_RUNG
    B, S, L, timed = c["batch"], c["seq"], c["L"], 3
    t0 = time.perf_counter()
    model = moe_decoder(torch, "cuda")
    step = moe_step(torch, model, "O2")
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, c["V"], (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, c["V"], (B, S)), device="cuda")
    torch.cuda.synchronize()
    say(card, f"train gpt3_moe: {n_params} parameters, built in "
              f"{time.perf_counter() - t0:.3f} s")
    watch = ["embed.weight"] + [f"moes.{i}.{w}" for i in range(L) for w in (
        "gate.gate.weight", "experts.w1", "experts.w2")]
    before = {k: p.detach().clone() for k, p in named.items()}
    seen = {}
    hooks = [named[k].register_post_accumulate_grad_hook(
        lambda t, k=k: seen.__setitem__(k, t.grad.float().norm().item()))
        for k in watch]
    t0 = time.perf_counter()
    loss0 = step(ids, labels).item()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    unchanged = [k for k, p in named.items() if torch.equal(p.detach(), before[k])]
    del before
    if unchanged:
        raise AssertionError(f"train gpt3_moe: parameters unchanged by step 1: "
                             f"{unchanged}")
    if sorted(seen) != sorted(watch) or not all(
            math.isfinite(g) and g > 0 for g in seen.values()):
        raise AssertionError(f"train gpt3_moe: gradient norms {seen}")

    per_step = {"grouped_gemm": 4 * L, "fused_norm": L, "fused_norm_dx": L}
    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    want = _expected(**{k: v * timed for k, v in per_step.items()})
    losses = [loss0] + [l.item() for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train gpt3_moe: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train gpt3_moe: kernel launches {launches} over "
                             f"{timed} steps, expected {want}")
    step_s = total_s / timed
    flops = moe_flops()
    peak = torch.cuda.max_memory_allocated()
    say(card, "train gpt3_moe (smoke run, not a benchmark) " + json.dumps({
        "model": "gpt3_moe", "recipe": "f32 params and AdamW moments, AMP O2 "
        "bf16, GShard top-2 with random routing, sorted fast path",
        **MOE_RUNG, "parameters": n_params, "losses": losses,
        "warmup_step_s": warm_s, "timed_steps": timed, "step_s": step_s,
        "tokens_per_s": B * S / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_BF16, "peak_memory_gb": peak / 1e9,
        "peak_memory_bytes": peak, "grad_norms_watched": seen,
        "launches": launches, "launches_per_step": per_step}))
    profile_step(card, torch, lambda: step(ids, labels), "train gpt3_moe step")
    del step, model, named
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "step_s": step_s,
                      "peak_memory_bytes": peak}


def train_moe_expert_parallel(card, torch, moe_line):
    """Phase 11's rung with `ep_axis="ep"` through `DistributedTrainStep`
    over a 1-rank NCCL mesh (`build_mesh(ep=1)`, batch_axes ("dp", "ep")):
    each MoE layer routed over the one token rank and its experts cut over
    the one ep rank, the expert buffer exchanged by all-to-all in the
    layers' `a2a_chunks` row chunks (2, the default). Phase 11's weights, routing seeds and tokens
    (the same warm-up step first, so that random routing draws alike): the
    losses against phase 11's, bit for bit or within TRAIN_SHARDED_RTOL;
    per step 4 x chunks grouped GEMMs a layer (two forward, two dlhs), the
    norm launches of phase 11, and 4 x chunks all-to-alls a layer."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.observability.metrics import default_registry
    from paddle_tpu_torch.distributed import moe_comm

    c = MOE_RUNG
    B, S, L, timed = c["batch"], c["seq"], c["L"], 3
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        mesh = pdist.build_mesh(ep=1)
        t0 = time.perf_counter()
        model = moe_decoder(torch, "cuda", ep_axis="ep")
        ch = model.moes[0].a2a_chunks
        step = moe_step(torch, model, "O2", mesh=mesh)
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, c["V"], (B, S)), device="cuda")
        labels = torch.as_tensor(rng.integers(0, c["V"], (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        losses = [step(ids, labels).item()]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

        per_step = {"grouped_gemm": 4 * ch * L, "fused_norm": L,
                    "fused_norm_dx": L}
        _zero_counters()
        moe_comm.reset()
        since = default_registry().snapshot()
        reset_peak(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = []
        for _ in range(timed):
            before = coll.traffic(since)["calls"].get("all_to_all", 0)
            losses.append(step(ids, labels).item())
            calls.append(coll.traffic(since)["calls"].get("all_to_all", 0)
                         - before)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        step_s = total_s / timed
        want = _expected(**{k: v * timed for k, v in per_step.items()})
        ref = moe_line["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        line = {
            "model": "gpt3_moe", "ep_axis": "ep", "a2a_chunks": ch,
            "mesh": pdist.env.mesh_shape(mesh), **MOE_RUNG,
            "built_s": built_s, "warmup_step_s": warm_s, "losses": losses,
            "moe_losses": ref, "bit_identical": losses == ref,
            "max_loss_rel_diff": rel, "loss_rtol": TRAIN_SHARDED_RTOL,
            "timed_steps": timed, "step_s": step_s,
            "moe_step_s": moe_line["step_s"], "tokens_per_s": B * S / step_s,
            "mfu": moe_flops() / step_s / PEAK_BF16,
            "peak_memory_bytes": peak,
            "moe_peak_memory_bytes": moe_line["peak_memory_bytes"],
            "all_to_all_per_step": calls,
            "all_to_all_bytes_per_step":
            coll.traffic(since)["bytes"].get("all_to_all", 0) / timed,
            "moe_comm": moe_comm.a2a_totals(),
            "collective_calls": coll.traffic(since)["calls"],
            "launches": launches, "launches_per_step": per_step}
        say(card, "train_moe_expert_parallel gpt3_moe (smoke run, not a "
            "benchmark) " + json.dumps(line))
        if rel > TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train_moe_expert_parallel: losses {losses} "
                                 f"against phase 11's {ref}")
        if launches != want:
            raise AssertionError(f"train_moe_expert_parallel: kernel launches "
                                 f"{launches}, expected {want}")
        if any(n != 4 * ch * L for n in calls):
            raise AssertionError(f"train_moe_expert_parallel: all-to-alls "
                                 f"{calls} a step, expected {4 * ch * L}")
        profile_step(card, torch, lambda: step(ids, labels),
                     "train_moe_expert_parallel gpt3_moe step")
        del step, model
        torch.cuda.empty_cache()
        return launches
    finally:
        pdist.destroy_process_group()


def moe_train_hold(card, torch):
    """The gpt3_moe step on the card (kernels) and on the CPU (plain
    versions) at the rung's widths with 2 layers, batch 2 x 256, f32 (TF32
    off): three AdamW steps from the same weights; the losses and the
    step-1 gradients within the train hold's tolerances. Random routing is
    off on both sides (`random_routing=False`): the two devices' generators
    draw different uniforms, and without them the routes follow the router
    alone, so both sides route alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, steps, V = 2, 256, 3, MOE_RUNG["V"]
    gate = {"type": "gshard", "top_k": 2, "random_routing": False}
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (B, S))
    labels = rng.integers(0, V, (B, S))
    results, state = {}, None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = moe_decoder(torch, dev, L=2, gate=gate, seed=2)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        step = moe_step(torch, model, None)
        ids_t = torch.as_tensor(ids, device=dev)
        labels_t = torch.as_tensor(labels, device=dev)
        step.loss_fn(model(ids_t), labels_t).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        losses = [step(ids_t, labels_t).item() for _ in range(steps)]
        results[dev] = (losses, grads, time.perf_counter() - t0)
        del model, step
    _hold_verdict(card, "gpt3_moe", results, B, S)


# --------------------------------------------------------------------------- #
# phase 13: varlen attention through its entry points
# --------------------------------------------------------------------------- #


def varlen_entry(card, torch):
    """nn.functional.flash_attn_unpadded forward and backward through
    autograd at phase 2's main varlen case (a pack of 8192 tokens in 8
    causal documents, 32 query heads over 8 kv heads of 128, bf16): exactly
    one forward, one dq and one dk/dv launch, the output and the q/k/v
    gradients within phase 2's limits of the plain path on the card. Then
    the same tokens as qkv [T, 3, 32, 128] (k and v expanded to the query
    heads) through flash_attn_varlen_qkvpacked(varlen_padded=False). Then
    flash_attn_unpadded once more in fp16, on phase 2's fp16 pack
    ("path_f16"), held the same way. After each checked run, the entry's
    forward alone and its forward with the backward through autograd are
    timed eagerly back to back (CUDA events); `backward_ms` is their
    difference. Returns (the bf16 calls' launches, the fp16 call's)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import masked_flash as mf

    def inputs(case):
        gen = torch.Generator(device="cuda").manual_seed(13)
        q, k, v, dout, layout, cu_q, cu_k, causal, dtype = _varlen_inputs(
            torch, gen, case)
        return dict(q=q, k=k, v=v, dout=dout, layout=layout, cu_q=cu_q,
                    cu_k=cu_k, causal=causal, dtype=dtype,
                    scale=q.shape[-1] ** -0.5,
                    max_len=int((cu_q[1:] - cu_q[:-1]).max()))

    def plain_path(c, k, v):
        q, dout, layout, causal, scale = (c[n] for n in (
            "q", "dout", "layout", "causal", "scale"))
        out, lse = mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
        dq = mf.varlen_bwd_dq_plain(q, k, v, layout, dout, lse, delta, causal,
                                    scale)
        dk, dv = mf.varlen_bwd_dkv_plain(q, k, v, layout, dout, lse, delta,
                                         causal, scale)
        return {"out": out, "dq": dq, "dk": dk.to(k.dtype), "dv": dv.to(v.dtype)}

    def entry(name, c, fn, leaves, plain):
        dout, dtype, q = c["dout"], c["dtype"], c["q"]
        _zero_counters()
        out, none = fn(*leaves)
        out.backward(dout)
        torch.cuda.synchronize()
        launches = _counters()
        want = _expected(varlen_fwd=1, varlen_bwd_dq=1, varlen_bwd_dkv=1)
        grads = [t.grad for t in leaves]
        if len(grads) == 1:  # qkv [T, 3, H, D]
            grads = grads[0].unbind(1)
        got = {"out": out.detach(), "dq": grads[0], "dk": grads[1],
               "dv": grads[2]}
        errs = _flash_errs(got, plain)
        bad = _flash_violations(errs, dtype)

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            fn(*leaves)[0].backward(dout)

        with torch.no_grad():
            fwd_ms = eager_ms(lambda: fn(*leaves), reps=5, inner=3)
        both_ms = eager_ms(fwd_bwd, reps=5, inner=3)
        say(card, f"varlen {name} " + json.dumps({
            "Tq": q.shape[0], "documents": c["cu_q"].numel() - 1,
            "H": q.shape[1], "D": q.shape[-1], "causal": c["causal"],
            "dtype": dtype, "second": none,
            "row_rel_err": {w: e[1] for w, e in errs.items()},
            "frobenius_rel_err": {w: e[2] for w, e in errs.items()},
            "tol": FLASH_TOL[dtype], "launches": launches,
            "forward_ms": fwd_ms, "forward_backward_ms": both_ms,
            "backward_ms": both_ms - fwd_ms}))
        if launches != want or bad or none is not None:
            raise AssertionError(f"varlen {name}: launches {launches} (expected "
                                 f"{want}), {bad}")
        return launches

    def unpadded(c):
        return lambda q_, k_, v_: F.flash_attn_unpadded(
            q_, k_, v_, c["cu_q"], c["cu_k"], c["max_len"], c["max_len"],
            c["scale"], causal=c["causal"])

    c = inputs("path")
    k, v = c["k"], c["v"]
    g = c["q"].shape[1] // k.shape[1]
    leaves = [t.detach().requires_grad_() for t in (c["q"], k, v)]
    a = entry("flash_attn_unpadded", c, unpadded(c), leaves,
              plain_path(c, k, v))
    del leaves
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    qkv = torch.stack([c["q"], ke, ve], dim=1).requires_grad_()
    b = entry("flash_attn_varlen_qkvpacked", c,
              lambda t: F.flash_attn_varlen_qkvpacked(
                  t, c["cu_q"], c["cu_k"], c["max_len"], c["max_len"],
                  c["scale"], causal=c["causal"], varlen_padded=False),
              [qkv], plain_path(c, ke, ve))
    del qkv, c, k, v
    c = inputs("path_f16")
    leaves = [t.detach().requires_grad_() for t in (c["q"], c["k"], c["v"])]
    f16 = entry("flash_attn_unpadded fp16", c, unpadded(c), leaves,
                plain_path(c, c["k"], c["v"]))
    del leaves, c
    torch.cuda.empty_cache()
    return {n: a[n] + b[n] for n in a}, f16


# --------------------------------------------------------------------------- #
# phases 14-15: bench.py's bert_base rung
# --------------------------------------------------------------------------- #

BERT_RUNG = dict(batch=32, seq=512, n_mask=80)
# the flash forward, dQ and dK/dV once a layer and the norms (the
# embedding's, two a layer, the MLM head's transform_norm) a step
BERT_PER_STEP = dict(flash_fwd=12, flash_bwd_dq=12, flash_bwd_dkv=12,
                     fused_norm=26, fused_norm_dx=26)


def bert_flops(cfg, batch, seq, n_mask):
    """bench.py:397-402: 6 x the encoder's 12 h^2 a layer per token, the
    attention's 12 L h seq per token, and the MLM decode on the masked
    slots."""
    h, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    return (6.0 * 12 * L * h * h * batch * seq + 12.0 * L * h * seq * batch * seq
            + 6.0 * batch * n_mask * h * V)


def bert_inputs(torch, cfg, device, batch, seq, n_mask, seed=0, padded=False):
    """bench.py:388-393's step inputs ([ids, token types, attention mask,
    masked positions], [MLM labels, NSP labels]); `padded` pads the last
    37 (b + 1) % seq keys of row b."""
    rng = np.random.default_rng(seed)
    am = np.ones((batch, seq), np.float32)
    if padded:
        for b in range(batch):
            am[b, seq - (37 * (b + 1)) % seq:] = 0
    xs = [rng.integers(0, cfg.vocab_size, (batch, seq)),
          np.zeros((batch, seq), np.int32), am,
          rng.integers(0, seq, (batch, n_mask))]
    ys = [rng.integers(0, cfg.vocab_size, (batch, n_mask)),
          rng.integers(0, 2, (batch,))]
    return ([torch.as_tensor(x, device=device) for x in xs],
            [torch.as_tensor(y, device=device) for y in ys])


def bert_setup(torch, cfg, device, recipe, seed=0):
    """(model, criterion, step) of bench.py's run_bert_rung recipe
    (recipe "O2": AMP O2 bf16, f32 parameters and AdamW moments, lr 1e-4;
    None: f32) through DistributedTrainStep without a mesh (bench.py's
    one-device mesh)."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import BertForPretraining, BertPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = BertForPretraining(cfg, device=device, seed=seed)
    crit = BertPretrainingCriterion(cfg)
    step = DistributedTrainStep(
        model, lambda mlm, nsp, ml, nl: crit(mlm, nsp, ml, nl),
        AdamW(learning_rate=1e-4, parameters=model.parameters()),
        amp_level=recipe, amp_dtype="bfloat16")
    return model, crit, step


def _changed_and_grads(torch, model, step, xs, ys, watch):
    """One step: the parameters it left unchanged, and the gradient norms
    of `watch` it saw."""
    named = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in named.items()}
    seen = {}
    hooks = [named[k].register_post_accumulate_grad_hook(
        lambda t, k=k: seen.__setitem__(k, t.grad.float().norm().item()))
        for k in watch]
    loss = step(xs, ys).item()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    unchanged = [k for k, p in named.items() if torch.equal(p.detach(), before[k])]
    return loss, unchanged, seen


def train_bert(card, torch):
    """bench.py's run_bert_rung at full size on the card: bert_base,
    batch 32 x 512, 80 masked positions, dropouts 0, AdamW lr 1e-4, AMP O2
    bf16, through DistributedTrainStep. A warm-up step (every parameter
    must change; gradients must reach the word embedding and layer 0's
    norm1), three timed steps with the launch counters zeroed just before
    and read just after (BERT_PER_STEP a step, every attention through the
    flash kernels with the key bias), a profile of one step, then one step
    on a padded attention mask: the same launches, a finite loss."""
    from paddle_tpu_torch.models import bert_base

    cfg = bert_base(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    B, S, M = BERT_RUNG["batch"], BERT_RUNG["seq"], BERT_RUNG["n_mask"]
    timed = 3
    t0 = time.perf_counter()
    model, _, step = bert_setup(torch, cfg, "cuda", "O2")
    xs, ys = bert_inputs(torch, cfg, "cuda", B, S, M)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    say(card, f"train bert_base: {n_params} parameters, built in "
              f"{time.perf_counter() - t0:.3f} s")
    watch = ("bert.embeddings.word_embeddings.weight",
             "bert.encoder.layers.0.norm1.weight")
    t0 = time.perf_counter()
    loss0, unchanged, seen = _changed_and_grads(torch, model, step, xs, ys,
                                                watch)
    warm_s = time.perf_counter() - t0
    if unchanged:
        raise AssertionError(f"train bert_base: parameters unchanged by step "
                             f"1: {unchanged}")
    if sorted(seen) != sorted(watch) or not all(
            math.isfinite(g) and g > 0 for g in seen.values()):
        raise AssertionError(f"train bert_base: gradient norms {seen}")

    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(xs, ys) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    want = _expected(**{k: v * timed for k, v in BERT_PER_STEP.items()})
    losses = [loss0] + [l.item() for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train bert_base: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train bert_base: kernel launches {launches} "
                             f"over {timed} steps, expected {want}")
    step_s = total_s / timed
    flops = bert_flops(cfg, B, S, M)
    line = {
        "model": "bert_base", "recipe": "AMP O2 bf16, f32 parameters and "
        "AdamW moments, lr 1e-4, dropouts 0", "batch": B, "seq": S,
        "n_mask": M, "parameters": n_params, "losses": losses,
        "warmup_step_s": warm_s, "timed_steps": timed, "step_s": step_s,
        "tokens_per_s": B * S / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_BF16,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "grad_norms_watched": seen, "launches": launches,
        "launches_per_step": BERT_PER_STEP}
    say(card, "train bert_base (smoke run, not a benchmark) " + json.dumps(line))
    profile_step(card, torch, lambda: step(xs, ys), "train bert_base step")

    xs_p, ys_p = bert_inputs(torch, cfg, "cuda", B, S, M, seed=1, padded=True)
    _zero_counters()
    loss_p = step(xs_p, ys_p).item()
    torch.cuda.synchronize()
    padded = _counters()
    say(card, "train bert_base padded mask " + json.dumps({
        "padded_keys": int((xs_p[2] == 0).sum()), "loss": loss_p,
        "launches": padded}))
    if padded != _expected(**BERT_PER_STEP) or not math.isfinite(loss_p):
        raise AssertionError(f"train bert_base padded: launches {padded}, "
                             f"loss {loss_p}")
    del step, model
    torch.cuda.empty_cache()
    return launches


def bert_train_hold(card, torch):
    """The bert step on the card (kernels: the f32 flash kernels with the
    key bias, the f32 norm kernels) and on the CPU (plain versions) at
    bert_base's widths with 2 layers, batch 2 x 128, 20 masked positions,
    a padded attention mask, f32 (TF32 off): three AdamW steps from the
    same weights; the losses and the step-1 gradients within the train
    hold's tolerances."""
    from paddle_tpu_torch.models import bert_base

    cfg = bert_base(num_layers=2, hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, M, steps = 2, 128, 20, 3
    results, state = {}, None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model, crit, step = bert_setup(torch, cfg, dev, None, seed=2)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        xs, ys = bert_inputs(torch, cfg, dev, B, S, M, seed=4, padded=True)
        crit(*model(*xs), *ys).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        losses = [step(xs, ys).item() for _ in range(steps)]
        results[dev] = (losses, grads, time.perf_counter() - t0)
        del model, step
    _hold_verdict(card, "bert_base", results, B, S)


# --------------------------------------------------------------------------- #
# phases 16-17: bench.py's resnet50 rung
# --------------------------------------------------------------------------- #

RESNET_RUNG = dict(batch=128, hw=224, fwd_flops=4.1e9)
# cuDNN picks each conv's algorithm by its heuristics for the shape (no
# benchmark mode), and the card's choice (implicit GEMM, Winograd, FFT)
# rounds otherwise than the CPU's: with TF32 off every one computes in
# f32, and its step-1 gradients came within 1.3e-5 of the float64 ones
# (of each tensor's largest entry, resnet18 at this hold's weights and
# images), which three steps through 20 batch norms carry to the losses
# and the running statistics within RESNET_STATS_TOL of each tensor's
# largest entry. TF32 (cuDNN's default for f32 convs) rounds each product
# to 10 bits and would not hold them. The CPU side runs in float64: on the
# same weights the CPU's own f32 convs (oneDNN) missed its float64
# gradients by 10.6% of layer2.1.conv1's largest entry (the card's f32:
# 1.3e-5), so an f32 CPU run is no oracle for the card's.
RESNET_STATS_TOL = 1e-4


def resnet_setup(torch, model, recipe, lr):
    """bench.py:466-473's step: Momentum(lr, 0.9), cross entropy, AMP
    `recipe` (O2 bf16, or None: f32) through DistributedTrainStep without
    a mesh."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    return DistributedTrainStep(
        model, lambda lg, lb: F.cross_entropy(lg, lb),
        Momentum(learning_rate=lr, momentum=0.9, parameters=model.parameters()),
        amp_level=recipe, amp_dtype="bfloat16")


def _batch_norms(model):
    from paddle_tpu_torch.nn import BatchNorm2D

    return {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm2D)}


def train_resnet(card, torch):
    """bench.py's run_resnet_rung at full size on the card: resnet50,
    batch 128 x 3 x 224 x 224, Momentum lr 0.1 / 0.9, AMP O2 bf16 (f32
    parameters: bench.py decorates nothing, and batch_norm runs in f32 as a
    black-list op) through DistributedTrainStep. A warm-up step (every
    conv weight must change, the running statistics must move), three
    timed steps with the launch counters zeroed just before and read just
    after (no hand-written kernel: the convs are cuDNN's, the batch norms
    plain torch ops), every batch norm's parameters and statistics still
    f32, and a profile of one step."""
    from paddle_tpu_torch.vision.models import resnet50

    B, HW = RESNET_RUNG["batch"], RESNET_RUNG["hw"]
    timed = 3
    t0 = time.perf_counter()
    model = resnet50(device="cuda")
    step = resnet_setup(torch, model, "O2", 0.1)
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.normal(size=(B, 3, HW, HW)).astype(np.float32),
                          device="cuda")
    lab = torch.as_tensor(rng.integers(0, 1000, (B, 1)), device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    bns = _batch_norms(model)
    torch.cuda.synchronize()
    say(card, f"train resnet50: {n_params} parameters, {len(bns)} batch "
              f"norms, built in {time.perf_counter() - t0:.3f} s")
    convs = [k for k in dict(model.named_parameters())
             if k.endswith("weight") and model.get_parameter(k).dim() == 4]
    stats = {n: (m._mean.clone(), m._variance.clone()) for n, m in bns.items()}
    t0 = time.perf_counter()
    loss0, unchanged, _ = _changed_and_grads(torch, model, step, img, lab, ())
    warm_s = time.perf_counter() - t0
    still = [n for n, m in bns.items()
             if torch.equal(m._mean, stats[n][0]) or torch.equal(m._variance, stats[n][1])]
    if [k for k in unchanged if k in convs] or still:
        raise AssertionError(f"train resnet50: unchanged conv weights "
                             f"{unchanged}, batch norms whose statistics did "
                             f"not move {still}")

    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(img, lab) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    losses = [loss0] + [l.item() for l in losses]
    dtypes = sorted({str(t.dtype) for m in bns.values()
                     for t in (m.weight, m.bias, m._mean, m._variance)})
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train resnet50: non-finite loss {losses}")
    if launches != _expected():
        raise AssertionError(f"train resnet50: kernel launches {launches}, "
                             "expected none")
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"train resnet50: batch norm dtypes {dtypes}")
    step_s = total_s / timed
    flops = 3.0 * RESNET_RUNG["fwd_flops"] * B
    line = {
        "model": "resnet50", "recipe": "AMP O2 bf16, f32 parameters, "
        "Momentum lr 0.1 momentum 0.9", "batch": B, "image": [3, HW, HW],
        "parameters": n_params, "losses": losses, "warmup_step_s": warm_s,
        "timed_steps": timed, "step_s": step_s, "images_per_s": B / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / PEAK_BF16,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "batch_norm_dtypes": dtypes, "launches": launches}
    say(card, "train resnet50 (smoke run, not a benchmark) " + json.dumps(line))
    profile_step(card, torch, lambda: step(img, lab), "train resnet50 step")
    del step, model
    torch.cuda.empty_cache()
    return launches


def resnet_train_hold(card, torch):
    """The resnet step on the card in f32 (TF32 off) and on the CPU in
    float64 (RESNET_RUNG's note): resnet18, batch 4 x 3 x 64 x 64, three
    Momentum steps (lr 1e-3, 0.9) from the same weights; the losses and
    the step-1 gradients within the train hold's tolerances, the running
    statistics within RESNET_STATS_TOL."""
    from paddle_tpu_torch.vision.models import resnet18

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, HW, steps = 4, 64, 3
    rng = np.random.default_rng(4)
    img = rng.normal(size=(B, 3, HW, HW)).astype(np.float32)
    lab = rng.integers(0, 1000, (B, 1))
    results, state, stats = {}, None, {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        t0 = time.perf_counter()
        model = resnet18(device=dev, seed=2)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        model.to(dt)
        step = resnet_setup(torch, model, None, 1e-3)
        x = torch.as_tensor(img, device=dev).to(dt)
        y = torch.as_tensor(lab, device=dev)
        step.loss_fn(model(x), y).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        model.load_state_dict(state)   # the backward's forward moved the statistics
        losses = [step(x, y).item() for _ in range(steps)]
        stats[dev] = {k: v.cpu().double() for k, v in model.state_dict().items()
                      if "._" in k}
        results[dev] = (losses, grads, time.perf_counter() - t0)
        del model, step
    stats_err = max(((stats["cuda"][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30)).item()
                    for k, v in stats["cpu"].items())
    say(card, "train hold resnet18 running statistics " + json.dumps({
        "max_rel_diff": stats_err, "tol": RESNET_STATS_TOL,
        "batch_norms": len(stats["cpu"]) // 2}))
    _hold_verdict(card, "resnet18", results, B, HW,
                  model=f"resnet18, images {HW} x {HW} (seq: the side); the "
                  "CPU side in float64")
    if not stats_err <= RESNET_STATS_TOL:
        raise AssertionError("train hold resnet18: the running statistics "
                             "disagree")


# --------------------------------------------------------------------------- #
# phases 18-19: bench.py's unet_sd rung
# --------------------------------------------------------------------------- #

UNET_RUNG = dict(batch=8, hw=64, ctx=77)
# 11 attention blocks (2 down and 3 up at level 1, 2 down, the mid and 3 up
# at level 2), each a self- and a cross-attention: 22 flash forwards, dQ
# and dK/dV a step, 10 of each at head dim 80 and 12 at 160; each block's
# norm2 LayerNorm (f32 under O2) the norm forward and dx. The 46 group
# norms (17 ResBlocks x 2, 11 attention blocks, norm_out) are torch ops.
UNET_PER_STEP = dict(flash_fwd=22, flash_bwd_dq=22, flash_bwd_dkv=22,
                     fused_norm=11, fused_norm_dx=11)
# the rung's widths (bench.py:420-423): heads of 640 / 8 = 80 and
# 1280 / 8 = 160, a context of 768
UNET_WIDTHS = dict(in_channels=4, out_channels=4, base_channels=320,
                   channel_mult=(1, 2, 4), attention_levels=(1, 2),
                   num_heads=8, context_dim=768)
# the aten ops of a group norm and its backward (torch's CUDA kernels)
GROUP_NORM_OPS = ("aten::native_group_norm", "aten::native_group_norm_backward")


def unet_setup(torch, cfg, device, recipe, seed=0):
    """(model, step) of bench.py's run_unet_rung recipe (:428-444):
    MSELoss, AdamW(lr 1e-4, bf16 moments), AMP `recipe` ("O2" bf16 or None:
    f32) through DistributedTrainStep without a mesh (bench.py's one-device
    mesh); like bench.py, nothing is decorated: the parameters stay f32."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import UNetModel
    from paddle_tpu_torch.nn import MSELoss
    from paddle_tpu_torch.optimizer import AdamW

    model = UNetModel(cfg, device=device, seed=seed)
    mse = MSELoss()
    step = DistributedTrainStep(
        model, lambda pred, target: mse(pred, target),
        AdamW(learning_rate=1e-4, moment_dtype="bfloat16",
              parameters=model.parameters()),
        amp_level=recipe, amp_dtype="bfloat16")
    return model, step


def unet_inputs(torch, cfg, device, batch, hw, ctx_len, seed=0):
    """bench.py:434-442's [noisy, t (int64), context] and noise target."""
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(batch, cfg.in_channels, hw, hw)).astype(np.float32)
    t = rng.integers(0, 1000, (batch,))
    ctx = rng.normal(size=(batch, ctx_len, cfg.context_dim)).astype(np.float32)
    noise = rng.normal(size=(batch, cfg.out_channels, hw, hw)).astype(np.float32)
    return ([torch.as_tensor(a, device=device) for a in (noisy, t, ctx)],
            torch.as_tensor(noise, device=device))


def _group_norm_share(torch, fn):
    """Device milliseconds of one call of `fn` in all, and in the group
    norms' aten ops (GROUP_NORM_OPS, forward and backward, the kernels each
    launched) by op, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = {e.key: {"device_ms": e.device_time_total / 1e3, "calls": e.count}
           for e in events if e.key in GROUP_NORM_OPS}
    return busy, ops


def train_unet(card, torch):
    """bench.py's run_unet_rung at full size on the card: the UNet at
    UNET_WIDTHS with 2 res blocks a level (453 M parameters), batch 8 of a
    64 x 64 x 4 latent, a context of 77 x 768, t int64, AdamW lr 1e-4 with
    bf16 moments, AMP O2 bf16 through DistributedTrainStep. A warm-up step
    (every conv weight must change), three timed steps with the launch
    counters zeroed just before and read just after (UNET_PER_STEP a step
    and nothing else), finite losses, the group norms' parameters as the
    recipe leaves them (f32) with f32 outputs, a profile of one step and the
    group norms' share of its device time. Then a GroupNorm that
    `amp.decorate` cast: bf16 parameters, f32 output under O2."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import UNetConfig
    from paddle_tpu_torch.nn import GroupNorm

    cfg = UNetConfig(num_res_blocks=2, **UNET_WIDTHS)
    B, HW, L = UNET_RUNG["batch"], UNET_RUNG["hw"], UNET_RUNG["ctx"]
    timed = 3
    t0 = time.perf_counter()
    model, step = unet_setup(torch, cfg, "cuda", "O2")
    xs, noise = unet_inputs(torch, cfg, "cuda", B, HW, L)
    n_params = sum(p.numel() for p in model.parameters())
    norms = [m for m in model.modules() if isinstance(m, GroupNorm)]
    torch.cuda.synchronize()
    say(card, f"train unet_sd: {n_params} parameters, {len(norms)} group "
              f"norms, built in {time.perf_counter() - t0:.3f} s")
    convs = [k for k, p in model.named_parameters() if p.dim() == 4]
    t0 = time.perf_counter()
    loss0, unchanged, _ = _changed_and_grads(torch, model, step, xs, noise, ())
    warm_s = time.perf_counter() - t0
    if [k for k in unchanged if k in convs]:
        raise AssertionError(f"train unet_sd: conv weights unchanged by step "
                             f"1: {[k for k in unchanged if k in convs]}")

    out_dtypes = set()
    hooks = [m.register_forward_hook(lambda m, i, o: out_dtypes.add(str(o.dtype)))
             for m in norms]
    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(xs, noise) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    for h in hooks:
        h.remove()
    want = _expected(**{k: v * timed for k, v in UNET_PER_STEP.items()})
    losses = [loss0] + [l.item() for l in losses]
    param_dtypes = sorted({str(t.dtype) for m in norms for t in (m.weight, m.bias)})
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train unet_sd: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train unet_sd: kernel launches {launches} over "
                             f"{timed} steps, expected {want}")
    if len(norms) != 46 or out_dtypes != {"torch.float32"}:
        raise AssertionError(f"train unet_sd: {len(norms)} group norms with "
                             f"outputs {out_dtypes}")
    step_s = total_s / timed
    line = {
        "model": "unet_sd", "recipe": "AMP O2 bf16, f32 parameters, AdamW lr "
        "1e-4 with bf16 moments", "batch": B, "latent": [4, HW, HW],
        "context": [L, cfg.context_dim], "parameters": n_params,
        "losses": losses, "warmup_step_s": warm_s, "timed_steps": timed,
        "step_s": step_s, "latents_per_s": B / step_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "group_norms": len(norms), "group_norm_param_dtypes": param_dtypes,
        "group_norm_output_dtypes": sorted(out_dtypes), "launches": launches,
        "launches_per_step": UNET_PER_STEP}
    say(card, "train unet_sd (smoke run, not a benchmark) " + json.dumps(line))
    profile_step(card, torch, lambda: step(xs, noise), "train unet_sd step")
    busy, ops = _group_norm_share(torch, lambda: step(xs, noise))
    gn_ms = sum(o["device_ms"] for o in ops.values())
    say(card, "train unet_sd group norms " + json.dumps({
        "device_busy_ms": busy, "group_norm_device_ms": gn_ms,
        "group_norm_share": gn_ms / busy if busy else None, "ops": ops}))
    if not ops:
        raise AssertionError("train unet_sd: no group norm in the profile")

    gn = GroupNorm(32, 640, device="cuda")
    amp.decorate(gn, level="O2", dtype="bfloat16")
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        y = gn(torch.randn(2, 640, 8, 8, device="cuda", dtype=torch.bfloat16))
    say(card, "train unet_sd decorated group norm " + json.dumps({
        "param_dtype": str(gn.weight.dtype), "output_dtype": str(y.dtype)}))
    if gn.weight.dtype != torch.bfloat16 or y.dtype != torch.float32:
        raise AssertionError(f"unet_sd: a decorated GroupNorm holds "
                             f"{gn.weight.dtype} and returns {y.dtype}")
    del step, model, xs, noise
    torch.cuda.empty_cache()
    return launches


def unet_train_hold(card, torch):
    """The unet step on the card (the f32 flash kernels at the 128 and 192
    widths: heads of 80 and 160; the f32 norm kernels) and on the CPU
    (plain versions) at the rung's widths with one res block a level,
    batch 2 of a 16 x 16 latent, a context of 8, f32 (TF32 off): two
    AdamW steps from the same weights; the losses and the step-1
    gradients within the train hold's tolerances. The CPU's convs run
    without oneDNN (torch.backends.mkldnn off), whose f32 convs missed
    their own float64 gradients on this machine (RESNET_RUNG's note)."""
    from paddle_tpu_torch.models import UNetConfig
    from paddle_tpu_torch.nn import MSELoss

    cfg = UNetConfig(num_res_blocks=1, **UNET_WIDTHS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, HW, L, steps = 2, 16, 8, 2
    results, state = {}, None
    mkldnn = torch.backends.mkldnn.enabled
    try:
        for dev in ("cuda", "cpu"):
            torch.backends.mkldnn.enabled = dev == "cuda" and mkldnn
            t0 = time.perf_counter()
            model, step = unet_setup(torch, cfg, dev, None, seed=2)
            if state is None:
                state = {k: v.cpu() for k, v in model.state_dict().items()}
            else:
                model.load_state_dict(state)
            xs, noise = unet_inputs(torch, cfg, dev, B, HW, L, seed=4)
            _zero_counters()
            MSELoss()(model(*xs), noise).backward()
            if dev == "cuda":
                torch.cuda.synchronize()
                fwd_bwd = _counters()
            grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            losses = [step(xs, noise).item() for _ in range(steps)]
            results[dev] = (losses, grads, time.perf_counter() - t0)
            del model, step
    finally:
        torch.backends.mkldnn.enabled = mkldnn
    # 7 attention blocks of 2 attentions at one res block a level
    if fwd_bwd != _expected(flash_fwd=14, flash_bwd_dq=14, flash_bwd_dkv=14,
                            fused_norm=7, fused_norm_dx=7):
        raise AssertionError(f"unet hold: the card's f32 step launched {fwd_bwd}")
    _hold_verdict(card, "unet_sd", results, B, HW * HW,
                  model="unet_sd widths, 1 res block a level")


# --------------------------------------------------------------------------- #
# phases 20-22: the port's draws, dropout at bert_base's own config, the
# schedulers and the other optimizers
# --------------------------------------------------------------------------- #

RANDOM_N = 1 << 26
RANDOM_SIGMAS = 5.0


def check_random(card, torch):
    """Phase 20 (module docstring)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_1p3b)
    from paddle_tpu_torch.nn import functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, bad = [], []
    n = RANDOM_N
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, device="cuda", generator=gen).to(dtype)
        for p in (0.1, 0.5):
            ptt.seed(1)
            out = F.dropout(x, p)
            ptt.seed(1)
            same = torch.equal(F.dropout(x, p), out)
            other = not torch.equal(F.dropout(x, p), out)
            keep = out != 0
            kept = int(keep.sum())
            z = (kept - n * (1 - p)) / math.sqrt(n * p * (1 - p))
            exact = torch.equal(out[keep], (x / (1 - p))[keep])
            ms = eager_ms(lambda: F.dropout(x, p), reps=5, inner=5)
            row = {"dtype": str(dtype).split(".")[-1], "p": p, "n": n,
                   "kept": kept, "z": z, "kept_exact": exact,
                   "same_seed_same_mask": same, "next_draw_differs": other,
                   "dtype_kept": out.dtype == dtype, "ms": ms,
                   "hbm_bound_ms": 2 * n * x.element_size()
                   / HBM_BYTES_PER_S * 1e3}
            rows.append(row)
            if not (abs(z) <= RANDOM_SIGMAS and exact and same and other
                    and row["dtype_kept"]):
                bad.append(row)
    x4 = torch.randn(8, 16, 12, 12, device="cuda", generator=gen) + 5
    shapes = {}
    for name, fn, cut in (
            ("dropout2d", lambda t: pnn.Dropout2D(0.5)(t), (2, 3)),
            ("axis_1", lambda t: F.dropout(t, 0.5, axis=1), (0, 2, 3)),
            ("axis_0_2", lambda t: F.dropout(t, 0.5, axis=[0, 2]), (1, 3))):
        r = fn(x4) / x4
        ok = all(torch.equal(r, r.narrow(d, 0, 1).expand_as(r)) for d in cut)
        shapes[name] = ok
        if not ok:
            bad.append({name: "mask not broadcast over the other dims"})
    xa = torch.randn(n, device="cuda", generator=gen, dtype=torch.float64)
    alpha = _alpha_moments(F.alpha_dropout(xa, 0.2))
    if abs(alpha["mean_z"]) > RANDOM_SIGMAS or \
            abs(alpha["var_z"]) > RANDOM_SIGMAS:
        bad.append({"alpha_dropout": alpha})
    say(card, "random dropout " + json.dumps({
        "rows": rows, "broadcast": shapes, "alpha_dropout": alpha}))
    del x, out, keep, xa

    # one gpt3_1p3b block with dropout, with and without recompute
    cfg = gpt3_1p3b(max_position_embeddings=2048, hidden_dropout_prob=0.1,
                    attention_dropout_prob=0.1)
    cfg.num_layers = 1
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=3)
    crit = GPTPretrainingCriterion(cfg)
    ids = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 1024)), device="cuda")
    grads, launches, losses = {}, {}, {}
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for rc in (False, True):
            cfg.use_recompute = rc
            ptt.seed(5)
            _zero_counters()
            loss = crit(model(ids), ids)
            loss.backward()
            torch.cuda.synchronize()
            launches[rc] = {k: v for k, v in _counters().items() if v}
            losses[rc] = loss.item()
            grads[rc] = {k: p.grad.clone() for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    differ = [k for k in grads[False]
              if not torch.equal(grads[False][k], grads[True][k])]
    line = {"block": "gpt3_1p3b, 1 layer, bf16, batch 2 x 1024, hidden and "
            "attention dropout 0.1", "losses": [losses[False], losses[True]],
            "launches_plain": launches[False],
            "launches_recompute": launches[True],
            "grads_bitwise_equal": not differ, "differing": differ[:8]}
    say(card, "random recompute " + json.dumps(line))
    want_norm = 2 * cfg.num_layers + 1
    if launches[False].get("fused_norm") != want_norm or \
            launches[True].get("fused_norm") != want_norm + 2 * cfg.num_layers:
        bad.append({"recompute launches": launches})
    if differ or losses[False] != losses[True]:
        bad.append({"recompute": differ[:8]})
    del model, grads
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"random: {bad}")


def _alpha_moments(y):
    """The sample mean and variance of y with their distances from 0 and 1
    in standard errors: sqrt(var / n) for the mean, sqrt((m4 - var^2) / n)
    for the variance (m4 the fourth central moment, which alpha dropout's
    two-valued dropped share sets)."""
    n = y.numel()
    mean = y.mean().item()
    c = y - mean
    var = c.square().mean().item()
    m4 = c.pow(4).mean().item()
    return {"mean": mean, "var": var,
            "mean_z": mean / math.sqrt(var / n),
            "var_z": (var - 1) / math.sqrt((m4 - var * var) / n)}


def _mlm_labels_kept(rng, batch, seq, n_mask, vocab):
    """Masked-LM labels [batch, n_mask]: a row keeps min(n_mask,
    Binomial(seq, 0.15)) labels (a seeded ~15% of its tokens), the rest of
    its slots -100, so the kept count varies by row."""
    kept = np.minimum(n_mask, rng.binomial(seq, 0.15, batch))
    labels = rng.integers(0, vocab, (batch, n_mask))
    labels[np.arange(n_mask)[None, :] >= kept[:, None]] = -100
    return labels, kept


def _bert_schedule(plr):
    return plr.LinearWarmup(plr.PolynomialDecay(1e-4, decay_steps=8,
                                                end_lr=1e-5),
                            warmup_steps=2, start_lr=0.0, end_lr=1e-4)


def _no_decay_on_bias_or_norm(name):
    return not any(s in name for s in ("bias", "norm"))


# norm forward and dx a step; attention with dropout is the composite
BERT_DROPOUT_PER_STEP = dict(fused_norm=26, fused_norm_dx=26)
BERT_EVAL_LAUNCHES = dict(flash_fwd=12, fused_norm=26)


def train_bert_dropout(card, torch):
    """Phase 21 (module docstring). Returns the launches of the five
    training steps and those of the eval forward."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion, bert_base)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as plr

    cfg = bert_base()
    B, S, M = BERT_RUNG["batch"], BERT_RUNG["seq"], BERT_RUNG["n_mask"]
    steps = 5
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device="cuda", seed=0)
    crit = BertPretrainingCriterion(cfg)
    sched = _bert_schedule(plr)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                apply_decay_param_fun=_no_decay_on_bias_or_norm,
                moment_dtype="bfloat16")
    step = DistributedTrainStep(
        model, lambda mlm, nsp, ml, nl: crit(mlm, nsp, ml, nl), opt,
        amp_level="O2", amp_dtype="bfloat16")
    xs, ys = bert_inputs(torch, cfg, "cuda", B, S, M)
    labels, kept = _mlm_labels_kept(np.random.default_rng(7), B, S, M,
                                    cfg.vocab_size)
    ys[0] = torch.as_tensor(labels, device="cuda")
    decayed = sum(_no_decay_on_bias_or_norm(k) for k in step.params)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0

    ref = _bert_schedule(plr)
    want_lr = []
    for _ in range(steps):
        want_lr.append(ref())
        ref.step()
    _zero_counters()
    reset_peak(torch)
    used_lr, losses, times, prof = [], [], [], None
    for i in range(steps):
        used_lr.append(opt.get_lr())
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == steps - 1:
            prof = profile_step(card, torch,
                                lambda: losses.append(step(xs, ys).item()),
                                "train bert_base dropout step")
        else:
            losses.append(step(xs, ys).item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        sched.step()
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    want = _expected(**{k: v * steps for k, v in BERT_DROPOUT_PER_STEP.items()})

    _zero_counters()
    eval_loss = step.evaluate(xs, ys).item()
    torch.cuda.synchronize()
    eval_launches = _counters()
    step_s = sum(times[1:steps - 1]) / (steps - 2)
    flops = bert_flops(cfg, B, S, M)
    line = {
        "model": "bert_base", "recipe": "its own config (hidden and "
        "attention dropout 0.1), AMP O2 bf16, f32 parameters, AdamW bf16 "
        "moments on LinearWarmup(PolynomialDecay(1e-4, 8, 1e-5), 2, 0, "
        "1e-4), no decay on biases and norms",
        "batch": B, "seq": S, "n_mask": M,
        "kept_slots_per_row": [int(k) for k in kept],
        "decayed_parameters": decayed, "parameters": len(step.params),
        "built_s": built_s, "losses": losses, "lr_used": used_lr,
        "lr_scheduler": want_lr, "first_step_s": times[0],
        "timed_steps": steps - 2, "step_s": step_s,
        "tokens_per_s": B * S / step_s, "mfu": flops / step_s / PEAK_BF16,
        "profiled_step_s": times[-1],
        "device_busy_share": prof["device_busy_share"],
        "peak_memory_gb": peak / 1e9, "peak_memory_bytes": peak,
        "launches": launches, "launches_per_step": BERT_DROPOUT_PER_STEP,
        "eval_loss": eval_loss, "eval_launches": eval_launches}
    say(card, "train bert_base dropout (smoke run, not a benchmark) "
        + json.dumps(line))
    bad = []
    if not all(math.isfinite(l) for l in losses + [eval_loss]):
        bad.append(f"non-finite loss {losses}, eval {eval_loss}")
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if eval_launches != _expected(**BERT_EVAL_LAUNCHES):
        bad.append(f"eval launches {eval_launches}")
    if used_lr != want_lr or len(set(used_lr)) < 4:
        bad.append(f"rates {used_lr} against the scheduler's {want_lr}")
    if len(set(int(k) for k in kept)) < 2:
        bad.append(f"kept slots {kept} do not vary by row")
    del step, model, opt
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"train bert_base dropout: {bad}")
    return launches, eval_launches


OPT_HOLD_RTOL = 1e-5
# optimizer name -> (class, keyword arguments); the AdamW case takes a
# fresh scheduler and the decay filter
OPT_HOLD_CASES = {
    "Adamax": ("Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    "Adagrad": ("Adagrad", dict(learning_rate=0.05, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    "Adadelta": ("Adadelta", dict(learning_rate=1.0, weight_decay=0.01)),
    "RMSProp": ("RMSProp", dict(learning_rate=0.01, momentum=0.9,
                                centered=True, weight_decay=0.01)),
    "Lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01)),
    "Lars": ("Lars", dict(learning_rate=0.5, lars_coeff=0.01)),
    "NAdam": ("NAdam", dict(learning_rate=0.01, weight_decay=0.01)),
    "RAdam": ("RAdam", dict(learning_rate=0.01, weight_decay=0.01)),
    "Rprop": ("Rprop", dict(learning_rate=0.01)),
    "ASGD": ("ASGD", dict(learning_rate=0.05, batch_num=2,
                          weight_decay=0.01)),
    "AdamW_filter_scheduler": ("AdamW", dict(weight_decay=0.1)),
}


def _hold_mlp(torch, device, state=None):
    from paddle_tpu_torch import nn as pnn

    g = torch.Generator(device=device).manual_seed(0)
    net = torch.nn.Sequential(
        pnn.Linear(64, 128, generator=g, device=device), torch.nn.Tanh(),
        pnn.Linear(128, 128, generator=g, device=device), torch.nn.Tanh(),
        pnn.Linear(128, 16, generator=g, device=device))
    if state is not None:
        net.load_state_dict(state)
    return net


def _rel_gap(got, want):
    """The largest over the tensors of ||got - want|| / ||want|| (the
    norm of the gap over the CPU tensor's norm). Adam-like rules divide
    by the root of g^2, so an entry whose gradient is near 0 moves by a
    share of lr set by its rounding: such entries give the largest
    |got - want| (`_max_gap`, printed beside it) and not the norm."""
    return max(float((got[k].cpu() - v).norm() / v.norm().clamp(min=1e-30))
               for k, v in want.items())


def _max_gap(got, want):
    """(the largest |got - want| of each tensor over its largest |want|,
    that tensor's name)."""
    return max((float((got[k].cpu() - v).abs().max()
                      / v.abs().max().clamp(min=1e-30)), k)
               for k, v in want.items())


def optimizers_hold(card, torch):
    """Phase 22 (module docstring)."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.distributed import train_step as ts
    from paddle_tpu_torch.optimizer import lr as plr

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(11)
    x = rng.normal(size=(32, 64)).astype(np.float32)
    y = rng.normal(size=(32, 16)).astype(np.float32)
    state = {k: v.cpu() for k, v in _hold_mlp(torch, "cpu").state_dict().items()}

    def mse(o, t):
        return ((o - t) ** 2).mean()

    def eager(device, cls, kw):
        net = _hold_mlp(torch, device, state)
        sched = None
        if cls == "AdamW":
            sched = plr.CosineAnnealingDecay(0.02, T_max=4)
            kw = dict(kw, learning_rate=sched,
                      apply_decay_param_fun=_no_decay_on_bias_or_norm)
        opt = getattr(popt, cls)(parameters=net.named_parameters(), **kw)
        xt, yt = (torch.as_tensor(a, device=device) for a in (x, y))
        for _ in range(3):
            mse(net(xt), yt).backward()
            opt.step()
            opt.clear_grad()
            if sched is not None:
                sched.step()
        return {k: v.detach().cpu() for k, v in net.state_dict().items()}

    rows, bad = {}, []
    for name, (cls, kw) in OPT_HOLD_CASES.items():
        want = eager("cpu", cls, kw)
        got = eager("cuda", cls, kw)
        moved = max(float((want[k] - state[k]).abs().max()) for k in state)
        rows[name] = {"rel_gap": _rel_gap(got, want),
                      "max_gap": _max_gap(got, want), "moved": moved}
        if not rows[name]["rel_gap"] <= OPT_HOLD_RTOL or moved <= 1e-5:
            bad.append((name, rows[name]))

    # Lamb and Lars: whole-parameter norms over offload slices
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    sharded = {}
    saved = ts.OFFLOAD_SLICE
    try:
        mesh = pdist.build_mesh(sharding=1)
        ts.OFFLOAD_SLICE = 4096
        for name in ("Lamb", "Lars"):
            out = {}
            for offload in (False, True):
                net = _hold_mlp(torch, "cuda", state)
                step = pdist.DistributedTrainStep(
                    net, mse, getattr(popt, name)(
                        parameters=net.parameters(), **OPT_HOLD_CASES[name][1]),
                    mesh=mesh, sharding_stage=2, offload=offload)
                losses = [step(x, y).item() for _ in range(3)]
                out[offload] = (losses, {k: v.detach().cpu()
                                         for k, v in net.state_dict().items()})
            sharded[name] = {"losses": out[True][0],
                             "rel_gap": _rel_gap(out[True][1], out[False][1])}
            if not sharded[name]["rel_gap"] <= OPT_HOLD_RTOL:
                bad.append((name + " offload", sharded[name]))
    finally:
        ts.OFFLOAD_SLICE = saved
        pdist.destroy_process_group()

    # LBFGS on a quadratic 0.5 x^T A x - b^T x, A of condition 100: five
    # steps of 4 iterations leave the iterate on its way (a converged one
    # sits at f32's noise floor, where the two devices' roundings alone
    # set the gap)
    q, _ = np.linalg.qr(rng.normal(size=(256, 256)))
    a = (q * np.linspace(1.0, 100.0, 256)) @ q.T
    b = rng.normal(size=256)
    solution = np.linalg.solve(a, b)

    def lbfgs(device):
        A = torch.as_tensor(a, dtype=torch.float32, device=device)
        bv = torch.as_tensor(b, dtype=torch.float32, device=device)
        xv = torch.nn.Parameter(torch.zeros(256, device=device))
        opt = popt.LBFGS(learning_rate=1.0, max_iter=4, history_size=10,
                         line_search_fn="strong_wolfe", parameters=[xv])

        def closure():
            opt.clear_grad()
            loss = 0.5 * xv @ (A @ xv) - bv @ xv
            loss.backward()
            return loss

        for _ in range(5):
            opt.step(closure)
        return xv.detach().cpu().double().numpy()

    want, got = lbfgs("cpu"), lbfgs("cuda")
    lb = {"rel_gap": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
          "max_gap": float(np.abs(got - want).max() / np.abs(want).max()),
          "from_solution": float(np.linalg.norm(want - solution)
                                 / np.linalg.norm(solution))}
    if not (lb["rel_gap"] <= OPT_HOLD_RTOL and lb["from_solution"] <= 0.2):
        bad.append(("LBFGS", lb))
    say(card, "optimizers hold " + json.dumps({
        "rtol": OPT_HOLD_RTOL, "eager_f32_3_steps": rows,
        "stage2_offload_vs_not": sharded, "lbfgs_5_steps": lb}))
    if bad:
        raise AssertionError(f"optimizers hold: {bad}")


# --------------------------------------------------------------------------- #
# phases 23-25: float16 mixed precision (PR 22)
# --------------------------------------------------------------------------- #

FP16_STEPS = 3
FP16_OVERFLOW_SCALE = 2.0 ** 40


def _fp16_eager_step(torch, model, loss_fn, opt, scaler, ids, labels):
    """One step of the reference's fp16 pattern: the forward under
    auto_cast(O2, float16), scaler.scale(loss).backward(),
    scaler.step(opt), scaler.update(), opt.clear_grad(). Returns the loss
    (a device tensor)."""
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O2", dtype="float16"):
        loss = loss_fn(model(ids), labels)
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return loss.detach()


def train_fp16(card, torch, train_line):
    """Phase 23. gpt3_1p3b at full width and depth, batch 4 x 2048, under
    amp.decorate(level="O2", dtype="float16") with AdamW's f32 master
    weights (decorate given the optimizer) and per-layer recompute, in the
    reference's eager fp16 loop (`_fp16_eager_step`, an
    amp.GradScaler at its default 2^16): a warm-up step, FP16_STEPS timed
    steps with the counters zeroed just before and read just after (phase
    5's flash and norm launches a step), a profile of one step. Then one
    step at a scale of 2^40 overflows fp16 in the backward (the inf
    reaches the scaler through the kernels, nothing clamps it): the
    parameters and their masters must stay bit for bit, the scale must
    halve; the scale is set back and two more steps must train (finite
    losses, parameters moved). Printed: the scale at every step, step time
    against phase 5's bf16 step, tokens/s, MFU, peak, busy share. Then 3
    steps of bench.py's gpt3_moe rung (`run_moe_rung`'s sizes, f32
    parameters) under auto_cast O2 fp16 with a GradScaler, so that the
    fp16 grouped GEMM runs forward and dlhs on a path: 16 grouped GEMMs,
    4 norm forwards and 4 dx a step. Returns (the gpt3 steps' launches,
    the moe steps')."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    cfg, per_step, _, _ = _train_config("gpt3_1p3b")
    B, S = 4, 2048
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    amp.decorate(model, opt, level="O2", dtype="float16")
    crit = GPTPretrainingCriterion(cfg)
    scaler = amp.GradScaler()
    named = dict(model.named_parameters())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    torch.cuda.synchronize()
    say(card, f"train_fp16 gpt3_1p3b: {sum(p.numel() for p in named.values())} "
              f"parameters ({sorted({str(p.dtype) for p in named.values()})}), "
              f"built in {time.perf_counter() - t0:.3f} s")

    def step():
        return _fp16_eager_step(torch, model, lambda lg, lb: crit(lg, lb), opt,
                                scaler, ids, labels)

    scales = [scaler._scale]
    t0 = time.perf_counter()
    losses = [step().item()]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    scales.append(scaler._scale)
    skipped = [bool(scaler._found_inf)]
    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = []
    for _ in range(FP16_STEPS):
        timed.append(step())
        skipped.append(bool(scaler._found_inf))
        scales.append(scaler._scale)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    losses += [l.item() for l in timed]
    want = _expected(**{k: v * FP16_STEPS for k, v in per_step.items()})
    step_s = total_s / FP16_STEPS
    flops = decoder_flops(cfg, B, S)
    line = {
        "model": "gpt3_1p3b", "recipe": "amp.decorate O2 float16 with AdamW "
        "f32 masters and f32 moments, auto_cast O2 float16, GradScaler, "
        "per-layer recompute, eager loop", "batch": B, "seq": S,
        "losses": losses, "scales": scales, "skipped": skipped,
        "warmup_step_s": warm_s, "timed_steps": FP16_STEPS, "step_s": step_s,
        "bf16_step_s_phase5": train_line["step_s"],
        "step_ratio_to_bf16": step_s / train_line["step_s"],
        "tokens_per_s": B * S / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_BF16, "peak_memory_gb": peak / 1e9,
        "launches": launches, "launches_per_step": per_step}
    say(card, "train_fp16 gpt3_1p3b (smoke run, not a benchmark) "
        + json.dumps(line))
    if launches != want:
        raise AssertionError(f"train_fp16: kernel launches {launches} over "
                             f"{FP16_STEPS} steps, expected {want}")
    if not all(math.isfinite(l) for l in losses) or all(skipped):
        raise AssertionError(f"train_fp16: losses {losses}, skipped {skipped}")
    profile_step(card, torch, step, "train_fp16 gpt3_1p3b step")

    # a forced overflow: fp16 gradients past 65504 become inf in the
    # backward's kernels and products, and the scaler must skip the step
    before = {k: p.detach().clone() for k, p in named.items()}
    masters = {k: opt._states[id(p)]["master"].clone() for k, p in named.items()
               if "master" in opt._states.get(id(p), {})}
    kept = scaler._scale
    scaler._scale = FP16_OVERFLOW_SCALE
    step()
    torch.cuda.synchronize()
    overflow = {"found_inf": bool(scaler._found_inf),
                "scale_after": scaler._scale,
                "parameters_unchanged": all(torch.equal(p.detach(), before[k])
                                            for k, p in named.items()),
                "masters_unchanged": all(
                    torch.equal(opt._states[id(named[k])]["master"], m)
                    for k, m in masters.items()),
                "masters": len(masters)}
    del masters
    scaler._scale = kept
    after = [step().item() for _ in range(2)]
    torch.cuda.synchronize()
    overflow.update(losses_after=after, scale_restored=kept,
                    scales_after=scaler._scale,
                    parameters_moved_after=not all(
                        torch.equal(p.detach(), before[k])
                        for k, p in named.items()))
    say(card, "train_fp16 forced overflow " + json.dumps(overflow))
    if not (overflow["found_inf"]
            and overflow["scale_after"] == FP16_OVERFLOW_SCALE / 2
            and overflow["parameters_unchanged"]
            and overflow["masters_unchanged"] and overflow["masters"]
            and all(math.isfinite(l) for l in after)
            and overflow["parameters_moved_after"]):
        raise AssertionError(f"train_fp16: the forced overflow {overflow}")
    del before, model, opt, named, scaler
    torch.cuda.empty_cache()

    # gpt3_moe in fp16: the fp16 grouped GEMM forward and dlhs on a path
    c = MOE_RUNG
    model = moe_decoder(torch, "cuda")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler()
    V = c["V"]
    ids = torch.as_tensor(rng.integers(0, V, (c["batch"], c["seq"])),
                          device="cuda")
    labels = torch.as_tensor(rng.integers(0, V, (c["batch"], c["seq"])),
                             device="cuda")

    def moe_loss(lg, lb):
        return F.cross_entropy(lg.reshape(-1, V), lb.reshape(-1, 1))

    losses = [_fp16_eager_step(torch, model, moe_loss, opt, scaler, ids,
                               labels).item()]  # warm-up
    _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [_fp16_eager_step(torch, model, moe_loss, opt, scaler, ids, labels)
             for _ in range(3)]
    torch.cuda.synchronize()
    moe_s = (time.perf_counter() - t0) / 3
    moe_launches = _counters()
    losses += [l.item() for l in timed]
    L = c["L"]
    moe_want = _expected(grouped_gemm=3 * 4 * L, fused_norm=3 * L,
                         fused_norm_dx=3 * L)
    say(card, "train_fp16 gpt3_moe (smoke run, not a benchmark) " + json.dumps({
        "model": "gpt3_moe", "recipe": "f32 parameters and AdamW moments, "
        "auto_cast O2 float16, GradScaler, eager loop", **MOE_RUNG,
        "losses": losses, "scale": scaler._scale, "step_s": moe_s,
        "tokens_per_s": c["batch"] * c["seq"] / moe_s,
        "mfu": moe_flops() / moe_s / PEAK_BF16, "launches": moe_launches}))
    if moe_launches != moe_want or not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train_fp16 gpt3_moe: launches {moe_launches} "
                             f"(expected {moe_want}), losses {losses}")
    del model, opt
    torch.cuda.empty_cache()
    return launches, moe_launches


def serve_fp16(card, torch):
    """Phase 24. fp16 serving. llama_7b at full width and depth in fp16
    (seed 0) through the paged engine over the 12-request mix of the bf16
    serve phases (16 rows, 512 tokens, page size 32): every RMSNorm,
    rotation and decode attention through its kernel in fp16 (the counts
    of phase 7), fp16 pages; then gpt3_1p3b in fp16 through the dense
    engine (the flash forward at Sq = 1 in fp16, ticks x 24). For each,
    `generate` on one greedy prompt of the mix, fed the engine's tokens:
    the first token equal and every later one within FP16_TIE_ULPS fp16
    steps of generate's top logit. Returns (the paged run's launches, the
    dense run's)."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    B, S, ps, n_req, max_new = 16, 512, 32, 12, 16
    out = []
    for which, paged in (("llama_7b", True), ("gpt3_1p3b", False)):
        cfg = getattr(models, which)()
        L = cfg.num_layers
        t0 = time.perf_counter()
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float16, seed=0)
        model.eval()
        kw = dict(page_size=ps) if paged else dict(paged=False)
        warm = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                     **kw)
        warm.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
        warm.run()
        del warm
        eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                    seed=0, **kw)
        kv = eng.pool.kv[0][0].dtype if paged else eng.kv_dtype
        workload = serving_workload(cfg.vocab_size, S, n_req)
        done, seconds, peak, launches = _drain(torch, eng, workload, max_new)
        line = _serve_line(eng, done, seconds, peak, launches)
        ticks = line["decode_ticks"]
        if paged:
            want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                             paged_decode_attention=ticks * L,
                             fused_rope=(n_req + ticks) * L)
        else:
            want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                             flash_fwd=ticks * L)
        by_prompt = {tuple(r.prompt): r.generated for r in done}
        prompt = next(p for p, temp in workload if temp == 0.0)
        engine_tokens = by_prompt[tuple(prompt)]
        steps = _teacher_forced_margins(torch, model, prompt, engine_tokens,
                                        "float16")
        bad = [i for i, st in enumerate(steps) if not st["ok"]]
        first_equal = steps[0]["argmax"] == engine_tokens[0]
        say(card, f"serve_fp16 {which} (smoke run, not a benchmark) "
            + json.dumps({"engine": "paged" if paged else "dense",
                          "dtype": "float16", "kv_dtype": str(kv),
                          "seconds_with_build": time.perf_counter() - t0,
                          **line, "generate_teacher_forced": steps,
                          "first_token_equal": first_equal}))
        if launches != want or kv != torch.float16:
            raise AssertionError(f"serve_fp16 {which}: launches {launches} "
                                 f"(expected {want}), kv {kv}")
        if not first_equal or bad:
            raise AssertionError(
                f"serve_fp16 {which}: generate fed the engine's tokens ranks "
                f"steps {bad} more than {FP16_TIE_ULPS} fp16 steps below its "
                f"top logit (first token equal: {first_equal})")
        out.append(launches)
        del eng, model
        torch.cuda.empty_cache()
    return tuple(out)


# unit roundoff of the half types (half the relative spacing at 1)
HALF_UNIT = {"bfloat16": 2 ** -8, "float16": 2 ** -11}
# Phase 25's limits, in units of the type's roundoff u: the card computes
# each op in the half type with f32 sums and rounds its output once (u
# relative), some 10 rounded ops deep through 2 layers and the head, so the
# loss (~10.8, a sum of lse - target over 256 tokens) moves by a few u of
# its terms and each gradient, through the same ops backwards, by some
# sqrt(20) to 20 u of its norm. Held: the losses within 8 u, each
# gradient's ||card - cpu|| within 32 u of the larger of its norm and 1e-3
# of the largest gradient's (a gradient that is analytically zero, the k
# biases', is rounding noise on both sides), and each parameter's AdamW
# update the same way within 64 u. A wrong mask, tile or rounding moves the
# gradients by O(1); the gradient limit is the one that catches a wrong
# kernel: at random init the loss sits near log V whatever the attention
# computes. The update's limit: AdamW's first step moves an entry by
# lr * g / (|g| + eps') (weight decay aside, the same on both sides), and
# with eps' at least the largest |g| that map is within a factor 2 of
# linear, so it at most doubles the gradient's relative error.
HALF_HOLD_LOSS_U = 8
HALF_HOLD_GRAD_U = 32
HALF_HOLD_STEP_U = 64
HALF_HOLD_LR = 1e-3


def train_half_holds(card, torch):
    """Phase 25. The bf16 and fp16 training steps on the card held against
    the CPU: 2 layers at gpt3_1p3b's widths (flash attention, recompute)
    and at llama_7bshape's (flashmask attention), batch 1 x 256, weights
    made on the CPU (seed 2) and rounded to values both half types hold
    exactly (to bf16, magnitudes below fp16's normal range flushed to 0).
    The card trains as phase 23 does: amp.decorate(level="O2") with the
    optimizer, so AdamW steps f32 master weights, in bf16, then in fp16
    under an amp.GradScaler (activations and gradients in the half type:
    the sm90 tensor-core kernels), one step each; the CPU takes the same
    step from the same weights and tokens in f32, once. AdamW's epsilon is
    the CPU's largest gradient entry, so that the first step's update
    follows each gradient's value and not only its sign, and a gradient
    left scaled (or unscaled twice) moves it. Held: the loss, each
    parameter's gradient and each parameter's update (the f32 master's
    move) (HALF_HOLD_*: limits in the type's unit roundoff). Prints each
    run's errors against its limits and its kernel launches, which must
    include the path's flash (or flashmask) forward, dq and dk/dv. Returns
    the fp16 runs' launches (the fp16 flashmask kernels' only path)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    B, S = 1, 256
    f16_launches = {}
    for which in ("gpt3_1p3b", "llama_7bshape"):
        cfg = dataclasses.replace(_train_config(which)[0], num_layers=2)
        attn = "flash" if which == "gpt3_1p3b" else "flashmask"
        rng = np.random.default_rng(4)
        ids = rng.integers(0, cfg.vocab_size, (B, S))
        labels = rng.integers(0, cfg.vocab_size, (B, S))
        t0 = time.perf_counter()
        cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=2)
        with torch.no_grad():
            for p in cpu.parameters():
                r = p.to(torch.bfloat16).float()
                p.copy_(torch.where(r.abs() < 2.0 ** -14, 0.0, r))
        state = {k: v.clone() for k, v in cpu.state_dict().items()}
        crit = GPTPretrainingCriterion(cfg)

        def rel(got, want):
            """Each tensor's ||got - want|| over the larger of its norm and
            1e-3 of the largest norm of `want`."""
            top = max(w.norm().item() for w in want.values())
            return {k: (got[k] - w).norm().item()
                    / max(w.norm().item(), 1e-3 * top)
                    for k, w in want.items()}

        loss = crit(cpu(torch.as_tensor(ids)), torch.as_tensor(labels))
        loss.backward()
        want_losses = [loss.item()]
        want_grads = {k: p.grad.clone() for k, p in cpu.named_parameters()}
        eps = max(g.abs().max().item() for g in want_grads.values())
        AdamW(learning_rate=HALF_HOLD_LR, epsilon=eps,
              parameters=cpu.parameters()).step()
        want_steps = {k: p.detach() - state[k]
                      for k, p in cpu.named_parameters()}
        cpu_s = time.perf_counter() - t0
        del cpu
        for dtype in ("bfloat16", "float16"):
            u = HALF_UNIT[dtype]
            model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                                   seed=2)
            model.load_state_dict(state)
            opt = AdamW(learning_rate=HALF_HOLD_LR, epsilon=eps,
                        parameters=model.parameters())
            amp.decorate(model, opt, level="O2", dtype=dtype)
            if not all(torch.equal(p.detach().float().cpu(), state[k])
                       for k, p in model.named_parameters()):
                raise AssertionError(f"half hold {which}: the weights are not "
                                     f"exact in {dtype}")
            _zero_counters()
            t0 = time.perf_counter()
            loss = crit(model(torch.as_tensor(ids, device="cuda")),
                        torch.as_tensor(labels, device="cuda"))
            if dtype == "float16":
                # fp16 runs as the reference's fp16 pattern does, under a
                # loss scale (GradScaler's 2^16): unscaled, many gradients of
                # these weights lie below fp16's normal range (6.1e-5) and
                # lose their low bits; a power-of-two scale changes nothing
                # else. scaler.step unscales the gradients in place.
                scaler = amp.GradScaler()
                scaler.scale(loss).backward()
                scaler.step(opt)
                if scaler._found_inf:
                    raise AssertionError(f"half hold {which}: an fp16 "
                                         "gradient overflowed at scale "
                                         f"{scaler._scale}")
                scaler.update()
            else:
                loss.backward()
                opt.step()
            torch.cuda.synchronize()
            launches = _counters()
            losses = [loss.item()]
            grads = {k: p.grad.float().cpu()
                     for k, p in model.named_parameters()}
            steps = {k: opt._states.get(id(p), {}).get("master", p).float().cpu()
                     - state[k] for k, p in model.named_parameters()}
            loss_rel = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, want_losses))
            grad_rel, step_rel = rel(grads, want_grads), rel(steps, want_steps)
            worst = max(grad_rel, key=grad_rel.get)
            worst_step = max(step_rel, key=step_rel.get)
            masters = sum("master" in st for st in opt._states.values())
            say(card, f"half hold {which} " + json.dumps({
                "model": f"{which} widths, 2 layers", "dtype": dtype,
                "batch": B, "seq": S, "optimizer": "AdamW, f32 masters",
                "lr": HALF_HOLD_LR, "epsilon": eps,
                "params_with_master": masters, "losses_cuda": losses,
                "losses_cpu_f32": want_losses,
                "max_loss_rel_diff": loss_rel,
                "loss_tol": HALF_HOLD_LOSS_U * u,
                "max_grad_rel_diff": grad_rel[worst], "worst_grad": worst,
                "grad_tol": HALF_HOLD_GRAD_U * u,
                "max_step_rel_diff": step_rel[worst_step],
                "worst_step": worst_step, "step_tol": HALF_HOLD_STEP_U * u,
                "seconds_cuda": time.perf_counter() - t0,
                "seconds_cpu": cpu_s, "launches": {
                    k: v for k, v in launches.items() if v}}))
            ran = all(launches[f"{attn}_{k}"] >= cfg.num_layers
                      for k in ("fwd", "bwd_dq", "bwd_dkv"))
            if dtype == "float16":
                f16_launches = {k: f16_launches.get(k, 0) + v
                                for k, v in launches.items()}
            if not (ran and masters and loss_rel <= HALF_HOLD_LOSS_U * u
                    and grad_rel[worst] <= HALF_HOLD_GRAD_U * u
                    and step_rel[worst_step] <= HALF_HOLD_STEP_U * u):
                raise AssertionError(f"half hold {which} {dtype}: the card's "
                                     "step disagrees with the CPU's (or did "
                                     f"not run {attn}'s kernels)")
            del model, opt
            torch.cuda.empty_cache()
    return f16_launches



# --------------------------------------------------------------------------- #
# phases 26-28: block-attention serving, the fused encoder, incubate calls
# --------------------------------------------------------------------------- #

BLHA_BLOCK = 64


class BlockAttentionDecoder:
    """A LLaMA-form GPTForCausalLM run as Paddle's block-attention inference
    runs a layer, from the model's own weights and the incubate
    functionals: fused_rms_norm; one fused_linear for q, k and v;
    block_multihead_attention over paged caches with rope_emb from the
    model's theta and rotary style; fused_linear for the output
    projection; fused_rms_norm with the residual; one fused_linear for gate
    and up; fused_bias_act("swiglu"); fused_linear for the down
    projection. Then the final fused_rms_norm and the untied head. `batch`
    rows of up to `max_len` tokens, each row its own ceil(max_len /
    block_size) pages of the layer's [n_pages, Hkv, block_size, D] caches.
    `prefill` runs every row's prompt in one padded call a layer, `tick`
    one decode step of every row; both return the next token's logits
    [B, V] in the model's dtype."""

    def __init__(self, torch, model, batch, max_len, block_size=BLHA_BLOCK):
        from paddle_tpu_torch.incubate.nn.functional import _rope_tables

        cfg = model.config
        if not (cfg.norm_type == "rmsnorm" and cfg.activation == "swiglu"
                and cfg.use_rope and not cfg.tie_word_embeddings):
            raise ValueError("BlockAttentionDecoder runs the LLaMA form")
        self.torch, self.cfg = torch, cfg

        def cat(*ws):
            return torch.cat([w.detach() for w in ws], dim=1)

        self.layers = [dict(
            ln1=ly.input_layernorm.weight.detach(),
            wqkv=cat(ly.self_attn.q_proj.weight, ly.self_attn.k_proj.weight,
                     ly.self_attn.v_proj.weight),
            wo=ly.self_attn.out_proj.weight.detach(),
            ln2=ly.post_attention_layernorm.weight.detach(),
            wgu=cat(ly.mlp.gate_proj.weight, ly.mlp.up_proj.weight),
            wd=ly.mlp.down_proj.weight.detach()) for ly in model.gpt.layers]
        self.embed = model.gpt.embed_tokens.weight.detach()
        self.final = model.gpt.final_norm.weight.detach()
        self.head = model.lm_head.weight.detach()
        dev, dt = self.embed.device, self.embed.dtype
        D, P = cfg.head_dim, -(-max_len // block_size)
        self.block_size = block_size
        self.tables = torch.arange(batch * P, dtype=torch.int32,
                                   device=dev).reshape(batch, P)
        self.caches = [tuple(torch.zeros(batch * P, cfg.kv_heads, block_size,
                                         D, dtype=dt, device=dev)
                             for _ in range(2)) for _ in self.layers]
        cos, sin = _rope_tables(P * block_size, D, cfg.rope_theta, device=dev)
        self.rope = torch.stack([cos, sin])[:, :, :, None, :]
        self.lens = torch.zeros(batch, dtype=torch.int32, device=dev)

    def _hidden(self, ids, enc, dec):
        from paddle_tpu_torch.incubate.nn import functional as IF

        eps = self.cfg.layer_norm_epsilon
        h = self.embed[ids]
        this = self.torch.where(enc > 0, enc, self.torch.ones_like(enc))
        for w, (kc, vc) in zip(self.layers, self.caches):
            y, _ = IF.fused_rms_norm(h, w["ln1"], epsilon=eps)
            att = IF.block_multihead_attention(
                IF.fused_linear(y, w["wqkv"]), kc, vc, enc, dec, this,
                block_tables=self.tables, rope_emb=self.rope,
                block_size=self.block_size,
                use_neox_style=self.cfg.use_neox_rotary_style)[0]
            y, h = IF.fused_rms_norm(IF.fused_linear(att, w["wo"]), w["ln2"],
                                     epsilon=eps, residual=h)
            a = IF.fused_bias_act(IF.fused_linear(y, w["wgu"]),
                                  act_method="swiglu")
            h = h + IF.fused_linear(a, w["wd"])
        return IF.fused_rms_norm(h, self.final, epsilon=eps)[0]

    def prefill(self, prompts):
        from paddle_tpu_torch.incubate.nn import functional as IF

        torch = self.torch
        dev = self.embed.device
        S = max(len(p) for p in prompts)
        ids = np.zeros((len(prompts), S), np.int64)
        for b, p in enumerate(prompts):
            ids[b, :len(p)] = p
        enc = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=dev)
        h = self._hidden(torch.as_tensor(ids, device=dev), enc,
                         torch.zeros_like(enc))
        self.lens = enc.clone()
        last = h[torch.arange(len(prompts), device=dev), (enc - 1).long()]
        return IF.fused_linear(last, self.head)

    def tick(self, tokens):
        from paddle_tpu_torch.incubate.nn import functional as IF

        h = self._hidden(tokens.reshape(-1, 1).long(),
                         self.torch.zeros_like(self.lens), self.lens)
        self.lens = self.lens + 1
        return IF.fused_linear(h[:, 0], self.head)


BLHA_TICKS = 16
# Phase 26's later bf16 tokens against `generate` fed them
# (`_teacher_forced_margins`), in bf16 steps at the top logit. The two
# paths compute one function in different shapes and orders (one qkv and
# one gate/up product against three and two, the norm of the f32 residual
# sum against the rounded one, SwiGLU rounded once against twice, bf16
# pages against f32 caches), so each of 32 layers x ~8 rounded ops moves
# the logits by its own 2^-9: ~sqrt(256) x 2^-9 ~ 3% of their spread
# (~1.3), 0.04 a logit, ~1.3 steps of 2^-5 at top logits of 4-8, and
# ~1.8 steps on the gap between two logits. BF16_TIE_ULPS (2 steps, set
# for gpt3_1p3b's 24 layers, where the products differ by batch shape
# only) is ~1.1 sigma of that and missed 9 of 192 steps in a run on the
# card; the limit here is 8 steps, ~4.4 sigma. It is a smoke bound:
# with random weights a wrong attention moves the logits by ~1% only
# (BF16_DECODE_LOGIT_RTOL's note), under one step, so the decoder's
# correctness at full depth is held in f32 (`blha_f32_full_depth`), where
# its tokens must be generate's, every one.
BLHA_TIE_ULPS = 8
# the int8-page tick against the f32-page tick on the same values (the CPU
# test's bound: the payloads round K and V to 1/2 of a step of amax / 127)
BLHA_Q8_REL, BLHA_Q8_ABS = 0.05, 1e-2
# the composite ticks on the card against the CPU in f32 (TF32 off)
BLHA_HOLD_TOL = 1e-5


def _blha_side_inputs(torch, device, B, H, D, lengths, P, seed=5):
    """A decode tick's inputs at llama_7b's attention shape from a seed:
    qkv [B, 1, 3 H D] f32, f32 pages holding each row's first
    lengths[b] tokens (the rest 0) under a block table of P pages a row,
    the per-head int8 scales sized to the data, and a prefix of 16
    tokens."""
    rng = np.random.default_rng(seed)
    bs = BLHA_BLOCK
    n = B * P
    kc = np.zeros((n, H, bs, D), np.float32)
    vc = np.zeros((n, H, bs, D), np.float32)
    for b, L in enumerate(lengths):
        for t in range(L):
            kc[b * P + t // bs, :, t % bs] = rng.standard_normal((H, D))
            vc[b * P + t // bs, :, t % bs] = rng.standard_normal((H, D))
    qkv = rng.standard_normal((B, 1, 3 * H * D)).astype(np.float32)
    amax = max(np.abs(kc).max(), np.abs(qkv).max())
    qs = np.full((H,), 127.0 / amax, np.float32)
    pre = rng.standard_normal((2, B, H, 16, D)).astype(np.float32)
    t = {k: torch.as_tensor(v, device=device) for k, v in dict(
        qkv=qkv, kc=kc, vc=vc, qs=qs, dqs=(1.0 / qs).astype(np.float32),
        pre=pre, tables=np.arange(n, dtype=np.int32).reshape(B, P),
        dec=np.asarray(lengths, np.int32)).items()}
    t["kc8"] = torch.clamp(torch.round(t["kc"] * t["qs"].reshape(1, H, 1, 1)),
                           -128, 127).to(torch.int8)
    t["vc8"] = torch.clamp(torch.round(t["vc"] * t["qs"].reshape(1, H, 1, 1)),
                           -128, 127).to(torch.int8)
    return t


def _blha_side_tick(torch, t, kind):
    """One decode tick of block_multihead_attention on `t`'s tensors:
    "f32" (f32 pages), "int8" (the int8 pages and scales) or "prefix"
    (f32 pages and the 16-token prefix). Returns (out, key pages)."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    B = t["dec"].shape[0]
    kw = dict(block_tables=t["tables"], block_size=BLHA_BLOCK)
    kc, vc = t["kc"].clone(), t["vc"].clone()
    if kind == "int8":
        kc, vc = t["kc8"].clone(), t["vc8"].clone()
        kw.update(cache_k_quant_scales=t["qs"], cache_v_quant_scales=t["qs"],
                  cache_k_dequant_scales=t["dqs"],
                  cache_v_dequant_scales=t["dqs"])
    elif kind == "prefix":
        kw.update(pre_key_cache=t["pre"][0], pre_value_cache=t["pre"][1])
    zeros = torch.zeros_like(t["dec"])
    out, _, kc, _ = IF.block_multihead_attention(
        t["qkv"], kc, vc, zeros, t["dec"], torch.ones_like(zeros), **kw)
    return out, kc


def blha_side_ticks(card, torch, lengths):
    """Phase 26's int8-page tick and prefix tick: at llama_7b's attention
    shape (B 12, 32 heads of 128, pages of BLHA_BLOCK, each row's cached
    tokens `lengths`), f32 inputs, on the card (the composite: no paged
    decode launch) and on the CPU. Held: the card's outputs within
    BLHA_HOLD_TOL of the CPU's, the int8 pages the CPU's bit for bit, and
    the int8 tick within the CPU test's bound (BLHA_Q8_*) of the f32-page
    tick."""
    from paddle_tpu_torch.ops import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, D = len(lengths), 32, 128
    P = -(-(max(lengths) + 1) // BLHA_BLOCK)
    res = {}
    for dev in ("cuda", "cpu"):
        t = _blha_side_inputs(torch, dev, B, H, D, lengths, P)
        res[dev] = {"f32": _blha_side_tick(torch, t, "f32")}
        before = da.LAUNCHES, da.Q8_LAUNCHES
        res[dev].update({k: _blha_side_tick(torch, t, k)
                         for k in ("int8", "prefix")})
        if dev == "cuda":
            torch.cuda.synchronize()
            composite = (da.LAUNCHES, da.Q8_LAUNCHES) == before
    err = {k: (res["cuda"][k][0].cpu() - res["cpu"][k][0]).abs().max().item()
           for k in ("int8", "prefix")}
    pages_equal = torch.equal(res["cuda"]["int8"][1].cpu(),
                              res["cpu"]["int8"][1])
    ref = res["cuda"]["f32"][0]
    q8_gap = (res["cuda"]["int8"][0] - ref).abs().max().item()
    q8_bound = BLHA_Q8_REL * ref.abs().max().item() + BLHA_Q8_ABS
    line = {"B": B, "heads": H, "D": D, "block_size": BLHA_BLOCK,
            "cached_tokens": lengths, "card_vs_cpu_max_abs_err": err,
            "tol": BLHA_HOLD_TOL, "int8_pages_equal": pages_equal,
            "int8_vs_f32_pages_max_abs": q8_gap, "int8_bound": q8_bound,
            "no_paged_decode_launch": composite}
    say(card, "serve_block_attention side ticks " + json.dumps(line))
    if not (composite and pages_equal and q8_gap <= q8_bound
            and max(err.values()) <= BLHA_HOLD_TOL):
        raise AssertionError("serve_block_attention: the int8 or prefix tick "
                             "disagrees (or launched the paged kernel)")


def serve_block_attention(card, torch):
    """Phase 26. llama_7b at full width and depth in bf16, seed 0, as phase
    `serve` builds it, served through `BlockAttentionDecoder` (pages of
    BLHA_BLOCK): the 12 prompts of the serving mix in one padded prefill
    call a layer, then BLHA_TICKS decode ticks of all 12 rows, greedy.
    Counters zeroed just before and read just after: the paged decode
    BLHA_TICKS x 32 times, the fused norm (1 + BLHA_TICKS) x 65 times,
    nothing else (the prefill attention is the composite). Each row's
    first token must equal the port's PagedServingEngine's on the same
    model, and each later one lie within BLHA_TIE_ULPS of generate's top
    logit fed the decoder's tokens (`_teacher_forced_margins`). Prints
    tokens/s, tick ms, peak memory and the busy share of 5 more ticks;
    then the same decoder in f32 (`blha_f32_full_depth`: every token
    generate's) and the int8-page and prefix ticks (`blha_side_ticks`)."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    cfg = models.llama_7b()
    L, ticks = cfg.num_layers, BLHA_TICKS
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    prompts = [p for p, _ in serving_workload(cfg.vocab_size, 512, 12)]
    dec = BlockAttentionDecoder(torch, model, len(prompts),
                                max(map(len, prompts)) + ticks + 8)
    torch.cuda.synchronize()
    say(card, f"serve_block_attention: llama_7b bf16 built in "
              f"{time.perf_counter() - t0:.3f} s")
    reset_peak(torch)
    _zero_counters()
    tick_s = []
    with torch.no_grad():
        t0 = time.perf_counter()
        tok = dec.prefill(prompts).argmax(-1)
        toks = [tok]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for _ in range(ticks):
            t1 = time.perf_counter()
            tok = dec.tick(tok).argmax(-1)
            toks.append(tok)
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t1)
        total_s = time.perf_counter() - t0
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    want = _expected(paged_decode_attention=ticks * L,
                     fused_norm=(1 + ticks) * (2 * L + 1))
    tokens = torch.stack(toks, 1).cpu().tolist()

    eng = create_serving_engine(model, max_batch_size=16, max_seq_len=512,
                                page_size=32, seed=0)
    for p in prompts:
        eng.add_request(p, max_new_tokens=1, temperature=0.0)
    first = {tuple(r.prompt): r.generated[0] for r in eng.run()}
    del eng
    mismatch = [b for b, p in enumerate(prompts)
                if first[tuple(p)] != tokens[b][0]]
    margins = [_teacher_forced_margins(torch, model, p, tokens[b])
               for b, p in enumerate(prompts)]
    steps = {(b, i): s["bf16_steps_below_top"] for b, m in enumerate(margins)
             for i, s in enumerate(m) if i}
    off_tie = [k for k, v in steps.items() if v > BLHA_TIE_ULPS]
    with torch.no_grad():
        prof = profile_step(card, torch, lambda: [dec.tick(tok)
                                                  for _ in range(5)],
                            "serve_block_attention 5 ticks")
    n_tok = len(prompts) * (1 + ticks)
    line = {"model": "llama_7b", "dtype": "bfloat16", "requests":
            len(prompts), "block_size": BLHA_BLOCK, "prompt_lens":
            [len(p) for p in prompts], "decode_ticks": ticks,
            "tokens": n_tok, "seconds": total_s, "tokens_per_s":
            n_tok / total_s, "prefill_s": prefill_s,
            "tick_ms_median": float(np.median(tick_s)) * 1e3,
            "tick_ms_max": max(tick_s) * 1e3, "peak_memory_gb": peak / 1e9,
            "busy_share_5_ticks": prof["device_busy_share"],
            "first_tokens_equal_engine": not mismatch,
            "later_tokens_off_the_tie": off_tie, "tie_steps": BLHA_TIE_ULPS,
            "later_tokens_over_BF16_TIE_ULPS": {
                f"{b},{i}": v for (b, i), v in steps.items()
                if v > BF16_TIE_ULPS},
            "later_tokens_not_generates_pick": sum(v > 0 for v in
                                                   steps.values()),
            "later_tokens": len(steps), "launches": launches}
    say(card, "serve_block_attention (smoke run, not a benchmark) "
              + json.dumps(line))
    if launches != want:
        raise AssertionError(f"serve_block_attention: launches {launches}, "
                             f"expected {want}")
    if mismatch or off_tie:
        raise AssertionError(f"serve_block_attention: first tokens differ "
                             f"from the engine's in rows {mismatch}, or "
                             f"later tokens off the tie at {off_tie}")
    del dec, model
    torch.cuda.empty_cache()
    blha_f32_full_depth(card, torch, prompts)
    blha_side_ticks(card, torch, [len(p) + 8 for p in prompts])
    return launches


def blha_f32_full_depth(card, torch, prompts):
    """`BlockAttentionDecoder` on llama_7b at full width and depth in f32
    (TF32 off; the paged decode kernel's f32 instantiation): its greedy
    tokens over the prefill and BLHA_TICKS ticks must equal, every one,
    those of `generate` (dense f32 caches, its own calls) on each
    prompt, where the two paths differ by f32 rounding only."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = GPTForCausalLM(models.llama_7b(), device="cuda",
                           dtype=torch.float32, seed=0)
    dec = BlockAttentionDecoder(torch, model, len(prompts),
                                max(map(len, prompts)) + BLHA_TICKS + 2)
    with torch.no_grad():
        tok = dec.prefill(prompts).argmax(-1)
        toks = [tok]
        for _ in range(BLHA_TICKS):
            tok = dec.tick(tok).argmax(-1)
            toks.append(tok)
        tokens = torch.stack(toks, 1).cpu().tolist()
    del dec
    torch.cuda.empty_cache()
    gen = [model.generate(np.asarray(p)[None], max_new_tokens=BLHA_TICKS + 1,
                          temperature=0.0)[0, len(p):].tolist()
           for p in prompts]
    differ = [b for b in range(len(prompts)) if tokens[b] != gen[b]]
    say(card, "serve_block_attention f32 " + json.dumps({
        "model": "llama_7b", "layers": models.llama_7b().num_layers,
        "requests": len(prompts), "new_tokens": BLHA_TICKS + 1,
        "rows_whose_tokens_differ_from_generate": differ,
        "seconds": time.perf_counter() - t0}))
    del model
    torch.cuda.empty_cache()
    if differ:
        raise AssertionError("serve_block_attention f32: the decoder's "
                             f"tokens differ from generate's in rows {differ}")


# bench.py's bert rung's widths and sizes, as FusedTransformerEncoderLayers
FUSED_ENCODER = dict(layers=12, d=768, heads=12, ffn=3072, batch=32, seq=512)
# the f32 hold: the loss, and each gradient's ||card - cpu|| over the
# larger of its norm and 1e-3 of the largest one's (phase 25's measure)
FUSED_HOLD_LOSS_RTOL = 1e-5


def fused_encoder(torch, layers, device, seed=0):
    """A Sequential of `layers` post-LN FusedTransformerEncoderLayers at
    FUSED_ENCODER's widths, gelu, dropouts 0, weights from `seed`."""
    from paddle_tpu_torch.incubate.nn import FusedTransformerEncoderLayer
    from paddle_tpu_torch.nn import Sequential

    gen = torch.Generator(device=device).manual_seed(seed)
    c = FUSED_ENCODER
    return Sequential(*[FusedTransformerEncoderLayer(
        c["d"], c["heads"], c["ffn"], dropout_rate=0.0, activation="gelu",
        generator=gen, device=device) for _ in range(layers)])


def train_fused_encoder(card, torch):
    """Phase 27. A stack of 12 FusedTransformerEncoderLayers at bert_base's
    widths (d 768, 12 heads, FFN 3072, gelu, post-LN, dropouts 0), batch
    32 x 512 of random f32 activations regressed onto a random target
    (mse_loss), AdamW lr 1e-4, AMP O2 bf16 (f32 parameters) through
    DistributedTrainStep: the counters zeroed just before a warm-up step
    and three timed steps and read just after them: 4 x 12 flash
    forwards, dQ and dK/dV (the kernel route of fused_multi_head_attention,
    D 64, no key bias) and nothing else. Prints the step time, peak and
    busy share. Then the f32 hold: 2 layers, batch 2 x 128, TF32 off, one
    forward and backward on the card (the f32 flash kernels) and on the
    CPU from the same weights: the loss within FUSED_HOLD_LOSS_RTOL, each
    gradient within TRAIN_HOLD_GRAD_TOL by phase 25's measure."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    c = FUSED_ENCODER
    B, S, timed = c["batch"], c["seq"], 3
    model = fused_encoder(torch, c["layers"], "cuda")
    step = DistributedTrainStep(
        model, lambda out, y: F.mse_loss(out, y),
        AdamW(learning_rate=1e-4, parameters=model.parameters()),
        amp_level="O2", amp_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, S, c["d"], device="cuda", generator=gen)
    y = torch.randn(B, S, c["d"], device="cuda", generator=gen)
    _zero_counters()
    reset_peak(torch)
    t0 = time.perf_counter()
    losses = [step(x, y).item()]
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    launches = _counters()
    peak = torch.cuda.max_memory_allocated()
    losses = losses[:1] + [v.item() for v in losses[1:]]
    n = (1 + timed) * c["layers"]
    want = _expected(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n)
    prof = profile_step(card, torch, lambda: step(x, y),
                        "train_fused_encoder step")
    say(card, "train_fused_encoder (smoke run, not a benchmark) " + json.dumps({
        "layers": c["layers"], "d": c["d"], "heads": c["heads"],
        "ffn": c["ffn"], "batch": B, "seq": S, "recipe": "AMP O2 bf16, "
        "f32 parameters and AdamW moments, lr 1e-4, dropouts 0, post-LN",
        "losses": losses, "warmup_step_s": warm_s, "step_s": step_s,
        "tokens_per_s": B * S / step_s, "peak_memory_gb": peak / 1e9,
        "busy_share": prof["device_busy_share"], "launches": launches}))
    if launches != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train_fused_encoder: launches {launches} "
                             f"(expected {want}), losses {losses}")
    del step, model
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(3)
    xh = rng.standard_normal((2, 128, c["d"])).astype(np.float32)
    yh = rng.standard_normal((2, 128, c["d"])).astype(np.float32)
    got, state = {}, None
    for dev in ("cuda", "cpu"):
        m = fused_encoder(torch, 2, dev, seed=2)
        if state is None:
            state = {k: v.cpu() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(state)
        loss = F.mse_loss(m(torch.as_tensor(xh, device=dev)),
                          torch.as_tensor(yh, device=dev))
        loss.backward()
        got[dev] = (loss.item(), {k: p.grad.cpu()
                                  for k, p in m.named_parameters()})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = got["cuda"], got["cpu"]
    top = max(g.norm().item() for g in g_cpu.values())
    rel = {k: (g_gpu[k] - g).norm().item() / max(g.norm().item(), 1e-3 * top)
           for k, g in g_cpu.items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    say(card, "train_fused_encoder hold " + json.dumps({
        "layers": 2, "batch": 2, "seq": 128, "dtype": "float32",
        "loss_cuda": l_gpu, "loss_cpu": l_cpu, "loss_rel_diff": loss_rel,
        "loss_rtol": FUSED_HOLD_LOSS_RTOL, "max_grad_rel_diff": rel[worst],
        "worst_grad": worst, "grad_tol": TRAIN_HOLD_GRAD_TOL}))
    if not (loss_rel <= FUSED_HOLD_LOSS_RTOL
            and rel[worst] <= TRAIN_HOLD_GRAD_TOL):
        raise AssertionError("train_fused_encoder hold: the card's step "
                             "disagrees with the CPU's")
    return launches


# phase 28: each call's card run against its CPU run in f32 (TF32 off),
# max |diff| over the reference's largest entry
INCUBATE_RTOL = 1e-4
# FusedMultiTransformer's cached decode against its uncached forward in
# bf16, over the uncached output's largest entry: a few bf16 steps
FMT_BF16_RTOL = 2 ** -5


def _rel_err(got, want):
    return ((got.float().cpu() - want.float().cpu()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def incubate_calls(card, torch):
    """Phase 28. One call each on the card, at a model's width, held
    against its CPU run in f32 (INCUBATE_RTOL) unless said: fused_moe at
    MOE_RUNG's widths (512 tokens; also weight_only_int8);
    variable_length_memory_efficient_attention at bert_base's (causal,
    ragged lengths, an additive mask); fused_gate_attention at an
    Evoformer row attention (256 x 256, 8 heads of 32, gating, a
    nonbatched bias); softmax_mask_fuse and its upper-triangle form on
    [4, 12, 512, 512] scores; fused_dot_product_attention at [32, 512, 12,
    64] in bf16 with a custom scale, exactly one flash forward and nothing
    else, held to the f32 composite within FLASH_TOL; FusedMultiTransformer
    at gpt3_1p3b's widths, depth 2, bf16: a 16-token prefill and one
    cached step against the uncached 17-token forward (FMT_BF16_RTOL);
    PTQ (calibrate, convert) and a QAT AdamW step on gpt3_tiny, card
    against CPU. Returns the launches of fused_dot_product_attention."""
    from paddle_tpu_torch import incubate, quantization
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_1p3b,
                                         gpt3_tiny)
    from paddle_tpu_torch.nn.functional._attn_math import masked_attention
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)

    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def both(fn, *arrays):
        """fn on the card and on the CPU: (card result, cpu result, s)."""
        t0 = time.perf_counter()
        outs = [fn(*[torch.as_tensor(a, device=d) for a in arrays])
                for d in ("cuda", "cpu")]
        torch.cuda.synchronize()
        return outs[0], outs[1], time.perf_counter() - t0

    rows, bad = {}, []

    def hold(name, got, want, tol=INCUBATE_RTOL, **extra):
        err = _rel_err(got, want)
        rows[name] = {"rel_err": err, "tol": tol, **extra}
        if not err <= tol:
            bad.append(name)

    E, K, M, H = (MOE_RUNG[k] for k in ("E", "topk", "M", "H"))
    moe = [arr(512, M), arr(M, E, scale=0.05), arr(E, M, 2 * H, scale=0.03),
           arr(E, H, M, scale=0.03)]
    g, c, s = both(lambda *t: IF.fused_moe(*t, moe_topk=K), *moe)
    hold("fused_moe", g, c, seconds=s)
    # int8 expert weights, one scale an (expert, output channel)
    s1, s2 = (np.abs(w).max(axis=1) / 127 for w in moe[2:])
    q1, q2 = (np.clip(np.round(w / sc[:, None]), -128, 127).astype(np.int8)
              for w, sc in zip(moe[2:], (s1, s2)))
    g, c, s = both(lambda x, gw, a, b, sa, sb: IF.fused_moe(
        x, gw, a, b, ffn1_scale=sa, ffn2_scale=sb,
        quant_method="weight_only_int8", moe_topk=K),
        moe[0], moe[1], q1, q2, s1, s2)
    hold("fused_moe_weight_only_int8", g, c, seconds=s)

    lens = np.asarray([512, 300, 77, 1], np.int32)
    g, c, s = both(lambda q, k, v, m, ql: IF.variable_length_memory_efficient_attention(
        q, k, v, ql, ql, mask=m, causal=True),
        arr(4, 12, 512, 64), arr(4, 12, 512, 64), arr(4, 12, 512, 64),
        arr(4, 1, 512, 512), lens)
    hold("variable_length_memory_efficient_attention", g, c, seconds=s)

    gate = [arr(1, 64, 256, 256), arr(3, 8, 32, 256, scale=0.06),
            arr(256, 8, 32, scale=0.06), arr(8, 32), arr(8, 32, 256,
                                                          scale=0.06),
            arr(256), arr(1, 8, 256, 256), arr(1, 64, 1, 1, 256)]
    g, c, s = both(lambda q, w, gw, gb, ow, ob, nb, m: IF.fused_gate_attention(
        q, qkv_weight=w, gate_linear_weight=gw, gate_linear_bias=gb,
        out_linear_weight=ow, out_linear_bias=ob, nonbatched_bias=nb,
        attn_mask=m), *gate)
    hold("fused_gate_attention", g, c, seconds=s)

    sc = [arr(4, 12, 512, 512), arr(4, 1, 512, 512)]
    g, c, s = both(incubate.softmax_mask_fuse, *sc)
    hold("softmax_mask_fuse", g, c, seconds=s)
    g, c, s = both(incubate.softmax_mask_fuse_upper_triangle, sc[0])
    hold("softmax_mask_fuse_upper_triangle", g, c, seconds=s)

    q, k, v = (torch.as_tensor(arr(32, 512, 12, 64), device="cuda").to(
        torch.bfloat16) for _ in range(3))
    _zero_counters()
    out = IF.fused_dot_product_attention(q, k, v, scaling_factor=0.1)
    torch.cuda.synchronize()
    launches = _counters()
    ref = masked_attention(q.float(), k.float(), v.float(), scale=0.1)
    err = (out.float() - ref).abs().max().item()
    rows["fused_dot_product_attention"] = {
        "max_abs_err": err, "tol": FLASH_TOL["bfloat16"], "launches": launches}
    if err > FLASH_TOL["bfloat16"] or launches != _expected(flash_fwd=1):
        bad.append("fused_dot_product_attention")

    cfg = gpt3_1p3b()
    gen = torch.Generator(device="cuda").manual_seed(3)
    fmt = FusedMultiTransformer(cfg.hidden_size, cfg.num_heads,
                                cfg.ffn_size, num_layers=2, generator=gen,
                                device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():   # GPT's N(0, 0.02) in place of the stacked fans
        for name, p in fmt.named_parameters():
            if name.endswith("weight"):
                p.normal_(0.0, cfg.initializer_range, generator=gen)
    src = torch.as_tensor(arr(4, 17, cfg.hidden_size), device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        full = fmt(src)
        caches = fmt.init_caches(4, 32, dtype=torch.bfloat16)
        fmt(src[:, :16], caches=caches)
        step_out, _ = fmt(src[:, 16:], caches=caches, time_step=16)
    hold("fused_multi_transformer_cached_decode", step_out[:, 0],
         full[:, 16], tol=FMT_BF16_RTOL, widths="gpt3_1p3b, 2 layers")
    del fmt, caches

    tiny = gpt3_tiny()
    ids = rng.integers(0, tiny.vocab_size, (2, 32))
    # one set of weights for both devices (the generators of the two
    # devices draw different numbers from one seed)
    state = GPTForCausalLM(tiny, device="cpu", seed=0).state_dict()

    def tiny_model(dev):
        m = GPTForCausalLM(tiny, device=dev)
        m.load_state_dict(state)
        return m

    ptq_out = {}
    for dev in ("cuda", "cpu"):
        m = tiny_model(dev)
        x = torch.as_tensor(ids, device=dev)
        with torch.no_grad():
            f32 = m(x)
            ptq = quantization.PTQ()
            ptq.quantize(m)
            m(x)
            ptq.convert(m)
            n_q = sum(isinstance(s, quantization.QuantizedLinear)
                      for s in m.modules())
            ptq_out[dev] = (m(x), f32, n_q, ptq.activation_scales(),
                            {k: b.cpu() for k, b in m.named_buffers()
                             if k.endswith("weight_quant")})
        qm = tiny_model(dev)
        quantization.QAT().quantize(qm)
        opt = AdamW(learning_rate=1e-3, parameters=qm.parameters())
        w0 = qm.gpt.layers[0].self_attn.q_proj.weight.detach().clone()
        loss = GPTPretrainingCriterion(tiny)(qm(x), x)
        loss.backward()
        untouched = torch.equal(qm.gpt.layers[0].self_attn.q_proj.weight, w0)
        opt.step()
        moved = not torch.equal(qm.gpt.layers[0].self_attn.q_proj.weight, w0)
        ptq_out[dev] += (loss.item(), untouched and moved)
    (gq, gf, gn, gs, gw, gl, gok), (cq, cf, cn, cs, cw, cl, cok) = (
        ptq_out["cuda"], ptq_out["cpu"])
    hold("ptq_logits", gq, cq, n_quantized=gn)
    int8_err = _rel_err(gq, gf)
    scale_err = max(abs(gs[k] - cs[k]) / cs[k] for k in cs)
    rows["ptq"] = {"layers_converted": gn, "int8_vs_f32_rel": int8_err,
                   "payloads_equal": all(torch.equal(gw[k], cw[k]) for k in cw),
                   "activation_scale_rel_diff": scale_err,
                   "qat_loss_cuda": gl, "qat_loss_cpu": cl,
                   "qat_weight_kept_then_stepped": gok and cok}
    if not (gn == cn == 12 and rows["ptq"]["payloads_equal"]
            and int8_err < 0.15 and scale_err <= INCUBATE_RTOL
            and abs(gl - cl) <= INCUBATE_RTOL * abs(cl) and gok and cok):
        bad.append("ptq/qat")
    say(card, "incubate_calls " + json.dumps(rows))
    if bad:
        raise AssertionError(f"incubate_calls: {bad} disagree")
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 29: bench.py's gpt3_1p3b recipe in Paddle's own idiom
# --------------------------------------------------------------------------- #

def _idiom_model(paddle, cfg, dev, seed=0):
    """gpt3 under the Paddle idiom: the device set with paddle.set_device,
    the model, criterion and AdamW (lr 1e-4) made as a Paddle script makes
    them."""
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion

    paddle.set_device(dev)
    paddle.seed(seed)
    model = GPTForCausalLM(cfg, seed=seed)
    return model, GPTPretrainingCriterion(cfg)


def _idiom_step(paddle, model, crit, opt, ids, labels, amp_on):
    """One eager step in Paddle's idiom; returns the loss as a float."""
    from paddle_tpu_torch import amp

    ctx = amp.auto_cast(True, level="O2", dtype="bfloat16") if amp_on else \
        contextlib.nullcontext()
    with ctx:
        loss = crit(model(ids), labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss)


def paddle_idiom(card, torch, train_line):
    """Phase 29. bench.py's gpt3_1p3b recipe (`_decoder_step`,
    `run_gpt_rung`) written against the port as a Paddle user writes it:
    `import paddle_tpu_torch as paddle`, `paddle.seed(0)`,
    `paddle.to_tensor` batches on the card.

    a. the compiled step, DistributedTrainStep(...)(ids, labels) with
       `float(loss)`: a warm-up, 3 timed steps; step time beside phase 5's,
       peak memory, the five kernels' launches (as phase 5's, exactly);
    b. the eager loop at the same size: crit(model(ids), labels),
       backward, opt.step(), opt.clear_grad() under auto_cast O2, 2 steps
       with the same launches; one inside collect_operator_stats(), whose
       op list must hold the kernels under the reference's names, one
       report per launch;
    c. 2 layers at the width in f32 (TF32 off): the eager loop on the card
       against the same loop on the CPU from the same weights
       (set_state_dict), 3 AdamW steps; the losses and step-1 gradients
       within phase 6's limits, the parameters within lr a step;
    e. paddle.save of the 2-layer model's state_dict (after amp.decorate
       O2: bf16 and f32 tensors), paddle.load, set_state_dict into a fresh
       model: every tensor equal bit for bit;
    d. the tensor checker: one eager 2-layer step with one fc1 weight set
       to inf under enable_tensor_checker(CHECK_NAN_INF_AND_ABORT) raises
       NumericError naming `linear`; after disable_tensor_checker() the
       same step runs through with no hook."""
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.framework import core

    cfg, per_step, _, _ = _train_config("gpt3_1p3b")
    B, S, timed, eager = 4, 2048, 3, 2
    t_phase = time.perf_counter()

    # a. the compiled step, as bench.py calls it
    t0 = time.perf_counter()
    model, crit = _idiom_model(paddle, cfg, "gpu")
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = optimizer.AdamW(learning_rate=1e-4, moment_dtype="bfloat16",
                          parameters=model.parameters())
    step = DistributedTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                                amp_level="O2", amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    labels = paddle.to_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    if ids.place != paddle.CUDAPlace(0) or ids.dtype != paddle.int64:
        raise AssertionError(f"paddle idiom: ids on {ids.place} {ids.dtype}")
    build_s = time.perf_counter() - t0
    warm = float(step(ids, labels))
    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(step(ids, labels)) for _ in range(timed)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    compiled = _counters()
    want = _expected(**{k: v * timed for k, v in per_step.items()})
    if compiled != want:
        raise AssertionError(f"paddle idiom compiled step: launches "
                             f"{compiled}, expected {want}")
    line_a = {"build_s": build_s, "warmup_loss": warm, "losses": losses,
              "step_s": step_s, "phase5_step_s": train_line["step_s"],
              "ratio_to_phase5": step_s / train_line["step_s"],
              "tokens_per_s": B * S / step_s,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "launches": compiled, "launches_per_step": per_step}
    say(card, "paddle idiom compiled step " + json.dumps(line_a))

    # b. the eager loop at the same size, one step under the op statistics
    _zero_counters()
    reset_peak(torch)
    times, eager_losses = [], []
    for i in range(eager):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == eager - 1:
            before = _counters()
            with debugging.collect_operator_stats():
                eager_losses.append(_idiom_step(paddle, model, crit, opt, ids,
                                                labels, True))
                stats = debugging.operator_stats()
            in_stats = {k: v - before[k] for k, v in _counters().items()}
        else:
            eager_losses.append(_idiom_step(paddle, model, crit, opt, ids,
                                            labels, True))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    eager_launches = _counters()
    want = _expected(**{k: v * eager for k, v in per_step.items()})
    if eager_launches != want:
        raise AssertionError(f"paddle idiom eager loop: launches "
                             f"{eager_launches}, expected {want}")
    if core.op_check_hook() is not None:
        raise AssertionError("paddle idiom: a hook left installed")
    # each kernel under the reference's op name, one report per launch
    names = {"flash_attention": "flash_fwd",
             "flash_attention_grad": "flash_bwd_dq",
             "layer_norm": "fused_norm", "layer_norm_grad": "fused_norm_dx"}
    # (a call counts once under each dtype among its outputs)
    counts = {op: max(stats.get(op, {}).values(), default=0) for op in names}
    if (any(counts[op] != in_stats[k] for op, k in names.items())
            or in_stats["flash_bwd_dkv"] != counts["flash_attention_grad"]):
        raise AssertionError(f"paddle idiom: op list {counts} against the "
                             f"launches {in_stats}")
    if not all(math.isfinite(x) for x in losses + eager_losses):
        raise AssertionError(f"paddle idiom: losses {losses} {eager_losses}")
    line_b = {"losses": eager_losses, "step_s": times,
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "launches": eager_launches,
              "op_count": sum(sum(v.values()) for v in stats.values()),
              "ops": {k: v for k, v in sorted(stats.items())}}
    say(card, "paddle idiom eager loop " + json.dumps(line_b))
    paths = {k: compiled[k] + eager_launches[k] for k in compiled}
    del step, model, opt, crit, ids, labels
    gc.collect()
    torch.cuda.empty_cache()

    # c. the 2-layer f32 hold, card against CPU
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B2, S2, steps, lr = 2, 256, 3, 1e-4
    rng = np.random.default_rng(4)
    ids_np = rng.integers(0, cfg2.vocab_size, (B2, S2))
    labels_np = rng.integers(0, cfg2.vocab_size, (B2, S2))
    results, params, state, models = {}, {}, None, {}
    for dev in ("gpu", "cpu"):
        t0 = time.perf_counter()
        model, crit = _idiom_model(paddle, cfg2, dev, seed=2)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        elif model.set_state_dict(state) != ([], []):
            raise AssertionError("paddle idiom: the state did not load")
        opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters())
        x, y = paddle.to_tensor(ids_np), paddle.to_tensor(labels_np)
        grads, losses2 = {}, []
        for i in range(steps):
            loss = crit(model(x), y)
            loss.backward()
            if i == 0:
                grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses2.append(float(loss))
        key = "cuda" if dev == "gpu" else "cpu"
        results[key] = (losses2, grads, time.perf_counter() - t0)
        params[key] = {k: p.detach().cpu() for k, p in model.named_parameters()}
        models[key] = (model, crit, x, y)
    paddle.set_device("gpu")
    _hold_verdict(card, "gpt3_1p3b paddle idiom", results, B2, S2)
    # each AdamW step moves an element by about lr, so two runs from one
    # state that disagree only by rounding (the k-projection biases, whose
    # gradient is analytically zero, are rounding noise on either side)
    # differ by at most lr a step
    gaps = {k: (params["cuda"][k] - p).abs().max().item()
            for k, p in params["cpu"].items()}
    worst = max(gaps, key=gaps.get)
    say(card, "paddle idiom hold parameters " + json.dumps({
        "steps": steps, "lr": lr, "max_abs_diff": gaps[worst],
        "worst": worst, "limit": lr * steps}))
    if gaps[worst] > lr * steps:
        raise AssertionError(f"paddle idiom: parameters part by {gaps[worst]} "
                             f"at {worst}")
    del models["cpu"], params

    # e. save and load, bit for bit, bf16 and f32 tensors
    model, crit, x, y = models["cuda"]
    amp.decorate(model, level="O2", dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gpt.pdparams")
        t0 = time.perf_counter()
        paddle.save(model.state_dict(), path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = paddle.load(path)
        load_s = time.perf_counter() - t0
    fresh, _ = _idiom_model(paddle, cfg2, "gpu", seed=7)
    amp.decorate(fresh, level="O2", dtype="bfloat16")
    if fresh.set_state_dict(loaded) != ([], []):
        raise AssertionError("paddle idiom: the saved state did not load")
    mine, back = model.state_dict(), fresh.state_dict()
    unequal = [k for k, v in mine.items()
               if v.dtype != back[k].dtype or not torch.equal(v, back[k])]
    dtypes = sorted({str(v.dtype) for v in back.values()})
    say(card, "paddle idiom save/load " + json.dumps({
        "tensors": len(mine), "dtypes": dtypes, "file_bytes": nbytes,
        "save_s": save_s, "load_s": load_s, "unequal": unequal}))
    if unequal or "torch.bfloat16" not in dtypes:
        raise AssertionError(f"paddle idiom: save/load changed {unequal}")
    del fresh, loaded, back, mine

    # d. the tensor checker on a planted inf (f32 weights again)
    model.float()
    opt = optimizer.AdamW(learning_rate=lr, parameters=model.parameters())
    with torch.no_grad():
        model.gpt.layers[0].mlp.fc1.weight[0, 0] = float("inf")
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig(
        True, debug_mode=debugging.DebugMode.CHECK_NAN_INF_AND_ABORT))
    try:
        _idiom_step(paddle, model, crit, opt, x, y, False)
    except debugging.NumericError as e:
        raised = str(e)
    else:
        raise AssertionError("paddle idiom: the tensor checker let an inf "
                             "weight through")
    finally:
        debugging.disable_tensor_checker()
    if "`linear`" not in raised or core.op_check_hook() is not None:
        raise AssertionError(f"paddle idiom: checker said {raised!r}")
    unchecked = _idiom_step(paddle, model, crit, opt, x, y, False)
    say(card, "paddle idiom tensor checker " + json.dumps({
        "raised": raised, "hook_after_disable": core.op_check_hook(),
        "unchecked_loss": unchecked}))
    del models, model, opt, crit
    gc.collect()
    torch.cuda.empty_cache()
    say(card, f"paddle idiom: {time.perf_counter() - t_phase:.1f} s")
    return paths


# --------------------------------------------------------------------------- #
# phase 30: the train cell under the telemetry, and a save and resume
# --------------------------------------------------------------------------- #

# the kernels of a training step by their C++ names in the device trace
# (the names phase 1's ptxas lines print), for the device Kernel Summary
TRAIN_KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_sm90_kernel",
                        "flash_bwd_dq": "flash_bwd_dq_sm90_kernel",
                        "flash_bwd_dkv": "flash_bwd_dkv_sm90_kernel",
                        "fused_norm": "norm_fwd_", "fused_norm_dx": "norm_bwd_dx_"}
RESUME_RTOL = 1e-4   # phase 6's limit for the continued losses


def _checkpoint_root(torch, need, prefix="phase30_ckpt_"):
    """A directory with at least `need` bytes free for the checkpoint: the
    temporary directory, else the gitignored build directory of the
    checkout. Raises naming the shortfall."""
    import shutil
    import tempfile

    from paddle_tpu_torch.ops import _build

    cands = [tempfile.gettempdir(), str(_build.BUILD_DIR)]
    free = {}
    for d in cands:
        os.makedirs(d, exist_ok=True)
        free[d] = shutil.disk_usage(d).free
        if free[d] >= need:
            return tempfile.mkdtemp(prefix=prefix, dir=d), free
    raise AssertionError(f"{prefix}: the checkpoints need {need} bytes "
                         f"free; free: {free}")


def _seconds(reg, since, family):
    """{label value: seconds} of a `..._seconds_total{part=}` family's
    window."""
    d = reg.delta(since)
    pre = family + "{part="
    return {k[len(pre):-1]: v for k, v in d.items() if k.startswith(pre)}


def observed_train_and_resume(card, torch, train_line):
    """Phase 30 (see the module docstring): the train cell under the
    StepTimeline, the profiler's device trace and Kernel Summary, a save
    and resume of its full training state, the paged engine under the
    timeline, and the comm watchdog on the card's host. Returns the launch
    counts of its counted windows, summed."""
    import gzip
    import shutil

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import comm_watchdog
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.framework import native
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.profiler import statistic

    cfg, per_step, _, recipe_text = _train_config("gpt3_1p3b")
    B, S, timed = 4, 2048, 3
    L = cfg.num_layers
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "phase30")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    reg = _registry()
    paths = []   # the launch counts of every counted window

    # (e) the watchdog's host library, built here with the host compiler
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    comm_watchdog.disable()
    comm_watchdog.enable(timeout_seconds=600)
    say(card, "observed watchdog " + json.dumps({
        "library": os.path.relpath(str(lib), os.path.dirname(out_dir)),
        "build_s": build_s, "timeout_s": 600}))

    t0 = time.perf_counter()
    model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0,
                                  "gpt3_1p3b")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0

    # (a) bench.py --emit-metrics: a warm-up, then timed steps, each between
    # step_begin and step_end (bench.py _timed_steps)
    jsonl = os.path.join(out_dir, "steps.jsonl")
    tl = obs.enable_step_timeline(jsonl_path=jsonl)
    try:
        losses = [step(ids, labels).item()]
        _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records, last = [], None
        for i in range(timed):
            tl.step_begin(i)
            last = step(ids, labels)
            records.append(tl.step_end())
        losses.append(float(last))
        total_s = time.perf_counter() - t0
        launches = _counters()
    finally:
        tl.uninstall()
    paths.append(launches)
    want = _expected(**{k: v * timed for k, v in per_step.items()})
    on_disk = [json.loads(ln) for ln in open(jsonl)]
    step_s = total_s / timed
    keys = sorted(records[0])
    line = {"recipe": recipe_text, "built_s": built_s, "step_s": step_s,
            "phase5_step_s": train_line["step_s"],
            "ratio_to_phase5": step_s / train_line["step_s"],
            "record_keys": keys, "jsonl_records": len(on_disk),
            "records": [{"step": r["step"], "dur_s": r["dur_s"],
                         "host_syncs": r["host_syncs"],
                         "spans": [sp["name"] for sp in r["spans"]],
                         "comm_tasks": [t["desc"] for t in r["comm_tasks"]],
                         "overlap_fraction": r["overlap_fraction"]}
                        for r in records],
            "interstep_syncs": tl.interstep_syncs, "launches": launches}
    say(card, "observed emit_metrics gpt3_1p3b " + json.dumps(line))
    if launches != want:
        raise AssertionError(f"observed emit_metrics: launches {launches}, "
                             f"expected {want}")
    if [r["step"] for r in on_disk] != list(range(timed)) or any(
            "train_step/compiled" not in [sp["name"] for sp in r["spans"]]
            for r in on_disk) or "dispatch" in keys:
        raise AssertionError(f"observed emit_metrics: records {line['records']}")

    # (b) the profiler with the GPU target over two steps, the second
    # recorded; the recorded step's kernel calls against the counters
    dev_dir, host_dir = (os.path.join(out_dir, d) for d in ("device", "host"))
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=profiler.make_scheduler(closed=0, ready=1, record=1),
        on_trace_ready=profiler.export_chrome_tracing(host_dir),
        device_trace_dir=dev_dir)
    prof.start()
    losses.append(step(ids, labels).item())
    torch.cuda.synchronize()   # the window opens on an idle device
    prof.step()
    _zero_counters()
    t0 = time.perf_counter()
    last = step(ids, labels)
    torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    recorded = _counters()
    prof.step()
    prof.stop()
    losses.append(float(last))
    paths.append(recorded)
    trace = prof.device_trace_path
    agg = statistic.parse_device_trace(trace)
    events = json.load(open(trace))["traceEvents"]
    names = {e.get("name") for e in events}
    summary_calls = {k: sum(d["calls"] for n, d in agg.items() if sym in n)
                     for k, sym in TRAIN_KERNEL_SYMBOLS.items()}
    device_ms = sum(d["total"] for d in agg.values()) / 1e6
    top = sorted(agg.items(), key=lambda kv: -kv[1]["total"])[:10]
    with open(trace, "rb") as f, gzip.open(trace + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    raw_bytes = os.path.getsize(trace)
    os.remove(trace)
    summary = prof.summary().splitlines()
    line = {"profiled_step_s": profiled_s, "device_kernel_ms": device_ms,
            "kernel_names": len(agg), "trace_bytes": raw_bytes,
            "trace_gz": os.path.relpath(trace + ".gz", os.path.dirname(out_dir)),
            "spans_in_trace": sorted(n for n in names if isinstance(n, str)
                                     and n.startswith("train_step/")),
            "summary_calls": summary_calls,
            "launches": {k: recorded[k] for k in per_step},
            "top10": [{"kernel": n[:120], "calls": d["calls"],
                       "total_ms": d["total"] / 1e6} for n, d in top],
            "summary_head": summary[:4]}
    say(card, "observed profiler gpt3_1p3b " + json.dumps(line))
    if summary_calls != per_step or recorded != _expected(**per_step):
        raise AssertionError(f"observed profiler: the Kernel Summary's calls "
                             f"{summary_calls} against the launch counters "
                             f"{recorded} over the recorded step ({per_step})")
    if "train_step/compiled" not in names:
        raise AssertionError("observed profiler: the device trace lacks the "
                             "observability spans")

    # (c) checkpoint after step k, two steps while it writes, a fresh step
    # restored; every tensor bit for bit, the next two losses against these
    k = step.optimizer._step_count   # the steps taken so far
    state = step.train_state()
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    root, free = _checkpoint_root(torch, 2 * nbytes)
    say(card, "observed checkpoint disk " + json.dumps({
        "root": root, "free_bytes": free, "state_bytes": nbytes}))
    try:
        saved = {n: t.detach().clone() for n, t in state.items()}
        mgr = CheckpointManager(root, keep_last_n=1, async_save=True)
        since = reg.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state, k)
        stall_s = time.perf_counter() - t0
        _zero_counters()
        cont = [step(ids, labels).item() for _ in range(2)]
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        paths.append(_counters())
        save_parts = _seconds(reg, since, "checkpoint_save_seconds_total")
        file_bytes = int(reg.delta(since).get(
            'checkpoint_bytes_total{op=save}', 0))
        del step, model, state
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        model, _, fresh = _train_setup(torch, cfg, "cuda", torch.float32, 1,
                                       "gpt3_1p3b")
        torch.cuda.synchronize()
        rebuilt_s = time.perf_counter() - t0
        since = reg.snapshot()
        t0 = time.perf_counter()
        got_step = mgr.restore_latest(fresh.train_state())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        load_parts = _seconds(reg, since, "checkpoint_load_seconds_total")
        restored = fresh.train_state()
        diff = [n for n, t in saved.items()
                if not torch.equal(t.view(torch.int16) if t.dtype in
                                   (torch.bfloat16, torch.float16) else t,
                                   restored[n].view(torch.int16) if t.dtype in
                                   (torch.bfloat16, torch.float16)
                                   else restored[n])]
        del saved, restored
        _zero_counters()
        resumed = [fresh(ids, labels).item() for _ in range(2)]
        paths.append(_counters())
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, cont))
        gb = nbytes / 1e9
        line = {
            "saved_after_step": k, "restored_step": got_step,
            "state_bytes": nbytes, "file_bytes": file_bytes,
            "snapshot_stall_s": stall_s,
            "snapshot_gb_per_s": gb / stall_s, "wait_after_2_steps_s": wait_s,
            "save_parts_s": save_parts,
            "write_gb_per_s": gb / save_parts.get("write", float("nan")),
            "shard_crc_gb_per_s": gb / save_parts.get("shard_crc", float("nan")),
            "file_crc_gb_per_s": gb / save_parts.get("file_crc", float("nan")),
            "rebuilt_s": rebuilt_s, "load_s": load_s, "load_parts_s": load_parts,
            "load_gb_per_s": gb / load_s,
            "mismatched_tensors": diff[:5], "n_mismatched": len(diff),
            "uninterrupted_losses": cont, "resumed_losses": resumed,
            "bit_identical": resumed == cont, "max_loss_rel_diff": rel,
            "loss_rtol": RESUME_RTOL, "losses": losses}
        say(card, "observed checkpoint gpt3_1p3b " + json.dumps(line))
        if got_step != k or diff:
            raise AssertionError(f"observed checkpoint: restored step "
                                 f"{got_step} (saved {k}), {len(diff)} "
                                 f"tensors differ: {diff[:5]}")
        if rel > RESUME_RTOL:
            raise AssertionError(f"observed checkpoint: resumed losses "
                                 f"{resumed} against {cont}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del fresh, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the paged engine over phase 3's mix, a timeline record and a
    # registry export a tick (bench.py _drain_serving_engine)
    scfg = gpt3_1p3b()
    Bs, Ss, ps, n_req, max_new = 16, 512, 32, 12, 16
    smodel = GPTForCausalLM(scfg, device="cuda", dtype=torch.bfloat16, seed=0)
    warm = create_serving_engine(smodel, max_batch_size=Bs, max_seq_len=Ss,
                                 page_size=ps)
    warm.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    warm.run()
    del warm
    eng = create_serving_engine(smodel, max_batch_size=Bs, max_seq_len=Ss,
                                page_size=ps, seed=0)
    for prompt, temp in serving_workload(scfg.vocab_size, Ss, n_req):
        eng.add_request(prompt, max_new_tokens=max_new, temperature=temp)
    serve_jsonl = os.path.join(out_dir, "serve.jsonl")
    torch.cuda.synchronize()
    _zero_counters()
    since = reg.snapshot()
    tl = obs.enable_step_timeline(jsonl_path=os.path.join(out_dir,
                                                          "serve_ticks.jsonl"))
    tick, t0 = 0, time.perf_counter()
    try:
        while eng.has_work():
            tl.step_begin(tick)
            eng.step()
            tl.step_end(extra={"rung": "serving"})
            reg.export_jsonl(serve_jsonl)
            tick += 1
    finally:
        tl.uninstall()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _counters()
    paths.append(launches)
    slo = _serving_delta(since, "paged")
    made = sum(len(r.generated) for r in eng.finished)
    ticks = slo["decode_ticks"]
    want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                     paged_decode_attention=ticks * L)
    exported = sum(1 for _ in open(serve_jsonl))
    line = {"ticks": tick, "decode_ticks": ticks, "seconds": serve_s,
            "tokens_made": made, "registry": slo,
            "jsonl_lines": exported, "timeline_records": len(tl.records),
            "launches": launches}
    say(card, "observed serving gpt3_1p3b " + json.dumps(line))
    if slo["tokens"] != made or slo["ttft_count"] != n_req or \
            made != n_req * max_new:
        raise AssertionError(f"observed serving: registry window {slo}, "
                             f"{made} tokens made by {n_req} requests")
    if launches != want or len(tl.records) != tick:
        raise AssertionError(f"observed serving: launches {launches}, "
                             f"expected {want}")
    del eng, smodel
    torch.cuda.empty_cache()

    # (e) the watchdog across (a)-(d)
    wd = {"timeouts": comm_watchdog.timeout_count(),
          "inflight": comm_watchdog.inflight(),
          "report": comm_watchdog.peek_report()}
    comm_watchdog.disable()
    say(card, "observed watchdog end " + json.dumps(wd))
    if wd["timeouts"] or wd["inflight"]:
        raise AssertionError(f"observed watchdog: {wd}")
    return {name: sum(p.get(name, 0) for p in paths) for name in _counters()}


# --------------------------------------------------------------------------- #
# phase 31: the train cell under ResilientTrainer and the port's launcher
# --------------------------------------------------------------------------- #

P31_STEPS = 6
P31_SAVE_EVERY = 2
P31_HB_INTERVAL_S = 2.0      # the elastic manager's heartbeat interval
# (a) at 16 of gpt3_1p3b's 24 layers, at full width: at 24 its four
# synchronous saves of 7.9 GB and a restore took 137 s of its 216 s, and the
# run came to 1,191 s of its 1,200 s limit (PERF.md, the resilient runtime)
P31_LAYERS = {"kill": 16, "hang": 2}
# a fresh process's first step takes 11-16 s on the card's host (torch's
# lazy imports), so no step nears (a)'s deadline and (b)'s is twice that
P31_STEP_TIMEOUT_S = {"kill": 600.0, "hang": 30.0}
P31_FAULTS = {"kill": "ckpt.before_commit:kill@2",
              "hang": "trainer.before_step:sleep:90@3"}
P31_LAUNCH_LIMIT_S = 600


def _p31_per_step(L):
    """phase 5's launches a step at depth L (`_train_config`)."""
    return {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "fused_norm": (2 * L + 1) + 2 * L, "fused_norm_dx": 2 * L + 1}


def _p31_setup(torch, layers):
    """Phase 5's gpt3_1p3b step at full width and `layers` deep (its
    weights from seed 0, its 4 x 2048 tokens) on the 1-rank NCCL group that
    must exist: DistributedTrainStep then runs over its one-rank mesh, in
    the worker and in the uninterrupted run alike."""
    cfg, _, _, _ = _train_config("gpt3_1p3b")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0,
                                  "gpt3_1p3b")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 2048)),
                          device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 2048)),
                             device="cuda")
    return model, step, ids, labels


def _p31_death_time(part, ckpt):
    """Wall time at which the previous life died: the newest file of the
    torn save it left (kill: its metadata, the last thing written before
    the fault point), or its flight recorder's SIGTERM dump (hang)."""
    if part == "kill":
        files = [os.path.join(dp, f) for dp, _, fs in os.walk(ckpt)
                 if dp.endswith(".tmp") for f in fs]
    else:
        fl = os.environ["PADDLE_FLIGHT_FILE"]
        files = [fl[: fl.rindex(".r")] + ".r0.flight"]
    times = [os.path.getmtime(f) for f in files if os.path.exists(f)]
    return max(times) if times else None


def _process_start_time():
    """This process's start, wall clock (/proc; to the kernel's boot-time
    second)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def phase31_worker(part, ckpt, layers):
    """One life of phase 31's worker, started by the launcher: the
    rendezvous from its environment (init_parallel_env: NCCL, world size
    1; create_or_get_global_tcp_store; an ElasticManager over that store),
    phase 5's step at `layers` deep under a ResilientTrainer. Each step
    prints a `P31 {...}` line (its loss, its launches with the counters
    zeroed just before it and read just after, the heartbeat's age, the
    saves committed since the last line); the life ends with a `P31_LIFE
    {...}` line. The first life arms P31_FAULTS[part]."""
    import torch

    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.distributed.resilience import ResilientTrainer
    from paddle_tpu_torch.distributed.store import create_or_get_global_tcp_store
    from paddle_tpu_torch.observability import flight

    t_life = time.time()
    restart = int(os.environ["PADDLE_RESTART_COUNT"])
    died_at = _p31_death_time(part, ckpt) if restart else None
    if restart == 0:
        os.environ["PADDLE_FAULT_INJECT"] = P31_FAULTS[part]
    pdist.init_parallel_env()
    store = create_or_get_global_tcp_store()
    elastic = ElasticManager(store=store, np_range="1",
                             heartbeat_interval=P31_HB_INTERVAL_S)
    t0 = time.perf_counter()
    model, step, ids, labels = _p31_setup(torch, layers)
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    reg = _registry()
    since = reg.snapshot()
    rec = flight.get_recorder()
    seen = [0]
    t_run = [None, None]    # run() entered, first step entered

    def saves():
        ev = [e for e in rec.events if e["kind"] == "checkpoint_save"]
        new, seen[0] = ev[seen[0]:], len(ev)
        return [{"step": e["step"], "s": e["latency_s"]} for e in new]

    def step_fn(i):
        if t_run[1] is None:
            t_run[1] = time.perf_counter()
        age = reg.get("trainer_heartbeat_age_seconds")
        line = {"step": i, "t_wall": time.time(), "saves": saves(),
                "hb_age_s": age.value() if age else None}
        _zero_counters()
        t = time.perf_counter()
        loss = step(ids, labels).item()
        line.update(loss=loss, s=time.perf_counter() - t,
                    launches=_counters())
        print("P31 " + json.dumps(line), flush=True)
        return loss

    trainer = ResilientTrainer(
        step_fn, step.train_state, ckpt, save_every=P31_SAVE_EVERY,
        keep_last_n=2, async_save=False, elastic=elastic,
        step_timeout=P31_STEP_TIMEOUT_S[part])
    t_run[0] = time.perf_counter()
    out = trainer.run(P31_STEPS)
    d = reg.delta(since)
    pre = "checkpoint_load_seconds_total{part="
    print("P31_LIFE " + json.dumps({
        "restart": restart, "start_step": out["start_step"],
        "resumed_from": out["resumed_from"], "built_s": built_s,
        "died_at": died_at, "t_life": t_life,
        "imports_s": t_life - _process_start_time(),
        "run_to_first_step_s": t_run[1] - t_run[0],
        "load_parts_s": {k[len(pre):-1]: v for k, v in d.items()
                         if k.startswith(pre)},
        "saves": saves(),
        "hb_age_final_s": reg.get("trainer_heartbeat_age_seconds").value(),
        "completed": store.tryget("default/completed") == b"1",
        "last_loss": out["last_loss"]}), flush=True)
    pdist.destroy_process_group()
    return 0


def _state_nbytes(state):
    """The bytes of a training state's tensors (a `train_state()` over a
    mesh gives each entry as a list of its `LocalShard`s)."""
    from paddle_tpu_torch.distributed.checkpoint import LocalShard

    parts = [p for v in state.values()
             for p in (v if isinstance(v, (list, tuple)) else [v])]
    return sum(t.numel() * t.element_size() for t in
               (p.tensor if isinstance(p, LocalShard) else p for p in parts))


def _p31_uninterrupted(torch, layers):
    """The same steps in this process, uninterrupted, on a 1-rank NCCL group
    of its own: (losses, launches a step, training-state bytes, seconds)."""
    from paddle_tpu_torch import distributed as pdist

    t0 = time.perf_counter()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        model, step, ids, labels = _p31_setup(torch, layers)
        nbytes = _state_nbytes(step.train_state())
        losses, launches = [], []
        for _ in range(P31_STEPS):
            _zero_counters()
            losses.append(step(ids, labels).item())
            launches.append(_counters())
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        return losses, launches, nbytes, time.perf_counter() - t0
    finally:
        pdist.destroy_process_group()


def _p31_start(part, root, log_dir):
    """`python -m paddle_tpu_torch.distributed.launch --max_restart=2` of
    this script's worker, in a session of its own, its output in
    `log_dir/launcher.log`; (process, start time)."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(log_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "MASTER_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--max_restart=2", "--log_dir", log_dir,
           os.path.abspath(__file__), "--phase31-worker", part, root,
           str(P31_LAYERS[part])]
    with open(os.path.join(log_dir, "launcher.log"), "wb") as out:
        return subprocess.Popen(cmd, env=env, cwd=here, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True), time.perf_counter()


def _p31_wait(started):
    """{part: wall seconds} of launches `started` ({part: (process, start
    time)}), each read when its launcher exits. Raises when one runs past
    P31_LAUNCH_LIMIT_S (the caller stops what is left)."""
    walls = {}
    while len(walls) < len(started):
        for part, (proc, t0) in started.items():
            if part in walls:
                continue
            if proc.poll() is not None:
                walls[part] = time.perf_counter() - t0
            elif time.perf_counter() - t0 > P31_LAUNCH_LIMIT_S:
                raise AssertionError(f"resilient train ({part}): the launch "
                                     f"ran past {P31_LAUNCH_LIMIT_S} s")
        time.sleep(0.2)
    return walls


def _p31_lives(log_dir):
    """The launcher's output and each life's P31 lines and log."""
    with open(os.path.join(log_dir, "launcher.log"), errors="replace") as f:
        err = f.read()
    lives = []
    for life in range(3):
        path = os.path.join(log_dir, f"workerlog.0.r{life}")
        if not os.path.exists(path):
            break
        text = open(path, errors="replace").read()
        steps = [json.loads(ln[4:]) for ln in text.splitlines()
                 if ln.startswith("P31 ")]
        end = [json.loads(ln[9:]) for ln in text.splitlines()
               if ln.startswith("P31_LIFE ")]
        lives.append({"steps": steps, "end": end[0] if end else None,
                      "log": text})
    return err, lives


def _p31_check(part, rc, err, lives, want_losses, per_step):
    """The holds of phase 31 (a) and (b) on one launch; returns the launch
    counts of every step the lives took, summed, the largest relative loss
    gap and the losses by step."""
    from paddle_tpu_torch.distributed.faults import FAULT_EXIT_CODE

    tail = err[-3000:]
    if rc != 0:
        raise AssertionError(f"resilient train ({part}): the launcher exited "
                             f"{rc}: {tail}")
    if len(lives) != 2 or lives[1]["end"] is None:
        raise AssertionError(f"resilient train ({part}): {len(lives)} lives, "
                             f"the last unfinished: {tail}")
    first, second = lives
    ran = [[s["step"] for s in life["steps"]] for life in lives]
    last_first = 3 if part == "kill" else 1
    if ran != [list(range(last_first + 1)), list(range(2, P31_STEPS))] or \
            second["end"]["resumed_from"] != 1 or second["end"]["died_at"] \
            is None:
        raise AssertionError(f"resilient train ({part}): steps by life {ran}, "
                             f"the second life's end {second['end']}")
    if part == "kill" and f"pod failed (exit {FAULT_EXIT_CODE})" not in err:
        raise AssertionError(f"resilient train (kill): no death by the "
                             f"injected fault: {tail}")
    if part == "hang" and ("fatal log" not in err
                           or "comm-watchdog post-mortem" not in first["log"]):
        raise AssertionError("resilient train (hang): the watchdog's "
                             "FatalError did not reach the launcher, or its "
                             f"report was not folded into the log: {tail}")
    want = _expected(**per_step)
    got = {s["step"]: s["loss"] for life in lives for s in life["steps"]}
    rel = max(abs(got[i] - want_losses[i]) / abs(want_losses[i])
              for i in range(P31_STEPS))
    bad = [(s["step"], s["launches"]) for life in lives
           for s in life["steps"] if s["launches"] != want]
    if rel > RESUME_RTOL or bad:
        raise AssertionError(f"resilient train ({part}): losses {got} "
                             f"against {want_losses} (max rel {rel}); steps "
                             f"with other launches than {per_step}: {bad}")
    ages = [s["hb_age_s"] for life in lives for s in life["steps"]
            if s["hb_age_s"] is not None] + [second["end"]["hb_age_final_s"]]
    if max(ages) >= 2 * P31_HB_INTERVAL_S or not second["end"]["completed"]:
        raise AssertionError(f"resilient train ({part}): heartbeat ages "
                             f"{ages}, completed {second['end']['completed']}")
    return {name: sum(s["launches"][name] for life in lives
                      for s in life["steps"]) for name in want}, rel, got


def _p31_line(part, ref, wall, lives, counts, rel, got, train_line):
    """Phase 31's printed figures of one launch."""
    first, second = lives
    end = second["end"]
    saves = [sv for life in lives for s in life["steps"]
             for sv in s["saves"]] + end["saves"]
    first_step, last_dead = second["steps"][0], first["steps"][-1]
    want_losses, _, nbytes, uninterrupted_s = ref
    return {
        "part": part, "layers": P31_LAYERS[part], "launch_wall_s": wall,
        "uninterrupted_s": uninterrupted_s,
        "start_steps": [0, end["start_step"]],
        "resumed_from": end["resumed_from"],
        "restore_s": sum(end["load_parts_s"].values()),
        "restore_parts_s": end["load_parts_s"],
        "run_to_first_step_s": end["run_to_first_step_s"],
        "saves_s": saves, "state_bytes": nbytes,
        # from the first life's death (its torn save's last file, or its
        # SIGTERM dump) to the second life's first step's start and end
        "death_to_first_step_s": first_step["t_wall"] - end["died_at"],
        "death_to_first_step_end_s":
            first_step["t_wall"] + first_step["s"] - end["died_at"],
        # the first life's last step ended, then it saved (kill) or hung
        # (hang) until it died
        "last_step_to_death_s":
            end["died_at"] - (last_dead["t_wall"] + last_dead["s"]),
        "worker_main_to_first_step_s": first_step["t_wall"] - end["t_life"],
        "imports_s": end["imports_s"], "built_s": end["built_s"],
        "first_step_s": first_step["s"],
        "step_s": [s["s"] for s in second["steps"][1:]],
        "phase5_step_s": train_line["step_s"],
        "losses": [got[i] for i in range(P31_STEPS)],
        "uninterrupted_losses": want_losses,
        "bit_identical": [got[i] for i in range(P31_STEPS)] == want_losses,
        "max_loss_rel_diff": rel, "loss_rtol": RESUME_RTOL,
        "heartbeat_interval_s": P31_HB_INTERVAL_S,
        "hb_age_max_s": max([s["hb_age_s"] or 0.0 for life in lives
                             for s in life["steps"]]
                            + [end["hb_age_final_s"]]),
        "launches": counts}


def resilient_train(card, torch, train_line):
    """Phase 31 (see the module docstring): phase 5's step under a
    ResilientTrainer started by `python -m
    paddle_tpu_torch.distributed.launch`, (a) killed while committing its
    second checkpoint and resumed, (b) hung past its step deadline, torn
    down and respawned; the two launches run side by side. Returns the
    launch counts of every step their workers took, summed."""
    import shutil
    import signal

    from paddle_tpu_torch.distributed.checkpoint import latest_checkpoint
    from paddle_tpu_torch.framework import native

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out", "phase31")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    native.build()   # the store's and the watchdog's host library
    refs = {part: _p31_uninterrupted(torch, layers)
            for part, layers in P31_LAYERS.items()}
    for part, (_, plain, _, _) in refs.items():
        want = _expected(**_p31_per_step(P31_LAYERS[part]))
        if any(l != want for l in plain):
            raise AssertionError(f"resilient train ({part}): the uninterrupted "
                                 f"run's launches {plain}")
    need = 3 * sum(r[2] for r in refs.values())
    root, free = _checkpoint_root(torch, need, "phase31_ckpt_")
    say(card, "resilient train disk " + json.dumps({
        "root": root, "free_bytes": free, "needs_bytes": need,
        "state_bytes": {part: r[2] for part, r in refs.items()}}))
    launches, started = [], {}
    try:
        for part in P31_LAYERS:
            os.makedirs(os.path.join(root, part))
            started[part] = _p31_start(part, os.path.join(root, part),
                                       os.path.join(out_dir, part))
        walls = _p31_wait(started)
        for part, wall in walls.items():
            rc = started[part][0].returncode
            err, lives = _p31_lives(os.path.join(out_dir, part))
            for life in lives:
                say(card, f"resilient train {part} life " + json.dumps({
                    "steps": [{k: s[k] for k in ("step", "loss", "s",
                                                 "hb_age_s", "saves")}
                              for s in life["steps"]],
                    "end": life["end"]}))
            counts, rel, got = _p31_check(part, rc, err, lives,
                                          refs[part][0],
                                          _p31_per_step(P31_LAYERS[part]))
            ckpt = os.path.join(root, part)
            left = sorted(os.listdir(ckpt))
            info = latest_checkpoint(ckpt)
            if any(d.endswith(".tmp") for d in left) or info is None or \
                    info.step != P31_STEPS - 1:
                raise AssertionError(f"resilient train ({part}): the "
                                     f"checkpoints left {left}, latest "
                                     f"{info and info.step}")
            say(card, f"resilient train {part} gpt3_1p3b " + json.dumps(
                _p31_line(part, refs[part], wall, lives, counts, rel, got,
                          train_line)))
            launches.append(counts)
    finally:
        # a launch left by a failure is torn down; nothing of a launch
        # outlives the phase
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        shutil.rmtree(root, ignore_errors=True)
    return {name: sum(c.get(name, 0) for c in launches)
            for name in _counters()}


# --------------------------------------------------------------------------- #
# phase 32: the nn surface (ParamAttr, initializers, weight-only serving,
# flash_attn_qkvpacked, the quant ops)
# --------------------------------------------------------------------------- #

# the compiled and the eager route's bf16 weights after one step, each
# element: two bf16 steps of the larger magnitude (the routes run the same
# ops; the global norm's sum may add in another order, which moves the
# clip's scale by an ulp and an update by at most one rounding)
NN_ROUTE_TOL_ULPS = 2
# a [4096, 4096] draw's mean and std against the distribution's, in units
# of their standard errors (sigma / sqrt(n), sigma / sqrt(2 n))
INIT_SIGMAS = 6.0
# Orthogonal's Q^T Q against the identity, f32 QR of 4096 x 4096
ORTHO_TOL = 1e-4
# the quant ops on the card against the same calls on CPU tensors, f32
# (TF32 off): sums of 4096 products in another order
QUANT_RTOL = 1e-4
# the quantized models' greedy tokens against the bf16 model's: the
# reference's own bar (tests/test_serving.py:175)
QUANT_AGREE = 0.7


def _nn_attrs(torch, model):
    """Phase 32a's attributes on gpt3_1p3b's parameters, as ParamAttr sets
    them (`set_param_attr`): L2Decay(1e-4) on the projection weights,
    L1Decay(1e-5) on the embeddings, need_clip False on the norms, rate
    0.0 on embed_positions and 0.5 on the head (the tied embed_tokens).
    Returns the names of the rate-0 parameters."""
    from paddle_tpu_torch import ParamAttr
    from paddle_tpu_torch.nn.layer.layers import set_param_attr
    from paddle_tpu_torch.regularizer import L1Decay, L2Decay

    frozen = []
    for name, p in model.named_parameters():
        attr = ParamAttr()
        if name.endswith(("_proj.weight", "fc1.weight", "fc2.weight")):
            attr.regularizer = L2Decay(1e-4)
        if "embed_" in name:
            attr.regularizer = L1Decay(1e-5)
        if "norm" in name:
            attr.need_clip = False
        if "embed_positions" in name:
            attr.learning_rate = 0.0
            frozen.append(name)
        if "embed_tokens" in name:
            attr.learning_rate = 0.5
        set_param_attr(p, attr)
    return frozen


def _nn_train_model(torch, cfg):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device="cuda", seed=0)
    frozen = _nn_attrs(torch, model)
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-4, moment_dtype="bfloat16",
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    return model, GPTPretrainingCriterion(cfg), opt, frozen


def _bf16_gap(torch, a, b):
    """max over elements of |a - b| in bf16 steps of max(|a|, |b|)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((a - b).abs() / ulp).max())


def nn_train_attrs(card, torch, train_line):
    """32a: gpt3_1p3b at full width and depth (24 layers, hidden 2048),
    batch 4 x 2048, O2 bf16, recompute, AdamW with ClipGradByGlobalNorm(1)
    and the attributes of `_nn_attrs`: 3 steps through DistributedTrainStep
    (A) and 2 through the eager loop (B, a second model holding A's
    starting weights). Holds: the rate-0 parameters bit for bit after both
    routes; A's weights after step 1 against B's within
    NN_ROUTE_TOL_ULPS bf16 steps; the five kernels' launches a step equal
    phase 5's on both routes. Returns (launches, model A)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import GPTForCausalLM

    cfg, per_step, _, _ = _train_config("gpt3_1p3b")
    B, S = 4, 2048
    t0 = time.perf_counter()
    model, crit, opt, frozen = _nn_train_model(torch, cfg)
    twin, crit_b, opt_b, _ = _nn_train_model(torch, cfg)
    twin.load_state_dict(model.state_dict())
    build_s = time.perf_counter() - t0
    start = {k: p.detach().clone() for k, p in model.named_parameters()
             if k in frozen}
    step = DistributedTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                                amp_level="O2", amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")

    _zero_counters()
    reset_peak(torch)
    torch.cuda.synchronize()
    losses = [step(ids, labels).item()]
    after1 = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(ids, labels).item() for _ in range(2)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 2
    compiled = _counters()
    peak = torch.cuda.max_memory_allocated()

    _zero_counters()
    eager_losses, times = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with amp.auto_cast(True, level="O2", dtype="bfloat16"):
            loss = crit_b(twin(ids), labels)
        loss.backward()
        opt_b.step()
        opt_b.clear_grad()
        eager_losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if len(times) == 1:
            gaps = {k: _bf16_gap(torch, p.detach(), after1[k])
                    for k, p in twin.named_parameters()}
    eager = _counters()
    del after1
    unchanged = {k: all(torch.equal(m[k].detach(), start[k])
                        for m in (dict(model.named_parameters()),
                                  dict(twin.named_parameters())))
                 for k in frozen}
    worst = max(gaps, key=gaps.get)
    line = {
        "model": "gpt3_1p3b", "layers": cfg.num_layers,
        "hidden": cfg.hidden_size, "batch": B, "seq": S, "build_s": build_s,
        "compiled_losses": losses, "eager_losses": eager_losses,
        "step_s": step_s, "phase5_step_s": train_line["step_s"],
        "ratio_to_phase5": step_s / train_line["step_s"],
        "eager_step_s": times, "peak_memory_bytes": peak,
        "rate0_bit_identical": unchanged,
        "route_gap_bf16_steps_max": gaps[worst], "route_gap_worst": worst,
        "route_params_differing": sum(g > 0 for g in gaps.values()),
        "route_tol_bf16_steps": NN_ROUTE_TOL_ULPS,
        "launches_compiled": compiled, "launches_eager": eager,
        "launches_per_step": per_step}
    say(card, "nn_surface train attrs (smoke run, not a benchmark) "
        + json.dumps(line))
    bad = []
    if not all(unchanged.values()):
        bad.append(f"rate-0 parameters moved: {unchanged}")
    if gaps[worst] > NN_ROUTE_TOL_ULPS:
        bad.append(f"compiled vs eager after step 1: {worst} {gaps[worst]} "
                   "bf16 steps")
    if compiled != _expected(**{k: 3 * v for k, v in per_step.items()}):
        bad.append(f"compiled launches {compiled}")
    if eager != _expected(**{k: 2 * v for k, v in per_step.items()}):
        bad.append(f"eager launches {eager}")
    if not all(math.isfinite(x) for x in losses + eager_losses):
        bad.append(f"non-finite losses {losses} {eager_losses}")
    if bad:
        raise AssertionError("nn_surface train attrs: " + "; ".join(bad))
    launches = {k: compiled[k] + eager[k] for k in compiled}
    del step, twin, opt, opt_b, start
    torch.cuda.empty_cache()
    return launches, model


def _init_cases(I, np_value):
    """name: (initializer, checks) of 32b; checks: ("moments", mean, std),
    ("bounds", lo, hi) or ("equal", value)."""
    n = 4096
    xs, ks = math.sqrt(6.0 / (2 * n)), math.sqrt(2.0) * math.sqrt(3.0 / n)
    tn = 0.8796256610342398   # std of N(0, 1) cut to [-2, 2]
    return {
        "Constant": (I.Constant(0.5), [("equal", 0.5)]),
        "Normal": (I.Normal(0.1, 0.02), [("moments", 0.1, 0.02)]),
        "TruncatedNormal": (I.TruncatedNormal(0.0, 1.0),
                            [("moments", 0.0, tn), ("bounds", -2.0, 2.0)]),
        "Uniform": (I.Uniform(-0.3, 0.7), [("moments", 0.2, 1 / math.sqrt(12)),
                                           ("bounds", -0.3, 0.7)]),
        "XavierNormal": (I.XavierNormal(),
                         [("moments", 0.0, math.sqrt(2.0 / (2 * n)))]),
        "XavierUniform": (I.XavierUniform(), [("moments", 0.0, xs / math.sqrt(3)),
                                              ("bounds", -xs, xs)]),
        "KaimingNormal": (I.KaimingNormal(),
                          [("moments", 0.0, math.sqrt(2.0) / math.sqrt(n))]),
        "KaimingUniform": (I.KaimingUniform(),
                           [("moments", 0.0, ks / math.sqrt(3)),
                            ("bounds", -ks, ks)]),
        "Assign": (I.Assign(np_value), [("assigned",)]),
        "Orthogonal": (I.Orthogonal(), [("orthogonal",)]),
        "Dirac": (I.Dirac(), [("identity",)]),
    }


def nn_initializers(card, torch):
    """32b: each initializer of nn.initializer fills a [4096, 4096] f32
    parameter on the card from a cuda generator, in place: the draws'
    mean and std within INIT_SIGMAS standard errors of the
    distribution's, the bounds held, Orthogonal's Q^T Q within ORTHO_TOL
    of I, Assign and Dirac exact; the same seed gives the same tensor
    twice."""
    from paddle_tpu_torch.framework.core import Parameter
    from paddle_tpu_torch.nn import initializer as I

    n = 4096
    value = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    p = Parameter(torch.empty(n, n, device="cuda"))
    gen = torch.Generator(device="cuda")
    rows, bad = {}, []
    for name, (init, checks) in _init_cases(I, value).items():
        ptr = p.data_ptr()
        gen.manual_seed(11)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        init(p, generator=gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        first = p.detach().clone()
        gen.manual_seed(11)
        init(p, generator=gen)
        row = {"ms": ms, "same_seed_equal": torch.equal(first, p.detach()),
               "in_place": p.data_ptr() == ptr, "device": str(p.device)}
        x = p.detach().double()
        for chk in checks:
            if chk[0] == "moments":
                mean, std = float(x.mean()), float(x.std())
                row.update(mean=mean, std=std, want_mean=chk[1], want_std=chk[2])
                se = chk[2] / math.sqrt(x.numel())
                if (abs(mean - chk[1]) > INIT_SIGMAS * se
                        or abs(std - chk[2]) > INIT_SIGMAS * se * math.sqrt(2)):
                    bad.append(f"{name}: mean {mean} std {std}")
            elif chk[0] == "bounds":
                lo, hi = float(x.min()), float(x.max())
                row.update(min=lo, max=hi)
                if lo < chk[1] - 1e-6 or hi > chk[2] + 1e-6:
                    bad.append(f"{name}: range [{lo}, {hi}]")
            elif chk[0] == "equal":
                if not bool((p == chk[1]).all()):
                    bad.append(f"{name}: not all {chk[1]}")
            elif chk[0] == "assigned":
                if not torch.equal(p.detach().cpu(), torch.from_numpy(value)):
                    bad.append(f"{name}: not the array")
            elif chk[0] == "identity":
                if not torch.equal(p.detach(), torch.eye(n, device="cuda")):
                    bad.append(f"{name}: not the identity")
            else:
                pt = p.detach()
                err = float((pt.T @ pt - torch.eye(n, device="cuda")).abs().max())
                row["qtq_max_abs_err"] = err
                if err > ORTHO_TOL:
                    bad.append(f"{name}: Q^T Q off I by {err}")
        if not (row["same_seed_equal"] and row["in_place"]
                and p.device.type == "cuda"):
            bad.append(f"{name}: {row}")
        rows[name] = row
    say(card, "nn_surface initializers " + json.dumps(
        {"shape": [n, n], "sigmas": INIT_SIGMAS, "ortho_tol": ORTHO_TOL,
         "rows": rows}))
    del p, first, x
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("nn_surface initializers: " + "; ".join(bad))


def _weight_bytes(model):
    """Bytes of the model's parameters and quantized weight buffers."""
    ts = list(model.parameters()) + [b for n, b in model.named_buffers()
                                     if n.endswith(("weight_quant",
                                                    "weight_scale"))]
    return sum(t.numel() * t.element_size() for t in ts)


def _nn_serve(torch, model, workload, max_new, L):
    """The model through the paged engine (B 16, S 512, page size 32) on
    `workload` greedy: (tokens by request, line); the launches held to
    phase serve's per tick."""
    from paddle_tpu_torch.inference import create_serving_engine

    eng = create_serving_engine(model, max_batch_size=16, max_seq_len=512,
                                page_size=32, seed=0)
    done, seconds, peak, launches = _drain(torch, eng, workload, max_new)
    line = _serve_line(eng, done, seconds, peak, launches)
    slo, steps = eng._smoke_window
    ticks = line["decode_ticks"]
    want = _expected(fused_norm=(len(workload) + ticks) * (2 * L + 1),
                     paged_decode_attention=ticks * L)
    line["tick_ms_mean"] = float(np.mean(steps)) * 1e3
    line["weight_bytes"] = _weight_bytes(model)
    if launches != want:
        raise AssertionError(f"nn_surface serve: launches {launches}, "
                             f"expected {want}")
    by_prompt = {tuple(r.prompt): r.generated for r in done}
    del eng
    return [by_prompt[tuple(p)] for p, _ in workload], line


def _dense_against_generate(torch, model, prompt, max_new):
    """The dense engine's greedy tokens for `prompt` against the model's
    own generate: identical, or parted only where generate's top two
    logits lie within BF16_TIE_ULPS (`_teacher_forced_margins`)."""
    from paddle_tpu_torch.inference import create_serving_engine

    eng = create_serving_engine(model, paged=False, max_batch_size=4,
                                max_seq_len=512, seed=0)
    eng.add_request(prompt, max_new_tokens=max_new, temperature=0.0)
    dense = eng.run()[0].generated
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    steps = _teacher_forced_margins(torch, model, prompt, dense)
    return {"identical": dense == gen, "dense": dense, "generate": gen,
            "tie_ok": all(s["ok"] for s in steps)}


def _dequantized_twin(torch, model, fresh):
    """A bf16 model (`fresh()`) whose projections hold the dequantized
    weights of the converted `model`: the same function without the
    weight-only route, so the quantization noise is its own."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.nn.quant import weight_dequantize

    twin = fresh()
    subs = dict(twin.named_modules())
    with torch.no_grad():
        for name, sub in model.named_modules():
            if isinstance(sub, Linear) and sub._weight_only is not None:
                subs[name].weight.copy_(weight_dequantize(
                    sub.weight_quant, sub.weight_scale, sub._weight_only,
                    "bfloat16"))
    return twin


def nn_weight_only_serving(card, torch, trained):
    """32c: gpt3_1p3b in bf16 (24 layers, full width) with 32a's trained
    weights through the paged engine on 12 requests of the serving mix,
    greedy, 16 new tokens; then `quantize_for_inference(model,
    "weight_only_int8")` and, on a fresh model with the same weights,
    "weight_only_int4" at group size 128, each also beside a bf16 model
    holding its dequantized weights (`_dequantized_twin`). Holds: the
    int8 model's tokens agree with the bf16 model's on QUANT_AGREE of
    positions (the reference's bar, whose test is int8); each quantized
    model's tokens agree with its dequantized twin's on QUANT_AGREE (the
    serving route against the same function in plain bf16: int4's
    quantization noise alone moves random weights' greedy tokens, so its
    agreement with the bf16 model is printed, not held); its dense
    engine's tokens equal its own generate's (or part only at a bf16
    tie); each engine's launches are phase serve's per tick; the converted
    models hold no float projection weight. Returns the launches."""
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn.quant import quantize_for_inference

    cfg = gpt3_1p3b()
    L, n_req, max_new = cfg.num_layers, 12, 16
    state = trained.state_dict()

    def fresh():
        m = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
        m.load_state_dict(state)
        return m.eval()

    def agreement(a, b):
        return float(np.mean([x == y for r, t in zip(a, b)
                              for x, y in zip(r, t)]))

    workload = [(p, 0.0) for p, _ in serving_workload(cfg.vocab_size, 512,
                                                      n_req)]
    launches = dict.fromkeys(_counters(), 0)
    model = fresh()
    ref, line_bf16 = _nn_serve(torch, model, workload, max_new, L)
    for k, v in line_bf16["launches"].items():
        launches[k] += v
    lines, bad = {"bf16": line_bf16}, []
    for algo, gs in (("weight_only_int8", -1), ("weight_only_int4", 128)):
        if algo == "weight_only_int4":
            del model
            torch.cuda.empty_cache()
            model = fresh()
        t0 = time.perf_counter()
        n = quantize_for_inference(model, algo, group_size=gs)
        convert_s = time.perf_counter() - t0
        floats = [k for k, p in model.named_parameters()
                  if k.endswith(("_proj.weight", "fc1.weight", "fc2.weight"))]
        toks, line = _nn_serve(torch, model, workload, max_new, L)
        for k, v in line["launches"].items():
            launches[k] += v
        twin = _dequantized_twin(torch, model, fresh)
        twin_toks, twin_line = _nn_serve(torch, twin, workload, max_new, L)
        for k, v in twin_line["launches"].items():
            launches[k] += v
        del twin
        torch.cuda.empty_cache()
        dense = _dense_against_generate(torch, model, workload[0][0], max_new)
        line.update(algo=algo, group_size=gs, converted_layers=n,
                    convert_s=convert_s,
                    agreement_with_bf16=agreement(ref, toks),
                    agreement_with_dequantized_bf16=agreement(twin_toks, toks),
                    dequantized_twin_tick_ms_mean=twin_line["tick_ms_mean"],
                    dense_vs_generate=dense, float_projection_weights=len(floats))
        lines[algo] = line
        if algo == "weight_only_int8" and line["agreement_with_bf16"] < QUANT_AGREE:
            bad.append(f"{algo}: agreement {line['agreement_with_bf16']} "
                       "with the bf16 tokens")
        if line["agreement_with_dequantized_bf16"] < QUANT_AGREE:
            bad.append(f"{algo}: agreement "
                       f"{line['agreement_with_dequantized_bf16']} with the "
                       "dequantized bf16 model's tokens")
        if not (dense["identical"] or dense["tie_ok"]):
            bad.append(f"{algo}: dense engine {dense['dense']} vs generate "
                       f"{dense['generate']}")
        if n != 6 * L or floats:
            bad.append(f"{algo}: {n} layers converted, float weights {floats}")
    say(card, "nn_surface weight-only serving (smoke run, not a benchmark) "
        + json.dumps({"lines": lines, "agree_min": QUANT_AGREE}))
    del model
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("nn_surface serving: " + "; ".join(bad))
    return launches


def nn_qkvpacked(card, torch):
    """32d: nn.functional.flash_attn_qkvpacked on qkv [4, 2048, 3, 16, 128]
    bf16, causal, forward and backward: one launch of each flash kernel,
    the output and the three gradients held to the plain versions at
    check_flash's limits. Returns the launches."""
    from paddle_tpu_torch.nn.functional import flash_attn_qkvpacked
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, D = 4, 2048, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(9)
    qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=gen).to(
        torch.bfloat16).requires_grad_()
    dout = torch.randn(B, S, H, D, device="cuda", generator=gen).to(
        torch.bfloat16)
    _zero_counters()
    out, _ = flash_attn_qkvpacked(qkv, causal=True)
    out.backward(dout)
    torch.cuda.synchronize()
    launches = _counters()
    q, k, v = (qkv.detach()[:, :, i].contiguous() for i in range(3))
    scale = D ** -0.5
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, True, scale, None)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq_p = fa.flash_bwd_dq_plain(q, k, v, None, dout, lse_p, delta, True, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, None, dout, lse_p, delta,
                                        True, scale)
    got = {"out": out.detach(), "dq": qkv.grad[:, :, 0],
           "dk": qkv.grad[:, :, 1], "dv": qkv.grad[:, :, 2]}
    plain = {"out": out_p, "dq": dq_p, "dk": dk_p.to(k.dtype),
             "dv": dv_p.to(v.dtype)}
    errs = _flash_errs(got, plain)
    bad = _flash_violations(errs, "bfloat16")
    want = _expected(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    say(card, "nn_surface flash_attn_qkvpacked " + json.dumps({
        "qkv": [B, S, 3, H, D], "causal": True, "launches": launches,
        "errors": {w: {"max_abs": e[0], "row_rel": e[1], "frobenius_rel": e[2]}
                   for w, e in errs.items()},
        "tol": FLASH_TOL["bfloat16"], "frobenius_tol": FLASH_FROB_TOL["bfloat16"]}))
    if launches != want:
        bad.append(f"launches {launches}")
    del qkv, dout, out, got, plain
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("nn_surface qkvpacked: " + "; ".join(bad))
    return launches


def nn_quant_ops(card, torch):
    """32e: weight_only_linear (int8, int4 at group 128) and llm_int8_linear
    at x [16, 4096] x W [4096, 11008] on the card: f32 against the same
    calls on CPU tensors within QUANT_RTOL of the output's largest |y|,
    then timed in bf16 beside torch.matmul on the dequantized bf16
    weight (eager, CUDA events)."""
    from paddle_tpu_torch.nn import quant

    M, K, N = 16, 4096, 11008
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    x[:, 7] *= 20.0   # an outlier column for llm.int8
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    rows, bad = {}, []
    for name, algo, gs in (("weight_only_int8", "weight_only_int8", -1),
                           ("weight_only_int4", "weight_only_int4", 128),
                           ("llm_int8", "llm.int8", -1)):
        q, s = quant.weight_quantize(w, algo, group_size=gs)
        qc, sc = q.cuda(), s.cuda()
        q2, s2 = quant.weight_quantize(w.cuda(), algo, group_size=gs)
        same_q = torch.equal(q2.cpu(), q) and torch.equal(s2.cpu(), s)

        def call(xx, qq, ss, bb, name=name):
            if name == "llm_int8":
                return quant.llm_int8_linear(xx, qq, bb, ss, threshold=6.0)
            return quant.weight_only_linear(
                xx, qq, bb, ss, "int4" if "int4" in name else "int8")

        cpu = call(x, q, s, bias)
        dev = call(x.cuda(), qc, sc, bias.cuda()).cpu()
        err = float((dev - cpu).abs().max() / cpu.abs().max())
        xb, bb = x.cuda().to(torch.bfloat16), bias.cuda().to(torch.bfloat16)
        wd = quant.weight_dequantize(qc, sc, "weight_only_int4" if "int4" in
                                     name else "weight_only_int8", "bfloat16")
        ms = eager_ms(lambda: call(xb, qc, sc, bb))
        mm_ms = eager_ms(lambda: torch.matmul(xb, wd) + bb)
        rows[name] = {"rel_err_vs_cpu": err, "quantize_bit_equal_cpu": same_q,
                      "ms_bf16": ms, "matmul_dequantized_bf16_ms": mm_ms,
                      "weight_bytes": q.numel() + 4 * s.numel()}
        if err > QUANT_RTOL or not same_q:
            bad.append(f"{name}: {rows[name]}")
    say(card, "nn_surface quant ops " + json.dumps({
        "x": [M, K], "w": [K, N], "rtol": QUANT_RTOL, "rows": rows}))
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("nn_surface quant ops: " + "; ".join(bad))


def nn_surface(card, torch, train_line):
    """Phase 32, the nn surface: 32a `nn_train_attrs`, 32c
    `nn_weight_only_serving` (on 32a's weights), 32d `nn_qkvpacked`, then
    with TF32 off 32b `nn_initializers` and 32e `nn_quant_ops`. Returns
    the launches of the paths (32a, 32c, 32d)."""
    launches_a, trained = nn_train_attrs(card, torch, train_line)
    launches_c = nn_weight_only_serving(card, torch, trained)
    del trained
    torch.cuda.empty_cache()
    launches_d = nn_qkvpacked(card, torch)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        nn_initializers(card, torch)
        nn_quant_ops(card, torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {k: launches_a[k] + launches_c[k] + launches_d[k]
            for k in launches_a}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--phase31-worker"]:
        part, ckpt, layers = sys.argv[2:5]
        return phase31_worker(part, ckpt, int(layers))
    from paddle_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    say(card, f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_library()
    say(card, f"build: {time.perf_counter() - t0:.2f} s")
    say(card, "ptxas " + json.dumps(ptxas_summary(_build.BUILD_LOG)))
    sm90_report(card, _build.build_library(), _build.BUILD_LOG)
    say(card, "paged_split_kernel ptxas " + json.dumps(
        ptxas_kernels(_build.BUILD_LOG, "paged_split_kernel")))
    rope_ptxas(card, _build.BUILD_LOG)
    norm_dx_ptxas(card, _build.BUILD_LOG)
    tiles_ptxas(card, _build.BUILD_LOG)

    t_run = time.perf_counter()

    def phase(fn, *args):
        """fn(*args), its time and the run's so far printed after it."""
        t = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        say(card, f"phase {fn.__name__}: {now - t:.1f} s (run {now - t_run:.1f} s)")
        return out

    norm = phase(check_norm, card, torch)
    norm_dx = phase(check_norm_dx, card, torch)
    decode = phase(check_decode, card, torch)
    decode_q8 = phase(check_decode_q8, card, torch)
    dense = phase(check_dense_decode, card, torch)
    flash = phase(check_flash, card, torch)
    phase(check_flash_autograd, card, torch)
    phase(check_flash_decode, card, torch)
    rope = phase(check_rope, card, torch)
    flashmask = phase(check_flashmask, card, torch)
    phase(check_flashmask_autograd, card, torch)
    grouped = phase(check_grouped_gemm, card, torch)
    varlen = phase(check_varlen, card, torch)
    phase(planted_kernel_faults, card, torch)
    serve_launches = phase(serve, card, torch)
    phase(hold, card, torch)
    quant_launches = phase(serve_quant, card, torch)
    dense_launches = phase(serve_dense, card, torch)
    mmha_launches = phase(mmha, card, torch)
    phase(quant_hold, card, torch)
    train_launches, train_line = phase(train, card, torch, "gpt3_1p3b")
    phase(train_hold, card, torch, "gpt3_1p3b")
    sharded_launches = phase(train_sharded, card, torch, train_line)
    tp_launches = phase(train_tensor_parallel, card, torch, train_line)
    pipe_launches = phase(train_pipeline, card, torch, train_line)
    cp_launches = phase(train_context_parallel, card, torch, train_line)
    llama_serve_launches = phase(serve, card, torch, "llama_7b")
    phase(hold, card, torch, "llama_7b")
    llama_train_launches, _ = phase(train, card, torch, "llama_7bshape")
    phase(train_hold, card, torch, "llama_7bshape")
    moe_launches, moe_line = phase(train_moe, card, torch)
    ep_launches = phase(train_moe_expert_parallel, card, torch, moe_line)
    phase(moe_train_hold, card, torch)
    varlen_launches, varlen16_launches = phase(varlen_entry, card, torch)
    bert_launches = phase(train_bert, card, torch)
    phase(bert_train_hold, card, torch)
    resnet_launches = phase(train_resnet, card, torch)
    phase(resnet_train_hold, card, torch)
    unet_launches = phase(train_unet, card, torch)
    phase(unet_train_hold, card, torch)
    phase(check_random, card, torch)
    bert_dropout_launches, bert_eval_launches = phase(train_bert_dropout,
                                                      card, torch)
    phase(optimizers_hold, card, torch)
    fp16_launches, fp16_moe_launches = phase(train_fp16, card, torch,
                                             train_line)
    fp16_paged_launches, fp16_dense_launches = phase(serve_fp16, card, torch)
    half_hold_launches = phase(train_half_holds, card, torch)
    blha_launches = phase(serve_block_attention, card, torch)
    fused_enc_launches = phase(train_fused_encoder, card, torch)
    incubate_launches = phase(incubate_calls, card, torch)
    idiom_launches = phase(paddle_idiom, card, torch, train_line)
    observed_launches = phase(observed_train_and_resume, card, torch,
                              train_line)
    resilient_launches = phase(resilient_train, card, torch, train_line)
    nn_launches = phase(nn_surface, card, torch, train_line)

    # launches: each kernel's count over the paths that run it, each path
    # driven with the counters zeroed just before and read just after
    paths = (serve_launches, quant_launches, dense_launches, mmha_launches,
             train_launches, sharded_launches, tp_launches, pipe_launches,
             cp_launches, llama_serve_launches,
             llama_train_launches, moe_launches, ep_launches, varlen_launches,
             bert_launches, resnet_launches, unet_launches,
             bert_dropout_launches, bert_eval_launches, blha_launches,
             fused_enc_launches, incubate_launches, idiom_launches,
             observed_launches, resilient_launches, nn_launches)
    launches = {name: sum(p.get(name, 0) for p in paths) for name in _counters()}
    # the fp16 paths (phases 23-25 and varlen_entry's fp16 call) launch the
    # same wrappers' f16 instantiations: counted apart, for the f16 rows
    f16_paths = (fp16_launches, fp16_moe_launches, fp16_paged_launches,
                 fp16_dense_launches, varlen16_launches, half_hold_launches)
    launches16 = {name: sum(p.get(name, 0) for p in f16_paths)
                  for name in _counters()}
    da_src = "paddle_tpu_torch/csrc/decode_attention.cu"
    da_ref = "paddle_tpu/ops/pallas/decode_attention.py:50"
    fwd_src = "paddle_tpu_torch/csrc/flash_fwd_sm90.cuh"
    bwd_src = "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh"
    fa_ref = "paddle_tpu/ops/pallas/flash_attention.py"
    mf_src = "paddle_tpu_torch/csrc/masked_flash.cu"
    mf_ref = "paddle_tpu/ops/pallas/masked_flash.py"
    kernels = []
    for name, src, replaces, main_row, err in (
            ("fused_norm", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:107", norm["main"], norm["worst"]),
            ("paged_decode_attention", da_src, da_ref, decode["main"],
             decode["worst"]),
            ("paged_decode_attention_q8", da_src, da_ref, decode_q8["main"],
             decode_q8["worst"]),
            ("dense_decode_attention", "paddle_tpu_torch/csrc/dense_decode.cu",
             da_ref, dense["main"], dense["worst"]),
            ("fused_norm_dx", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:196", norm_dx["main"],
             norm_dx["worst"]),
            ("flash_fwd", fwd_src, fa_ref + ":127", flash["main"]["fwd"],
             flash["worst"]["fwd"]),
            ("flash_bwd_dq", bwd_src, fa_ref + ":332", flash["main"]["dq"],
             flash["worst"]["dq"]),
            ("flash_bwd_dkv", bwd_src, fa_ref + ":406", flash["main"]["dkv"],
             flash["worst"]["dkv"]),
            ("fused_rope", "paddle_tpu_torch/csrc/fused_rope.cu",
             "paddle_tpu/ops/pallas/fused_rope.py:90", rope["main"],
             rope["worst"]),
            ("flashmask_fwd", fwd_src, mf_ref + ":77", flashmask["main"]["fwd"],
             flashmask["worst"]["fwd"]),
            ("flashmask_bwd_dq", bwd_src, mf_ref + ":138",
             flashmask["main"]["dq"], flashmask["worst"]["dq"]),
            ("flashmask_bwd_dkv", bwd_src, mf_ref + ":182",
             flashmask["main"]["dkv"], flashmask["worst"]["dkv"]),
            ("grouped_gemm", "paddle_tpu_torch/csrc/grouped_gemm_sm90.cuh",
             "paddle_tpu/ops/pallas/grouped_gemm.py:110", grouped["main"],
             grouped["worst"]),
            ("varlen_fwd", fwd_src, mf_ref + ":442", varlen["main"]["fwd"],
             varlen["worst"]["fwd"]),
            ("varlen_bwd_dq", bwd_src, mf_ref + ":490", varlen["main"]["dq"],
             varlen["worst"]["dq"]),
            ("varlen_bwd_dkv", bwd_src, mf_ref + ":529",
             varlen["main"]["dkv"], varlen["worst"]["dkv"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
        if "cold_ms" in main_row:
            kernels[-1]["cold_ms"] = main_row["cold_ms"]
    # the f16 instantiations of the sm90 kernels, at the same main shapes
    for check, names in ((flash, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
                         (flashmask, ("flashmask_fwd", "flashmask_bwd_dq",
                                      "flashmask_bwd_dkv")),
                         (varlen, ("varlen_fwd", "varlen_bwd_dq",
                                   "varlen_bwd_dkv")),
                         (grouped, ("grouped_gemm",))):
        for name in names:
            row = next(k for k in kernels if k["name"] == name)
            part = name.rsplit("_", 1)[-1] if name != "grouped_gemm" else None
            main_row = check["main_f16"][part] if part else check["main_f16"]
            err = check["worst_f16"][part] if part else check["worst_f16"]
            kernels.append({
                **row, "name": name + "_f16", "launches": launches16[name],
                "max_abs_err": err, "ms": main_row["ms"],
                "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"],
                "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
