#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: drive its serving and training paths
(FLAVA fusion, MMBT, ViLT) and its long-context attention and kernel
microbenchmarks on one NVIDIA GPU, and hold its hand-written CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --fmnist-plain-gap   # phase 4j's transformer epoch against the
                                               # plain attention over all its steps
    python3 chip_smoke.py --phase4k   # phases 1 and 4k alone
    python3 chip_smoke.py --phase3e   # phases 1 and 3e alone

Phases (each raises on failure; any failure exits non-zero):

1. build: compile ``multimodal_uncertainty_tpu_torch/csrc/*.cu`` with nvcc
   (one process per source, started together); print the build seconds, the
   compiler's register/spill report for each source, and the card's name and
   power limit;
2. kernels vs plain at the fusion width (D=768, 3 heads, Dh=256, B=32) at
   S=320 and S=736, at Dh=64/128, at the head dims of FLAVA fusion's other
   head counts (Dh 24, 48, 96, 192, 384 and 768 at S=320, and Dh 96, 384 and
   768 at S=736: the instances that replace the JAX package's heads-first K6 and
   extend K1/K3), and at B=4, S=197 (ragged tiles), in fp32
   and bf16, with ragged, image-ablated, text-ablated and fully masked rows:
   the forward through both entry points (packed QKV; separate q/k/v with the
   LSE), tolerance 1e-4 absolute in fp32, 2e-2 in bf16 (the two versions sum
   in other orders); the forward through ``attention_heads_last`` at MMBT's
   shapes (B=32, 12 heads of Dh=64, S=165 and S=517; and Dh=32, the tiny
   BERT's) with MMBT's masks (ragged text, image-ablated, text-ablated,
   batch-padding rows), same tolerances; the backward kernel against the plain backward, and the
   gradients through the autograd Functions (the packed (B, S, 3D) gradient
   and the separate one) against autograd through the plain forward,
   tolerance 1e-4 x max(1, max|ref|) in fp32 (dK and dV sum over S queries in
   another order) and 3e-2 x max(1, max|ref|) in bf16; at MMBT's shapes and
   masks (B=32, 12 heads of Dh=64, S=165 and 517; Dh=32), the backward on
   BERT's separate q, k, v (K2 bwd) and the dropout kernels (K5 fwd and bwd,
   rate 0.1 and 0.5) against ``attention_probs_dropout`` and
   ``attention_bwd_dropout_plain`` with the same keep mask, the forward to
   1e-4 / 2e-2 x max(1, max|ref|) (dropout scales the outputs by
   1 / (1 - rate)), the backward as above; the dW kernel (K8) against
   ``dw_plain`` at ViLT's Linears (K = 32 x 185 = 5920 rows with Din x Dout
   768 x 2304, 768 x 768, 768 x 3072, 3072 x 768; K = 32 at 768 x 768; K =
   1001, no multiple of any tile), fp32 inputs (the split-fp32 tensor-core
   kernel, ``DW.dw_cuda.launches_tc32``; at K <= ``DW.SIMT_MAX_K`` the
   small-K kernel, ``launches_simt``: the main paths' launches count by the
   route ``DW.dw_route`` names) and bf16, tolerance 1e-4 x max(1,
   max|plain|), and the gradients of a ``fast_dw`` Linear (the
   pooler's strided x[:, 0], fc1's B x S rows) against autograd's. The bf16
   forward and backward at Dh 24, 48, 64, 96, 192, 256, 384 and 768 and the
   bf16 dropout forward and backward at Dh 64 (also at S = 1, 320 and 736)
   must have taken the tensor-core routes (``csrc/attention_fwd_tc*.cu``,
   ``csrc/attention_bwd_tc*.cu``) at every launch, and no other launch; the
   bf16 forward and backward at each of those head dims are also held to the
   plain versions
   at S = 1, 63 and 165 (the forward at 736 too) with a random key mask, a
   fully masked sample (lse exactly -1e30) and one with every key, on the
   packed projection and on separate heads-last q, k, v; every fp32
   forward at Dh 24-192, with and without dropout, the split-fp32 route
   (``csrc/attention_fwd_tc32*.cu``, ``launches_tc32``), here and on every
   model path of phases 3-7; Dh 384 and 768
   run fp32 on clusters (``csrc/attention_fwd_wide.cu``,
   ``csrc/attention_bwd_wide.cu``; bf16 on the tensor-core clusters of
   ``csrc/attention_{fwd,bwd}_tc_{384,768}.cu``, also at S = 320 and 736),
   and Dh 256 the backward on register
   micro-tiles (``csrc/attention_bwd_256.cu``), in both dtypes under the same
   gates, also at B=3, S=301 (no multiple of their 32- and 64-row blocks)
   with a random key mask, a fully masked sample (its lse exactly -1e30)
   and one with every key, each launch on the source ``fwd_source`` /
   ``bwd_source`` names; every head dim of D = 768 (Dh 24-768) in fp32 at
   the FashionMNIST transformer's S = 4 (one token a view), with no key
   mask at B = 32 and 256 (its train batch, the sweep's 4 x 64 rows) and at
   B = 3 with a fully masked sample, under the same gates and source counts;
   the bf16 dW (the wgmma kernel) at ViLT's fc1, the bf16 K2 forward and
   backward at S=165 are timed beside ``torch.matmul`` / SDPA and their
   bounds;
3. serving end to end at full width: the MIMO fusion model (768 wide, 3
   heads, 3 layers, 101 classes, random weights from a seed) saved and loaded
   through ``FusionPredictor(device="cuda")`` behind ``fusion_micro_batcher(
   uncertainty=True)`` and a ``PredictionServer``; 34 requests POSTed from 8
   threads. Every answer must be HTTP 200 with finite probabilities summing
   to 1, equal (1e-4) to the same batches run with the plain attention on the
   card, and the forward kernel's launch counter must show 3 layers x 3
   forwards for every coalesced batch;
3d. the same at 8 heads (Dh=96, K6's instance), without the throughput
   runs: every answer equal (1e-4) to the plain attention's, and exactly 3
   layers x 3 forwards of the Dh=96 forward instance for every coalesced
   batch, and no launch at another head dim (phase 3 holds the same exact
   count at Dh=256);
3b. MMBT serving end to end at full width: BERT-base + ResNet-152, 3 image
   embeddings, 101 classes, random weights from a seed, saved and loaded
   through ``MMBTPredictor(device="cuda")`` behind ``mmbt_micro_batcher(
   uncertainty=True)`` and a ``PredictionServer``; 24 requests (texts of
   8-160 tokens and two of 509, so S=517 occurs; 224x224x3 float images)
   POSTed from 8 threads. The same checks as 3, with exactly 12 layers x 3
   forwards of the kernel for every coalesced batch;
3c. ViLT serving end to end at full width: ViLT-B/32 (768 wide, 12 layers of
   12 heads of 64, FFN 3072, 384x384 images in 32x32 patches, 101 classes,
   random weights from a seed) saved and loaded through
   ``ViltPredictor(device="cuda")`` behind ``vilt_micro_batcher(
   uncertainty=True)`` and a ``PredictionServer`` (``predict --framework
   vilt --serve``'s chain); 24 requests (texts of 3-40 tokens, 384x384x3
   float pixels, some with a top-left 256x320 pixel mask and one with a zero
   mask) POSTed from 8 threads. The same checks as 3, with exactly 12 layers x
   3 forwards of the forward kernel (K1, packed QKV) for every coalesced
   batch;
3e. the serving extras at full width (``phase_3e``; ``--phase3e`` runs phases
   1 and 3e alone): ``predict --quantize int8`` and ``int8_weight`` over HTTP
   (the CLI's own server, 16 requests from 8 threads) for FLAVA fusion at 3
   heads (``--uncertainty``, S to 736) and 8 heads, MMBT (BERT-base +
   ResNet-152, S 37-517) and ViLT-B/32: answers within 0.05 / 0.02 (max |dp|)
   of the fp32 server's on the same coalesced batches with argmax agreement
   of at least 2/3, one int8 product (``ops/quant.py::int8_mm_cuda``) a
   quantized Linear call, the attention launches equal to the fp32 replay's,
   one Linear's int8 product on its served activation equal to the CPU's
   int32 product (rescaled output within 1e-6 relative); each family's
   ``torch.export`` artifact (``predict --export``; FLAVA also with symbolic
   lengths and written on the CPU; MMBT with its ablation keep mask) served
   by ``predict --artifact DIR --serve 0`` in subprocesses, which import
   nothing of ``models/``, ``zoo`` or ``serving``, within 1e-5 of the live
   predictor with and without ``--uncertainty`` and with its attention
   launches; a tampered ``program.pt2`` refused; served samples/s at batch
   32 (fp32, int8, int8_weight, artifact); ``tools/bench_quant.py`` and
   ``tools/bench_export.py`` at their defaults; the operator's host cost per
   call against its body's. After phase 6c, ``tools/calibrate.py`` fits a
   temperature on its FashionMNIST dumps (finite T > 0, NLL not worse);
4. training end to end at full width: ``python -m
   multimodal_uncertainty_tpu_torch.train --framework flava`` (its ``main``)
   on synthetic packed shards (197 image tokens, text of 5-77 tokens and a
   few of 512, 101 classes; 640 train, 128 val, 128 test samples), MIMO, batch
   128, 2 epochs on ``cuda``. history.csv must have 2 finite rows, the
   checkpoints must exist, a resume from model_last_epoch.pt must reproduce
   the last val_loss and val_acc (1e-6), the backward kernel must have run 3
   layers x train steps times and the forward kernel 3 x (train steps + eval
   batches); the first 5 steps rerun from the same weights, batches and
   permutations with the plain attention forward on the card, differentiated
   by autograd, must give losses within 1e-4 relative and parameters within 2 x the sum of
   the 5 learning rates (AdamW normalises each element's step, so an element
   whose gradient is within rounding of 0 can step up to lr either way);
4d. the train CLI again at 8 heads (Dh=96) on phase 4's shards, 2 epochs:
   the same checks as 4, with exact launch counts of the Dh=96 instances
   and none of another head dim;
6. the robustness sweep CLI, ``python -m multimodal_uncertainty_tpu_torch.
   eval_transformer_robustness`` (its ``main``), on phase 4d's best
   checkpoint over the dev split (128 samples, batch 32) with 20 controls
   per modality (V = 43): a (128, 43, 2, 101) float32 predictions file and
   a (128,) labels file; exactly 3 layers x 3 chunks of up to 16 variants x
   4 batches launches of the Dh=96 forward instance; the same sweep
   in-process with the plain attention on the card equal within 1e-4 x
   max(1, max|plain|); its variant-samples/s. Then at 3 heads on phase 4's
   checkpoint with 2 controls (V = 7), on K1's Dh=256 instance;
4e. one FLAVA train step (batch 8, S = 224 + 96) at 1, 2, 4, 16 and 32
   heads (Dh 768, 384, 192, 48, 24) with the kernels and with the plain
   attention on the card, from the same weights, batch and step seed:
   exactly 3 forward and 3 backward launches at the head dim, and every
   parameter's gradient within 1e-4 x the leaf's max |gradient|;
4b. MMBT training end to end at full width: ``python -m
   multimodal_uncertainty_tpu_torch.train --framework mmbt`` (its ``main``)
   on a synthetic Food-101 tree (101 labels, a 30522-word vocabulary with
   BERT's special ids, 256 / 64 / 64 rows, 256x256 P6 images, texts making
   S run from 37 to 517), BERT-base + ResNet-152, batch 32, accumulation 4,
   2 epochs with both encoders frozen in epoch 1, lr 5e-5, on ``cuda``:
   history.csv has 2 finite rows, the checkpoints exist, a resume
   reproduces val_loss and val_acc (1e-6), the ResNet's weights are
   bit-unchanged through epoch 1 while its BatchNorm statistics move, and
   changed by epoch 2; K2 bwd launched 12 x micro-steps, K2 fwd 12 x
   (micro-steps + eval batches); epoch 1 rerun with the plain attention on
   the card (the same weights, batches and step seeds) gives losses within
   1e-4 relative and parameters within 2 x the sum of the learning rates.
   Then 1 epoch with ``--attention_probs_dropout 0.1``: K5 fwd and bwd
   launched 12 x micro-steps and K2 bwd never; the first 4 micro-steps rerun
   with the plain dropout attention (the same masks, from the same seeds)
   give losses within 1e-4 relative. Then ``--fast_dw`` on both: one train
   step of the full-width FLAVA (batch 32) and one micro-step of the
   full-width MMBT (batch 32, both encoders live, then both frozen), each
   counted from 0: exactly one dW launch per Linear whose widths are
   multiples of 128 and whose weight is trainable (FLAVA 2 + 4 x 3, MMBT 6 x
   12 + 2, frozen 2); the loss of the same step without the kernel (1e-5
   relative); every trainable Linear weight's gradient within 1e-4 x the
   max |gradient| of that weight of the same step's with autograd's dW; and
   K8 against ``dw_plain`` at every (K, Din, Dout) these steps gave it (FLAVA
   K = 32 x 224, 32 x 96 and 32 x 320; MMBT 32 x 165 and the image
   embedding's K = 96 at 2048 x 768), tolerance as in phase 2;
4c. ViLT training end to end at full width: ``python -m
   multimodal_uncertainty_tpu_torch.train --framework vilt --fast_dw`` (its
   ``main``) on a synthetic Food-101 tree (101 labels, BERT's 30522-word
   vocabulary and special ids, 128 / 64 / 64 rows, 384x384 P6 images, texts
   cut to 40 ids, so S = 185), ViLT-B/32, batch 32, accumulation 2, lr 3e-5,
   2 epochs: history.csv has 2 finite rows, the checkpoints exist, a resume
   reproduces val_loss and val_acc (1e-6); the dW kernel launched 50 x
   micro-steps (4 Linears a block x 12, the pooler and cls_fc; cls_out's 101
   outputs are no multiple of 128), K1 bwd 12 x micro-steps, K1 fwd 12 x
   (micro-steps + eval batches); epoch 1 rerun without ``--fast_dw``
   (autograd's dW) from the same weights, batches and step seeds gives losses
   within 1e-4 relative, the summed gradients of the first accumulation window
   (micro-steps 1-2, before any weight moves) leaf by leaf within 1e-4 x the
   leaf's max |gradient|, and parameters within 2 x the sum of the learning
   rates (a bound AdamW's normalised steps meet whatever the gradient); K8
   is held to ``dw_plain`` at every shape of this run not checked in phase 2;
5. times (CUDA events after warm-up): each kernel, its plain version,
   ``F.scaled_dot_product_attention`` (forward, or its backward) on the same
   inputs (a yardstick, used nowhere in the port), the kernel's bound, at the
   fusion shapes and at MMBT's (B=32, Dh=64, S=165 and 517); the predictors'
   samples/s (fusion at batch 32 and 128, MMBT at batch 32 for S=165 and
   517) and the train step's ms and samples/s at batch 128 (host clock), and
   under ``torch.profiler`` the device's busy share and its time by kind and
   by operation; K2 bwd and K5 fwd / bwd at B=32, S=165 and 517 with their
   plain versions, bounds and SDPA (with ``dropout_p`` for K5); the MMBT
   train micro-step at batch 32, S=165 and 517, both encoders live, with
   one BertAdam apply and a profile; K8 at ViLT's shapes (fp32 and bf16)
   and at FLAVA's train step's (K = 10240, fp32) with ``dw_plain``, one
   ``torch.matmul`` of the same product and the bound (fp32: the FMA units'
   and the split-fp32 kernel's, which it is held to); the ViLT predictor's
   samples/s at batch 32 (S=185) with a profile;
   the ViLT train micro-step at batch 32 with autograd's dW and with
   ``--fast_dw``, in turns, each with a profile; the instances of Dh 24,
   48, 96, 192, 384 and 768 (forward at B=32, backward at B=128, S=320,
   fp32; the forward at 384 and 768 and the backward at 256, 384 and 768 in
   bf16 too) with their plain versions, bounds and SDPA; the backward at
   ViLT's 12 heads of 64 (B=32, S=185); the predictor's
   samples/s and the train step's ms at 8 heads. Each profile counts the
   hand-written kernels' events against the launch counters and says
   ``complete`` or ``incomplete``.

4f. FLAVA ``--bf16`` training at full width (the JAX package's training
   preset): the train CLI with ``--bf16`` on phase 4's shards, 3 heads (Dh
   256), batch 128, 2 epochs, S = 320 and 736: every attention launch a bf16
   one on the source ``fwd_source`` / ``bwd_source`` names (the launches
   recorded with the sources they asked the build for), none in fp32,
   counts exact; history finite; the checkpoint's parameters, buffers and
   moments fp32; a resume into a fresh bf16 setup reproduces val_loss and
   val_acc (1e-6). Then one step at batch 32, S = 320 from one set of
   weights and one batch: bf16 with the kernels and ``--fast_dw`` (one dW
   launch a trainable Linear of widths multiple of 128, every one at K >
   ``MMA_MAX_K`` on the stream-K ``dw_kernel_tc``) against bf16 with the
   plain attention and autograd's dW, every gradient leaf within 3e-2 x
   max(1, max|ref|); its loss within 2e-2 relative of the fp32 step's; the
   same at 8, 4, 16, 32, 2 and 1 heads (Dh 96, 192, 48 and 24: K6's bf16
   tensor-core sources; 384 and 768: the
   forward and backward on the tensor-core clusters of
   ``csrc/attention_{fwd,bwd}_tc_{384,768}.cu``, none on the FMA clusters of
   ``csrc/attention_bwd_wide.cu``); every attention launch of
   these on the source its head dim's route names (``launches_tc`` where
   that is a tensor-core one), ``LAYERS`` in each direction; K8 against
   ``dw_plain`` at the step's bf16 shapes;
4i. the batch movers: 4f's train CLI (``--bf16``, batch 128, 2 epochs) four
   times, in the order plain, prefetch, prefetch, plain, the trainer's
   ``move_batches`` held to one mover by its ``PREFETCH_MIN_BYTES``:
   ``loaders.prefetch_to_device`` (pinned buffers, a side stream; the first
   prefetch run with the reference's ``--device_prefetch``) against
   ``steps.to_device`` from pageable memory on the consumer's stream as
   each batch comes; each run under the profiler
   (device activity only, no checkpoint file) with the epoch loop marked on
   the device's timeline by two ``spin_kernel`` launches: losses and
   history equal to the first run's (1e-6 relative), launches exact as in
   4f, in the loop the prefetch runs' copies all from pinned memory (3
   arrays a batch) and the plain runs' from pageable memory; each run's
   epoch-loop and whole-run device busy share (the union of the device's
   activities over the loop's device window and over the run's host wall)
   and ``Memcpy HtoD`` ms by source printed; the mover the trainer picks for
   FLAVA's batches (126 MiB and more) the prefetcher;
4g. MMBT ``--bf16`` training at full width on phase 4b's tree (BERT-base +
   ResNet-152, batch 32, accumulation 4): one epoch (K2 forward and backward
   on the bf16 tensor-core kernels at every launch), a resume, one epoch with
   ``--attention_probs_dropout 0.1`` (K5: every forward and every backward
   launch on the tensor-core kernels, ``csrc/attention_fwd_tc.cu`` and
   ``csrc/attention_bwd_tc.cu``, ``A.attention_fwd_dropout_cuda.launches_tc``
   and ``A.attention_bwd_dropout_cuda.launches_tc``), under 4f's gates; then
   one micro-step with both encoders live (bf16 kernels and
   ``--fast_dw`` against the plain attention and autograd's dW, 3e-2; the
   pooler's K = 32 (on its strided x[:, 0]) and the image embedding's K = 96
   on the small-K ``dw_kernel_mma``, every other dW launch on
   ``dw_kernel_tc``; the loss within 2e-2 of the fp32 micro-step's;
   BatchNorm's running statistics fp32 and finite).
   Phase 5 times the FLAVA train step (batch 128, S = 320 and 736) and the
   MMBT micro-step (S = 165 and 517) in bf16 beside fp32 in the same call,
   with their profiles (the bf16 FLAVA step's attention forward device ms
   printed apart), one profiled bf16 MMBT micro-step at S = 165 with
   attention-probs dropout 0.1 (K5's forward and backward device ms printed
   apart; it fails if no dropout forward or backward ran on the tensor
   cores), one profiled bf16 FLAVA step with ``--fast_dw`` (S = 320; the
   dW kernels' device ms printed apart), and each bf16 kernel of these paths
   at its main-path shape beside SDPA or ``torch.matmul`` in bf16 and its
   bound (989 TFLOP/s, or its bytes at 3.35 TB/s): K8 at every bf16 dW shape
   of 4f, 4g and the FLAVA train CLI (``BF16_DW_SHAPES``).

7. the last TPU kernels, off the model paths: K4, long-context attention
   through ``ops/attention.py::attention_flash`` at B=3, S=16384, 12 heads of
   64 (bench_flash's widths), fp32 and bf16, sample 0 with bench_flash's mask
   (its last fifth of keys masked), sample 1 with every key and sample 2 with
   none (fully masked rows: the uniform average), forward and backward
   through the autograd Function held against the plain versions one head at
   a time (lse 1e-4 / 2e-2; out 1e-4 and dq, dk, dv 1e-4 x max(1, max|ref|)
   in fp32, out 2e-2 x max|ref| and dq, dk, dv 3e-2 x max|ref| in bf16);
   then K4's entry point as a user runs it, ``python -m
   multimodal_uncertainty_tpu_torch.tools.bench_flash`` (its ``main``) at
   its defaults (S from 512 to 16384, B x S = 16384, bf16), counted from 0:
   every flash row a time, exactly 11 forward (and 11 backward) launches a
   flash row, every forward and backward launch on the tensor-core route; times of K4
   fwd and bwd at its S=16384 row (B=1) in both dtypes with the plain
   versions run one head at a time, SDPA and the bounds. K7,
   ``ops/norms.py::layer_norm_cuda``, against the plain LayerNorm at the
   FLAVA predictor's LayerNorm (32 x 320 rows of 768, K7's path), FLAVA
   training's (128 x 320), ViLT's (32 x 185 rows, eps 1e-12),
   300 x 64 and 300 x 100 (the generic instance), fp32 and bf16, and bf16
   rows around 300 (1e-5 / 2^-7 x max(1, max|ref|)); the full-width FLAVA predictor with every ``LayerNormFP32``
   on the kernel against the default, one uncertainty batch of 32: answers
   within 1e-4, exactly 8 LayerNorms x 3 forwards launches, every one on a
   (32, 320, 768) input; its times at the predictor's rows (the kernels
   line) and at training's, ``F.layer_norm`` and the bound. K8b, the dW
   prototype of ``tools/bench_dw.py``: ``csrc/dw.cu`` against ``dw_plain``
   at K = 70144, 768 x 3072, bf16; ``python -m
   multimodal_uncertainty_tpu_torch.tools.bench_dw`` (its ``main``) once,
   counted from 0 (31 dW launches, all on the stream-K ``dw_kernel_tc``);
   the kernel's time there.

4h. MMBT and ViLT as their users start them, from pretrained weights: a
   BERT-base file in the legacy ``pytorch_pretrained_bert`` names (``bert.``,
   LayerNorm ``gamma`` / ``beta``, its pre-training heads), a ResNet-152 file
   in torchvision's names (with ``fc`` and ``num_batches_tracked``) and a
   ViLT-B/32 file in HF's classification names, drawn from a seed other than
   the models' (about 0.7 and 0.45 GB fp32, on disk only). The train CLI
   (its ``main``) on phase 4b's tree with ``--bert_weights --resnet_weights``,
   1 epoch in each of 4i's four runs (the prefetcher, with and without
   ``--device_prefetch``, against the plain batch mover), each under
   the profiler with its epoch loop marked, as 4i (no checkpoint file
   written: the machine's disk takes about 45 GiB of writes a call, and 4b
   holds the checkpoints; 4b's and 4h's files are deleted before 4g):
   before step 1 (a copy on the card taken before the loop's mark, compared
   on the host after the run) every imported tensor equals the file's bit
   for bit (parameters and BatchNorm statistics); the runs' losses and
   history within 1e-6 relative of the first's; K2 launches exact as in 4b;
   the loop's copies 5 arrays a batch from pinned memory in the prefetch
   runs, from pageable memory in the plain ones; each run's epoch-loop and
   whole-run busy share and ``Memcpy HtoD`` ms by source printed; the mover
   the trainer picks for MMBT's 4.9 MiB batches the plain one. Then ``--framework vilt --vilt_weights
   --fast_dw``, 1 epoch on a ViLT tree: the import bit-exact before step 1
   (each block's ``qkv`` the rows of query, key and value), history finite,
   K1 and dW launches exact as in 4c;
6b. the MMBT robustness sweep CLI, ``python -m multimodal_uncertainty_tpu_torch.
   eval_mmbt_robustness`` (its ``main``), on phase 4b's best checkpoint over
   its dev split (64 rows, batch 32, 20 controls a modality: V = 43,
   BERT-base + ResNet-152): a (64, 43, 101) float32 predictions file and a
   (64,) labels file; exactly 12 layers x 6 chunks of up to 8 variants x 2
   batches = 144 K2 forward launches, all at Dh 64 on the split-fp32 route,
   and no other launch; the image encoder run once a batch (a forward
   hook); the same sweep in-process with the plain attention on the card
   equal within 1e-4 x max(1, max|plain|); its variant-samples/s in the
   CLI and warm (the sweep again in-process with the kernels).

4j. the FashionMNIST round: idx files at the dataset's own size
   (60000 / 10000 x 28 x 28 uint8, class templates with noise, a fifth of the
   labels random) written from a seed under a temporary ``DATA_DIR``; the
   train CLI, ``python -m multimodal_uncertainty_tpu_torch.train_fashionmnist``
   (its ``main``), ``--n_epochs 2`` (one epoch, the reference's quirk): the
   MIMO ResNet (MIMO-shuffle-instance at the root's defaults: batch 32, lr
   0.1, momentum 0.9, wd 1e-3; no attention launch), the MIMO transformer at
   3 heads (768 wide, 3 layers, BertAdam lr 1e-4; K1 at Dh 256, S = 4) and at
   8 heads (K6 at Dh 96, on ``--sample_size 6400``), weight-sharing on
   ``--sample_size 4096``: history.csv with one finite row, the checkpoints,
   a resume reproducing val_loss and val_acc (1e-6), exact launch counts
   (layers x (train steps + 2 x eval batches) forward, layers x train steps
   backward, at the one head dim); the 3-head transformer's first 100 steps
   rerun in-process with the kernels (the CLI's losses bit for bit) and with
   the plain attention: losses within 1e-4 relative, parameters within 2 x
   the sum of the learning rates; epoch walls and train samples/s printed;
6c. the two FashionMNIST evals, ``eval_robustness`` and
   ``eval_prediction_saving`` (their ``main``), on 4j's best checkpoints of
   the ResNet, the 3-head transformer and weight-sharing, batch 64 over the
   10000 t10k rows: (4, 10000, 4 or 3, 10) and (10000, 4, 10) float32 files,
   the dump's labels the t10k file's, the sweep's repeated per kept view
   under weight-sharing; exactly layers x 157 K1 forward launches a CLI for
   the transformer (4 x 64 rows each) and none for the ResNets; the
   transformer's sweep in-process with the plain attention within 1e-4 x
   max(1, max|plain|); the dump's accuracy within 0.1 points of history's
   val_acc; the round-1 analysis (accuracy, head diversity, missing-view
   accuracy) printed; the sweep's variant-samples/s. Phase 5 times K1 fwd
   and bwd at S = 4 (B = 32 and 256, Dh 256) beside SDPA and the bound, and
   profiles one ResNet and one transformer train step.

Phases run in the order 1, 2, 3, 3d, 3b, 3c, 4, 4d, 6, 4f, 4i, 4e, 4b, 4h, 6b, 4g, 4c, 4j,
6c, 5, 7.
The last lines are the launches of each path, the ``{"kernels": [...]}``
summary, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multimodal_uncertainty_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_uncertainty_tpu_torch.ops import _build  # noqa: E402
from multimodal_uncertainty_tpu_torch.ops import attention as A  # noqa: E402
from multimodal_uncertainty_tpu_torch.ops import dw as DW  # noqa: E402
from multimodal_uncertainty_tpu_torch.ops import norms as N  # noqa: E402
from multimodal_uncertainty_tpu_torch.tools.bench_attention import QUEUE_CYCLES  # noqa: E402

# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16 on
# them, HBM bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TF32_FLOPS = 495e12  # the split-fp32 kernels' rate: three TF32 products a fp32 one
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the forward output's gate adds RTOL x |plain| to TOL element by element: in bf16 one rounding
# step (bf16's eps), as both sides round fp32 sums to bf16 and two right sums a hair apart round
# a step apart, which is 2^-5 from |out| = 4 up, above the 2e-2 alone
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
D, HEADS, LAYERS, N_CLASSES = 768, 3, 3, 101
IMG_TOKENS, IMG_PADDED = 197, 224
DEVICE = "cuda"
N_REQUESTS, LONG_TEXT = 32, 512
THROUGHPUT = ((32, 77), (128, 77), (32, 512))  # (batch, text tokens)
TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_LR, TRAIN_SEED = 128, 2, 1e-4, 0
SPLITS = (("train", 640, 3), ("dev", 128, 0), ("test", 128, 1))  # (phase, n, 512-token texts)
# MMBT: BERT-base + ResNet-152 (``MMBT_BERT = None`` is BERT-base), 224x224 images
MMBT_BERT, MMBT_RESNET, MMBT_IMG, MMBT_IMG_TOKENS = None, (3, 8, 36, 3), 224, 5
MMBT_REQUESTS, MMBT_TEXT, MMBT_LONG_TEXT = 22, (8, 160), 509  # + 2 requests of 509 tokens
MMBT_THROUGHPUT = ((32, 160), (32, 512))  # (batch, text tokens): S = 165 and 517
# MMBT training (phase 4b): a synthetic Food-101 tree, BERT's 30522-word vocabulary;
# the longest text of each batch (train: in epoch 1's order), so S = 5 + a multiple of 32
# runs from 37 to 517
MMBT_VOCAB, MMBT_ROWS = 30522, (("train", 256), ("dev", 64), ("test", 64))
MMBT_LONGEST = {"train": (32, 64, 96, 160, 256, 384, 508, 128), "dev": (160, 508),
                "test": (32, 256)}
MMBT_TRAIN_BATCH, MMBT_ACCUM, MMBT_LR, MMBT_SEED, MMBT_DROPOUT = 32, 4, 5e-5, 0, 0.1
MMBT_TINY = False  # True: the CLI's --tiny (the CPU rehearsal)
# ViLT-B/32 (``VILT_CFG = None``; the CPU rehearsal sets a small ViltConfig), 384x384 images
VILT_CFG, VILT_TINY, VILT_IMG, VILT_MAX_TEXT = None, False, 384, 40
VILT_REQUESTS, VILT_MIN_TEXT = 24, 3  # texts of 3-40 tokens (one of 40)
VILT_ROWS = (("train", 128), ("dev", 64), ("test", 64))
VILT_TRAIN_BATCH, VILT_ACCUM, VILT_LR, VILT_SEED = 32, 2, 3e-5, 0
# K8 at ViLT's Linears: (K, Din, Dout); K = B * S = 32 x (40 + 145) for the token Linears, B
# for the pooler and cls_fc, and one K that is no multiple of any tile
DW_SHAPES = ((5920, 768, 2304), (5920, 768, 768), (5920, 768, 3072), (5920, 3072, 768),
             (32, 768, 768), (1001, 768, 768))
# and at FLAVA's train step's (batch 32, S = 224 + 96: K = 10240) Linears, timed in fp32
FLAVA_DW_SHAPES = ((10240, 768, 2304), (10240, 768, 768), (10240, 768, 3072),
                   (10240, 3072, 768))
# K8 in bf16 (--bf16 --fast_dw): FLAVA's train step (batch 32 x 320 rows: fc1, fc2, out_proj,
# in_proj; its projections' 32 x 224 and 32 x 96; the train CLI's batch 128 at fc1), MMBT's
# micro-step (32 x 165: fc1, fc2), its pooler's K = 32 and image embedding's K = 96 (the
# small-K kernel)
BF16_DW_SHAPES = ((10240, 768, 3072), (10240, 3072, 768), (10240, 768, 768), (10240, 768, 2304),
                  (7168, 768, 768), (3072, 768, 768), (40960, 768, 3072), (5280, 768, 3072),
                  (5280, 3072, 768), (32, 768, 768), (96, 2048, 768))
DW_TOL = 1e-4  # x max(1, max|plain|): fp32 sums of K products in another order
DW_CHECKED: dict = {}  # (K, Din, Dout, dtype) -> max abs error of compare_dw there
# FLAVA fusion at its other head counts: the instances added for them (Dh 24, 48, 96 and 192
# replace the JAX package's heads-first kernel K6; 384 and 768 are K1/K3 at 2 and 1 heads)
K6_HEAD_DIMS, WIDE_HEAD_DIMS = (24, 48, 96, 192), (384, 768)
# the kernels on register micro-tiles and clusters: the backward at every head dim of D=768
# (Dh 24 to 768), the forward at 256, 384 and 768; phase 2 holds both directions at every one
# to the plain versions at a ragged S (no multiple of their 32- and 64-row blocks), a fully
# masked sample included, and the dropout backward (Dh 32 and 64) at rates 0.1 and 0.5 there
CLUSTER_HEAD_DIMS, RAGGED_B, RAGGED_S = (24, 32, 48, 64, 96, 128, 192, 256, 384, 768), 3, 301
RAGGED_DROPOUT = ((12, 64), (2, 32))  # (heads, Dh): BERT-base's and the tiny BERT's
# phase 2: the bf16 tensor-core forward and backward at every head dim of A.TC_FWD_DIMS /
# A.TC_BWD_DIMS there too (the forward at Dh 256 at FLAVA's long text, S = 736, as well)
TC_SHORT_S = (1, 63, 165)
K6_HEADS = 8  # Dh=96: phases 3d (serving), 4d (training) and 6 (the sweep)
# phase 4f: one --bf16 step with the kernels against one with the plain attention at each head
# count (Dh 256, 96, 192, 48, 24, 384, 768, 128, 64, 32: every bf16 tensor-core forward and
# backward of FLAVA fusion, at 384 and 768 on clusters)
BF16_STEP_HEADS = (HEADS, K6_HEADS, 4, 16, 32, 2, 1, 6, 12, 24)
# phase 2 (FLAVA's serving shape, both dtypes) and phase 5: FLAVA fusion at 24 and 6 heads, which
# the JAX package runs on K1 (Dh 32 is the tiny BERT's too)
FLAVA_K1_DIMS = (32, 128)
STEP_HEADS, STEP_BATCH = (1, 2, 4, 16, 32), 8  # phase 4e: one train step at each, S = 224 + 96
SWEEP_BATCH, SWEEP_REPEATS, SWEEP_K1_REPEATS = 32, 20, 2  # phase 6 (V = 3 + 2 x repeats)
SWEEP_TOL = 1e-4  # x max(1, max|plain|): kernel vs plain logits, fp32 sums in another order
# the FashionMNIST round: the MIMO transformer attends over one token a view, S = 4, no key mask;
# phase 2 holds every head dim of D = 768 there at its train batch and the sweep's 4 x 64 rows
SHORT_S, SHORT_BATCHES = 4, (32, 256)
# phases 4j / 6c: idx files at the dataset's own size (train, t10k), written from a seed; the
# root CLI's batch, lr, momentum and wd for the ResNet; --n_epochs 2 trains one epoch (the
# reference's n_epochs - 1); the transformer at BertAdam's rate, at 3 heads (K1, Dh 256) and 8
# (K6, Dh 96); weight-sharing on a short run; the eval CLIs' batch 64
FMNIST_SPLITS, FMNIST_NOISE, FMNIST_SEED = (("train", 60000), ("t10k", 10000)), 0.35, 3
FMNIST_BATCH, FMNIST_EPOCHS, FMNIST_TF_LR, FMNIST_EVAL_BATCH = 32, 2, 1e-4, 64
FMNIST_HEADS, FMNIST_K6_HEADS = 3, 8
# --sample_size of the 8-head epoch and of weight-sharing's (the 3-head epoch takes 33 s alone)
FMNIST_K6_SAMPLES, FMNIST_WS_SAMPLES = 6400, 4096
FMNIST_ACC_TOL = 0.1  # percentage points: the dump's ensemble accuracy against history's val_acc
# the transformer's first steps held to the plain attention: over a whole epoch (1875 steps) the
# two fp32 trajectories part (``--fmnist-plain-gap`` prints the gap step by step)
FMNIST_PLAIN_STEPS = 100
# phase 4h: the pretrained state dicts are drawn from this seed (the models' is MMBT_SEED /
# VILT_SEED); phase 6b: the MMBT sweep over phase 4b's dev split (V = 43)
PRETRAINED_SEED, MMBT_SWEEP_REPEATS = 7, 20
# phase 7: K4 through attention_flash at bench_flash's widths and longest S; the bench_flash and
# bench_dw tools; K7; K8b at the dW prototype's shape
K4_S, K4_HEADS, K4_DH = 16384, 12, 64
FLASH_ITERS, K4_TIME_ITERS, DW_BENCH_ITERS = 10, 3, 30
# K7's path, the FLAVA predictor's LayerNorm input: batch 32, S = 224 + 96; FLAVA training's
# (batch 128) as a second reading
LN_PATH_SHAPE = (32, IMG_PADDED + 96, D)
LN_PATH_ROWS, LN_TRAIN_ROWS = 32 * (IMG_PADDED + 96), 128 * (IMG_PADDED + 96)
# (shape, eps, mean of x): the predictor's and training's LayerNorm, ViLT's (32 x 185 tokens,
# eps 1e-12), a ragged row count at a narrow width and at an odd one (K7's generic instance;
# D = 768 takes the instance that holds the row in registers), and bf16-sized rows around 300
LN_CASES = (((LN_PATH_ROWS, D), 1e-5, 0.0), ((LN_TRAIN_ROWS, D), 1e-5, 0.0),
            ((32 * 185, D), 1e-12, 0.0), ((300, 64), 1e-5, 0.0), ((300, 100), 1e-5, 0.0),
            ((4096, D), 1e-5, 300.0))
LN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}  # x max(1, max|plain|)
K8B_SHAPE = (70144, 768, 3072)  # tools/bench_dw.py: K = 256 x 274, the MLP's c_fc
# phases 4f / 4g (--bf16): one step with the kernels against the plain attention (and autograd's
# dW), leaf by leaf within BF16_GRAD_TOL x max(1, max|plain|) (bf16 activations rounded at other
# points), and the bf16 first step's loss within BF16_LOSS_RTOL of the fp32 step's
BF16_GRAD_TOL, BF16_LOSS_RTOL = 3e-2, 2e-2
# phase 3e: int8 serving over HTTP (QUANT_REQUESTS a family and mode), held to the fp32 answers
# with the JAX test's bounds (max |dp|; tests/test_quant.py:89-105); the bench tools' iterations
QUANT_REQUESTS, QUANT_TOL, BENCH_3E_ITERS = 12, {"int8": 0.05, "int8_weight": 0.02}, 5
ARTIFACT_REQUESTS = 6  # a served artifact's requests, one at a time (the longest text included)
MMBT_DH, VILT_DH = 64, 64  # BERT-base's and ViLT-B/32's head dim (the CPU rehearsal's: 32)
# phase 4k: one FLAVA step with --remat against one without at batch 128, S = 224 + 512, and
# one MMBT micro-step at batch 32, S = 5 + 512 (attention-probs dropout MMBT_DROPOUT, K5): the
# loss within REMAT_LOSS_RTOL, the gradients within REMAT_GRAD_TOL x max(1, max|ref|); the
# MMBT micro-step's gradients accumulate over 2^20 steps (a power of two: exact to undo)
REMAT_BATCH, MMBT_REMAT_TEXT, MMBT_REMAT_ACCUM = 128, 512, 2 ** 20
REMAT_LOSS_RTOL, REMAT_GRAD_TOL = 1e-6, {torch.float32: 1e-5, torch.bfloat16: BF16_GRAD_TOL}
# the diversity runs: FLAVA's train CLI for one epoch at batch 32 (20 steps), those steps held
# to the plain attention; the FashionMNIST transformer's first FMNIST_PLAIN_STEPS likewise
DIVERSITY_BATCH, DIVERSITY_KINDS = 32, ("guided", "random")
# preemption: FLAVA's train CLI (phase 4's shards, batch 128, 2 epochs) with a mid-epoch file
# every PREEMPT_EVERY batches, SIGTERMed once the file is first being written
PREEMPT_EVERY, PREEMPT_TIMEOUT = 3, 600


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def serving_mask(b: int, s: int, rng: np.random.Generator) -> torch.Tensor:
    """Key masks of a serving batch (224 image slots + text): row 0 fully
    masked (a padded batch row), 1-8 image-ablated, 9-16 text-ablated, the rest
    ragged (197 image tokens, text of random length)."""
    t = s - IMG_PADDED
    m = np.zeros((b, s), bool)
    m[:, :IMG_TOKENS] = True
    for i in range(b):
        m[i, IMG_PADDED:IMG_PADDED + int(rng.integers(1, t + 1))] = True
    m[0] = False
    m[1:9, :IMG_PADDED] = False
    m[9:17, IMG_PADDED:] = False
    return torch.from_numpy(m).to(DEVICE)


def mmbt_mask(b: int, s: int, rng: np.random.Generator) -> torch.Tensor:
    """Key masks of an MMBT batch (5 image tokens + text): the last row a
    batch-padding row (image segment only), rows 1-8 image-ablated (the image
    [CLS] and the text), 9-16 text-ablated (the image segment only), the rest
    ragged text."""
    m = np.zeros((b, s), bool)
    m[:, :MMBT_IMG_TOKENS] = True
    for i in range(b):
        m[i, MMBT_IMG_TOKENS:MMBT_IMG_TOKENS + int(rng.integers(1, s - MMBT_IMG_TOKENS + 1))] = True
    m[1:9, 1:MMBT_IMG_TOKENS] = False
    m[9:17, MMBT_IMG_TOKENS:] = False
    m[-1, MMBT_IMG_TOKENS:] = False
    return torch.from_numpy(m).to(DEVICE)


def default_mask(b: int, s: int, rng: np.random.Generator) -> torch.Tensor:
    """Phase 2's key masks: a serving batch's past the image slots, else 70 %
    of keys kept at random with row 0 fully masked."""
    if s > IMG_PADDED:
        return serving_mask(b, s, rng)
    mask = torch.rand(b, s, device=DEVICE) > 0.3
    mask[0] = False
    return mask


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def fwd_within(out: torch.Tensor, ref: torch.Tensor, dtype) -> bool:
    """A forward output against its plain version: |out - ref| <= TOL + RTOL x |ref|."""
    ref = ref.float()
    return bool(((out.float() - ref).abs() <= TOL[dtype] + RTOL[dtype] * ref.abs()).all())


def compare_kernel(b, s, n_head, dh, dtype, rng, mask=None, keyless: bool = False) -> float:
    """Kernel vs plain through both entry points; returns the max abs error.
    With an explicit ``mask``, the lse of its fully masked samples must be
    exactly -1e30 (what the backward kernels read as "fully masked");
    ``keyless``: no key mask at all (the MIMO transformer's)."""
    d = n_head * dh
    qkv = torch.randn(b, s, 3 * d, device=DEVICE).to(dtype)
    given = mask is not None
    if not given and not keyless:
        mask = default_mask(b, s, rng)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    tc0, tc32_0 = A.attention_fwd_cuda.launches_tc, A.attention_fwd_cuda.launches_tc32
    out = A.attention_qkv_packed(qkv, mask, n_head=n_head)
    out2, lse = A.attention_flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                                      n_head=n_head)
    torch.cuda.synchronize()
    check_tc_route(dtype, dh, A.attention_fwd_cuda.launches_tc - tc0, 2, fwd=True)
    check_tc32_route(dtype, dh, A.attention_fwd_cuda.launches_tc32 - tc32_0, 2)
    errs = [max_err(out, ref), max_err(out2, ref), max_err(lse, ref_lse)]
    err = max(errs)
    print(f"kernel-vs-plain B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]}: "
          f"out {errs[0]:.3g} out(separate) {errs[1]:.3g} lse {errs[2]:.3g}", flush=True)
    check(out.dtype == dtype and out.shape == (b, s, d) and lse.shape == (b, n_head, s),
          "kernel output dtype/shape")
    check(bool(torch.isfinite(out.float()).all()), "kernel output not finite")
    check(fwd_within(out, ref, dtype) and fwd_within(out2, ref, dtype) and errs[2] <= TOL[dtype],
          f"kernel disagrees with plain: {errs} > {TOL[dtype]} + {RTOL[dtype]} x |plain|")
    if given:
        dead = ~mask.any(dim=1)
        check(bool(dead.any()) and bool((lse[dead] == A.NEG_INF).all()),
              "the lse of a fully masked sample is not exactly -1e30")
    return err


def compare_heads_last(b, s, n_head, dh, dtype, rng) -> float:
    """The kernel through ``attention_heads_last`` (BERT's separate q, k, v)
    and ``attention_flash_fwd`` (its LSE) vs plain, on MMBT's masks."""
    d = n_head * dh
    q, k, v = (torch.randn(b, s, d, device=DEVICE).to(dtype) for _ in range(3))
    mask = mmbt_mask(b, s, rng)
    ref, ref_lse = A.attention_fwd_plain(q, k, v, mask, n_head=n_head)
    tc0, tc32_0 = A.attention_fwd_cuda.launches_tc, A.attention_fwd_cuda.launches_tc32
    out = A.attention_heads_last(q, k, v, mask, n_head=n_head)
    lse = A.attention_flash_fwd(q, k, v, mask, n_head=n_head)[1]
    torch.cuda.synchronize()
    check_tc_route(dtype, dh, A.attention_fwd_cuda.launches_tc - tc0, 2, fwd=True)
    check_tc32_route(dtype, dh, A.attention_fwd_cuda.launches_tc32 - tc32_0, 2)
    errs = [max_err(out, ref), max_err(lse, ref_lse)]
    print(f"kernel-vs-plain heads-last B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]}: "
          f"out {errs[0]:.3g} lse {errs[1]:.3g}", flush=True)
    check(out.dtype == dtype and out.shape == (b, s, d), "heads-last output dtype/shape")
    check(bool(torch.isfinite(out.float()).all()), "heads-last output not finite")
    check(fwd_within(out, ref, dtype) and errs[1] <= TOL[dtype],
          f"heads-last kernel disagrees with plain: {errs} > {TOL[dtype]} + {RTOL[dtype]} x |plain|")
    return max(errs)


def plain_heads_last(q, k, v, key_mask=None, *, n_head):
    """``attention_heads_last`` through the plain forward: the reference on
    the card for MMBT's served answers."""
    return A.attention_fwd_plain(q, k, v, key_mask, n_head=n_head)[0]


def plain_packed(qkv, key_mask=None, *, n_head):
    """The packed entry point through the plain forward (autograd gives its
    backward): the reference on the card for the served answers, the
    gradients and the training steps."""
    d = qkv.shape[-1] // 3
    return A.attention_fwd_plain(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                                 key_mask, n_head=n_head)[0]


def bwd_tol(dtype, ref: torch.Tensor) -> float:
    """fp32: 1e-4 x max(1, max|ref|), as dK and dV sum over S queries in
    another order; bf16: 3e-2 x max(1, max|ref|), P and dS are rounded to
    bf16 (the plain autograd rounds dP too) and the gradient is stored in bf16."""
    return BWD_TOL[dtype] * max(1.0, float(ref.float().abs().max()))


def check_tc_route(dtype, dh: int, tc_launches: int, launches: int, fwd: bool = False) -> None:
    """Every one of ``launches`` backward (``fwd``: forward) launches at
    (dtype, dh) went to the tensor-core kernels of ``csrc/attention_bwd_tc*.cu``
    (``csrc/attention_fwd_tc*.cu``, ``A.TC_FWD_SOURCES``: the split-fp32
    ``attention_fwd_tc32*`` share the prefix) if that is their route (bf16 at
    the head dims of ``A.TC_BWD_DIMS``, ``A.TC_FWD_DIMS``), and none did
    otherwise."""
    on_tc = (A.fwd_source(dtype, dh, False) in A.TC_FWD_SOURCES if fwd
             else A.bwd_source(dtype, dh, False) in A.TC_BWD_SOURCES)
    want = launches if on_tc else 0
    check(tc_launches == want, f"{tc_launches} of {launches} {'forward' if fwd else 'backward'} "
          f"launches at Dh={dh} {str(dtype)[6:]} took the tensor-core route, not {want}")


def check_tc32_route(dtype, dh: int, tc32_launches: int, launches: int,
                     dropout: bool = False) -> None:
    """Every one of ``launches`` forward launches at (dtype, dh) went to the
    split-fp32 tensor-core kernel (``csrc/attention_fwd_tc32*.cu``) if that is
    their route (fp32 at Dh 24-192, with or without dropout), and none did
    otherwise."""
    want = launches if A.fwd_source(dtype, dh, dropout).startswith(A.TC32_FWD_SOURCE) else 0
    check(tc32_launches == want, f"{tc32_launches} of {launches} forward launches at Dh={dh} "
          f"{str(dtype)[6:]}{' with dropout' if dropout else ''} took the split-fp32 route, "
          f"not {want}")


def check_fwd_routes(label: str) -> None:
    """Since the counters were reset (a model path, fp32): each forward launch
    at a head dim whose route is the split-fp32 kernel counted in its
    wrapper's ``launches_tc32``, and no other launch did."""
    for wrapper, dropout in ((A.attention_fwd_cuda, False), (A.attention_fwd_dropout_cuda, True)):
        want = sum(n for dh, n in wrapper.launches_by_dh.items()
                   if A.fwd_source(torch.float32, dh, dropout).startswith(A.TC32_FWD_SOURCE))
        check(wrapper.launches_tc32 == want,
              f"{label}: {wrapper.launches_tc32} split-fp32 forward launches"
              f"{' with dropout' if dropout else ''}, not {want} ({wrapper.launches_by_dh})")


def fwd_bounds(flops: float, nbytes: float, dtype, dh: int, dropout: bool = False) -> dict:
    """A forward row's bound: the larger of ``flops`` at the card's rate for
    the input type and ``nbytes`` at the memory rate; a kernel on the
    split-fp32 route is held to its three TF32 products at 495 TFLOP/s
    (``tc32_bound_ms``), the FMA units' bound beside it (``fma_bound_ms``)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    extra = {}
    if A.fwd_source(dtype, dh, dropout).startswith(A.TC32_FWD_SOURCE):
        extra = {"fma_bound_ms": max(t_ops, t_bytes),
                 "tc32_bound_ms": max(3 * flops / TF32_FLOPS * 1e3, t_bytes)}
        t_ops = 3 * flops / TF32_FLOPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", **extra}


def compare_backward(b, s, n_head, dh, dtype, rng, mask=None, keyless: bool = False) -> float:
    """The backward kernel vs its plain version, and the gradients through the
    autograd Functions (both entry points) vs autograd through the plain
    forward; returns the kernel's max abs error against the plain backward.
    ``keyless``: no key mask at all."""
    d = n_head * dh
    qkv = torch.randn(b, s, 3 * d, device=DEVICE).to(dtype)
    g = torch.randn(b, s, d, device=DEVICE).to(dtype)
    if mask is None and not keyless:
        mask = default_mask(b, s, rng)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    ref = A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head)
    tc0, fwd_tc0 = A.attention_bwd_cuda.launches_tc, A.attention_fwd_cuda.launches_tc
    tc32_0 = A.attention_fwd_cuda.launches_tc32
    out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)
    got = A.attention_bwd_cuda(q, k, v, mask, out, lse, g, n_head=n_head)

    x = qkv.clone().requires_grad_()
    plain_packed(x, mask, n_head=n_head).backward(g)
    auto_ref = x.grad
    x = qkv.clone().requires_grad_()
    A.attention_qkv_packed(x, mask, n_head=n_head).backward(g)
    packed = x.grad
    sep = [t.contiguous().requires_grad_() for t in (q, k, v)]
    A.attention_flash_fwd(*sep, mask, n_head=n_head)[0].backward(g)
    separate = torch.cat([t.grad for t in sep], dim=-1)
    torch.cuda.synchronize()
    check_tc_route(dtype, dh, A.attention_bwd_cuda.launches_tc - tc0, 3)
    check_tc_route(dtype, dh, A.attention_fwd_cuda.launches_tc - fwd_tc0, 3, fwd=True)
    check_tc32_route(dtype, dh, A.attention_fwd_cuda.launches_tc32 - tc32_0, 3)

    errs = {
        "kernel": max(max_err(a, r) for a, r in zip(got, ref)),
        "packed": max_err(packed, auto_ref),
        "separate": max_err(separate, auto_ref),
    }
    tols = {"kernel": max(bwd_tol(dtype, r) for r in ref), "packed": bwd_tol(dtype, auto_ref),
            "separate": bwd_tol(dtype, auto_ref)}
    print(f"backward-vs-plain B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]}: "
          + " ".join(f"{k} {errs[k]:.3g} (tol {tols[k]:.3g})" for k in errs), flush=True)
    check(packed.dtype == dtype and packed.shape == (b, s, 3 * d), "packed gradient dtype/shape")
    check(all(bool(torch.isfinite(t.float()).all()) for t in (*got, packed, separate)),
          "backward kernel output not finite")
    for k_ in errs:
        check(errs[k_] <= tols[k_], f"backward {k_} disagrees with plain: {errs[k_]} > {tols[k_]}")
    return errs["kernel"]


@contextlib.contextmanager
def sources_loaded():
    """The CUDA sources that the launches inside the block ask
    ``_build.load`` for, in order (one request a launch)."""
    names, real = [], _build.load

    def load(name):
        names.append(name)
        return real(name)

    _build.load = load
    try:
        yield names
    finally:
        _build.load = real


def ragged_mask(b: int, s: int, rng: np.random.Generator) -> torch.Tensor:
    """A random key mask (70 % kept) with sample 1 fully masked and sample 2
    keeping every key."""
    mask = torch.from_numpy(rng.random((b, s)) > 0.3).to(DEVICE)
    mask[1] = False
    mask[2] = True
    return mask


def compare_ragged(dh, dtype, rng) -> tuple:
    """The forward and the backward at head dim ``dh`` at B=3, S=301 (no
    multiple of the 32- and 64-row blocks), under ``compare_kernel``'s and
    ``compare_backward``'s gates, with a random key mask (70 % kept), sample
    1 fully masked (its lse exactly -1e30, its gradient the uniform
    average's) and sample 2 with every key; every launch must have taken the
    source ``fwd_source`` / ``bwd_source`` names. Returns the (forward,
    backward) max abs errors."""
    mask = ragged_mask(RAGGED_B, RAGGED_S, rng)
    with sources_loaded() as names:
        fwd = compare_kernel(RAGGED_B, RAGGED_S, D // dh, dh, dtype, rng, mask=mask)
        bwd = compare_backward(RAGGED_B, RAGGED_S, D // dh, dh, dtype, rng, mask=mask)
    # compare_kernel launches 2 forwards, compare_backward 3 forwards and 3 backwards
    want = {A.fwd_source(dtype, dh, False): 5, A.bwd_source(dtype, dh, False): 3}
    got = {n: names.count(n) for n in names}
    check(got == want, f"Dh={dh} {str(dtype)[6:]} at S={RAGGED_S}: launches by source {got}, "
          f"not {want}")
    return fwd, bwd


def compare_short(dh, rng) -> tuple:
    """The fp32 forward and backward at head dim ``dh`` at the MIMO
    transformer's S = 4 (one token a view, no key mask), at its train batch
    and the sweep's 4 x 64 rows (``SHORT_BATCHES``), and at B=3 with a random
    key mask, sample 1 fully masked and sample 2 with every key, under
    ``compare_kernel``'s and ``compare_backward``'s gates (4 real rows of the
    kernels' 32- and 64-row blocks); every launch on the source
    ``fwd_source`` / ``bwd_source`` names. Returns the (forward, backward)
    max abs errors."""
    dtype, n_head = torch.float32, D // dh
    fwd, bwd = [], []
    with sources_loaded() as names:
        for b in SHORT_BATCHES:
            fwd.append(compare_kernel(b, SHORT_S, n_head, dh, dtype, rng, keyless=True))
            bwd.append(compare_backward(b, SHORT_S, n_head, dh, dtype, rng, keyless=True))
        mask = ragged_mask(RAGGED_B, SHORT_S, rng)
        fwd.append(compare_kernel(RAGGED_B, SHORT_S, n_head, dh, dtype, rng, mask=mask))
        bwd.append(compare_backward(RAGGED_B, SHORT_S, n_head, dh, dtype, rng, mask=mask))
    cases = len(SHORT_BATCHES) + 1  # each: 2 + 3 forward launches, 3 backward
    want = {A.fwd_source(dtype, dh, False): 5 * cases, A.bwd_source(dtype, dh, False): 3 * cases}
    got = {n: names.count(n) for n in names}
    check(got == want, f"Dh={dh} fp32 at S={SHORT_S}: launches by source {got}, not {want}")
    return max(fwd), max(bwd)


def compare_heads_last_backward(b, s, n_head, dh, dtype, rng) -> float:
    """K2 bwd: the backward kernel on BERT's separate q, k, v, against the
    plain backward, and the gradients through ``attention_heads_last``'s
    Function against autograd through the plain forward, on MMBT's masks;
    returns the kernel's max abs error against the plain backward."""
    d = n_head * dh
    q, k, v, g = (torch.randn(b, s, d, device=DEVICE).to(dtype) for _ in range(4))
    mask = mmbt_mask(b, s, rng)
    ref = A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head)
    tc0, fwd_tc0 = A.attention_bwd_cuda.launches_tc, A.attention_fwd_cuda.launches_tc
    tc32_0 = A.attention_fwd_cuda.launches_tc32
    out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)
    got = A.attention_bwd_cuda(q, k, v, mask, out, lse, g, n_head=n_head)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_heads_last(*ins, mask, n_head=n_head).backward(g)
    auto_ref = [t.grad for t in ins]
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    A.attention_heads_last(*ins, mask, n_head=n_head).backward(g)
    torch.cuda.synchronize()
    check_tc_route(dtype, dh, A.attention_bwd_cuda.launches_tc - tc0, 2)
    check_tc_route(dtype, dh, A.attention_fwd_cuda.launches_tc - fwd_tc0, 2, fwd=True)
    check_tc32_route(dtype, dh, A.attention_fwd_cuda.launches_tc32 - tc32_0, 2)
    errs = {"kernel": max(max_err(a, r) for a, r in zip(got, ref)),
            "function": max(max_err(t.grad, r) for t, r in zip(ins, auto_ref))}
    tols = {"kernel": max(bwd_tol(dtype, r) for r in ref),
            "function": max(bwd_tol(dtype, r) for r in auto_ref)}
    print(f"backward-vs-plain heads-last B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]}: "
          + " ".join(f"{k} {errs[k]:.3g} (tol {tols[k]:.3g})" for k in errs), flush=True)
    check(all(bool(torch.isfinite(t.float()).all()) for t in (*got, *(t.grad for t in ins))),
          "heads-last backward not finite")
    for k_ in errs:
        check(errs[k_] <= tols[k_], f"heads-last backward {k_} disagrees: {errs[k_]} > {tols[k_]}")
    return errs["kernel"]


def compare_dropout(b, s, n_head, dh, dtype, rate, rng, mask=None) -> tuple:
    """K5: the dropout forward and backward kernels against
    ``attention_probs_dropout`` and ``attention_bwd_dropout_plain`` with the
    same keep mask (on MMBT's masks, or ``mask``), and the gradients through
    the dropout Function; returns the (forward, backward) max abs errors;
    every launch must have taken ``fwd_source``'s / ``bwd_source``'s source
    (bf16: the tensor-core kernels ``attention_{fwd,bwd}_tc`` at Dh 64 and
    ``attention_{fwd,bwd}_tc_32`` at 32, counted in the dropout wrappers'
    ``launches_tc``; no
    dropout launch counts in ``attention_fwd_cuda.launches_tc``). The forward's tolerance is the
    forward's (1e-4 / 2e-2) times max(1, max|ref|): dropout scales the kept
    probabilities, and so the outputs, by 1 / (1 - rate), and in bf16 one
    rounding step of an output of 4 or more is 0.03125."""
    d = n_head * dh
    q, k, v, g = (torch.randn(b, s, d, device=DEVICE).to(dtype) for _ in range(4))
    if mask is None:
        mask = mmbt_mask(b, s, rng)
    keep = A.draw_keep_mask((b, n_head, s, s), rate,
                            generator=torch.Generator(DEVICE).manual_seed(s), device=DEVICE)
    ref = A.attention_probs_dropout(q, k, v, mask, n_head=n_head, rate=rate, keep=keep)
    ref_g = A.attention_bwd_dropout_plain(q, k, v, mask, keep, g, n_head=n_head, rate=rate)
    fwd_tc0 = A.attention_fwd_cuda.launches_tc
    drop_fwd_tc0 = A.attention_fwd_dropout_cuda.launches_tc
    drop_tc32_0 = A.attention_fwd_dropout_cuda.launches_tc32
    drop_tc0 = A.attention_bwd_dropout_cuda.launches_tc
    with sources_loaded() as names:
        out, lse = A.attention_fwd_dropout_cuda(q, k, v, mask, keep, n_head=n_head, rate=rate)
        got = A.attention_bwd_dropout_cuda(q, k, v, mask, keep, out, lse, g, n_head=n_head,
                                           rate=rate)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        A.attention_heads_last_dropout_keep(*ins, mask, keep, n_head=n_head,
                                            rate=rate).backward(g)
    torch.cuda.synchronize()
    fwd_names = [n for n in names if n.startswith("attention_fwd")]
    fwd_on_tc = A.fwd_source(dtype, dh, True) in A.TC_FWD_SOURCES  # bf16 at Dh 32 and 64
    check(A.attention_fwd_cuda.launches_tc == fwd_tc0
          and fwd_names == [A.fwd_source(dtype, dh, True)] * 2
          and fwd_on_tc == (dtype == torch.bfloat16 and dh in A.TC_FWD_DROPOUT_DIMS)
          and A.attention_fwd_dropout_cuda.launches_tc - drop_fwd_tc0 == (2 if fwd_on_tc else 0),
          f"dropout forward launches took {fwd_names}, "
          f"{A.attention_fwd_dropout_cuda.launches_tc - drop_fwd_tc0} on the tensor cores")
    check_tc32_route(dtype, dh, A.attention_fwd_dropout_cuda.launches_tc32 - drop_tc32_0, 2,
                     dropout=True)
    bwd_names = [n for n in names if n.startswith("attention_bwd")]
    on_tc = A.bwd_source(dtype, dh, True) in A.TC_BWD_SOURCES  # bf16 at Dh 32 and 64
    check(bwd_names == [A.bwd_source(dtype, dh, True)] * 2
          and A.attention_bwd_dropout_cuda.launches_tc - drop_tc0 == (2 if on_tc else 0),
          f"dropout backward launches took {bwd_names}, "
          f"{A.attention_bwd_dropout_cuda.launches_tc - drop_tc0} on the tensor cores")
    fwd = max_err(out, ref)
    fwd_tol = TOL[dtype] * max(1.0, float(ref.float().abs().max()))
    errs = {"kernel": max(max_err(a, r) for a, r in zip(got, ref_g)),
            "function": max(max_err(t.grad, r) for t, r in zip(ins, ref_g))}
    tol = max(bwd_tol(dtype, r) for r in ref_g)
    print(f"dropout-vs-plain B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]} rate {rate}: "
          f"forward {fwd:.3g} (tol {fwd_tol:.3g}) " + " ".join(
              f"backward {k} {errs[k]:.3g} (tol {tol:.3g})" for k in errs), flush=True)
    check(out.dtype == dtype and out.shape == (b, s, d), "dropout output dtype/shape")
    check(all(bool(torch.isfinite(t.float()).all()) for t in (out, *got)),
          "dropout kernels' output not finite")
    check(fwd <= fwd_tol, f"dropout forward disagrees with plain: {fwd} > {fwd_tol}")
    for k_ in errs:
        check(errs[k_] <= tol, f"dropout backward {k_} disagrees: {errs[k_]} > {tol}")
    return fwd, errs["kernel"]


def cuda_ms(fn, iters: int = 30) -> float:
    """Device ms a call of ``fn``: CUDA events around ``iters`` calls after
    3 warm-up ones. The card first spins (``torch.cuda._sleep``) while the
    host queues the calls, so a kernel shorter than its Python launch is
    timed on the card, not at the host's launch rate."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_attention(b, s, dtype, rng, heads: int = HEADS, mask_fn=serving_mask) -> dict:
    """The forward kernel through the packed entry point, its plain version,
    SDPA and the bound; ``mask_fn=None`` times it without a key mask."""
    dh = D // heads
    qkv = torch.randn(b, s, 3 * D, device=DEVICE).to(dtype)
    mask = mask_fn(b, s, rng) if mask_fn is not None else None
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    bias = None if mask is None else torch.zeros(
        b, 1, 1, s, device=DEVICE, dtype=dtype).masked_fill(~mask[:, None, None, :], A.NEG_INF)

    def split(t):
        return t.view(b, s, heads, dh).transpose(1, 2)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v), attn_mask=bias)

    isz = qkv.element_size()
    flops = 4 * b * s * s * D
    nbytes = b * s * 3 * D * isz + (b * s if mask is not None else 0) + b * s * D * isz
    row = {
        "B": b, "S": s, "Dh": dh, "dtype": str(dtype)[6:],
        "ms": cuda_ms(lambda: A.attention_qkv_packed(qkv, mask, n_head=heads)),
        "plain_ms": cuda_ms(lambda: A.attention_fwd_plain(q, k, v, mask, n_head=heads)),
        "library_ms": cuda_ms(library),
        **fwd_bounds(flops, nbytes, dtype, dh),
    }
    print("time attention_fwd " + json.dumps(row), flush=True)
    return row


def time_heads_last(b, s, dtype) -> dict:
    """The forward kernel at MMBT's shape (12 heads of Dh=64, separate q, k,
    v), its plain version, ``scaled_dot_product_attention``, the bound."""
    n_head, dh = 12, 64
    d = n_head * dh
    q, k, v = (torch.randn(b, s, d, device=DEVICE).to(dtype) for _ in range(3))
    mask = mmbt_mask(b, s, np.random.default_rng(s))
    bias = torch.zeros(b, 1, 1, s, device=DEVICE, dtype=dtype).masked_fill(
        ~mask[:, None, None, :], A.NEG_INF)

    def heads(t):
        return t.view(b, s, n_head, dh).transpose(1, 2)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=bias)

    isz = q.element_size()
    flops = 4 * b * s * s * d
    nbytes = 4 * b * s * d * isz + b * s  # q, k, v, out and the mask
    row = {
        "B": b, "S": s, "Dh": dh, "dtype": str(dtype)[6:],
        "ms": cuda_ms(lambda: A.attention_heads_last(q, k, v, mask, n_head=n_head)),
        "plain_ms": cuda_ms(lambda: A.attention_fwd_plain(q, k, v, mask, n_head=n_head)),
        "library_ms": cuda_ms(library),
        **fwd_bounds(flops, nbytes, dtype, dh),
    }
    print("time attention_fwd heads-last " + json.dumps(row), flush=True)
    return row


def time_mmbt_backward(b, s, dtype, rate: float = 0.0) -> dict:
    """At MMBT's shape (12 heads of Dh=64, separate q, k, v, MMBT masks):
    K2 bwd (``rate == 0``) or K5 fwd and bwd (``rate > 0``), each with its
    plain version, its bound, and ``scaled_dot_product_attention`` (with
    ``dropout_p`` for K5; it draws its own mask) as the yardstick."""
    n_head, dh = 12, 64
    d = n_head * dh
    q, k, v, g = (torch.randn(b, s, d, device=DEVICE).to(dtype) for _ in range(4))
    mask = mmbt_mask(b, s, np.random.default_rng(s))
    bias = torch.zeros(b, 1, 1, s, device=DEVICE, dtype=dtype).masked_fill(
        ~mask[:, None, None, :], A.NEG_INF)
    isz = q.element_size()
    iters = 10 if s > 300 else 30

    def heads(t):
        return t.reshape(b, s, n_head, dh).transpose(1, 2).detach().requires_grad_()

    hq, hk, hv = heads(q), heads(k), heads(v)
    lib_g = g.reshape(b, s, n_head, dh).transpose(1, 2)

    def row(name, ms, plain_ms, library_ms, flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        bounds = {"bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        if name == "attention_fwd_dropout":
            bounds = fwd_bounds(flops, nbytes, dtype, dh, dropout=True)
        r = {"B": b, "S": s, "Dh": dh, "dtype": str(dtype)[6:], "rate": rate, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms, **bounds}
        print(f"time {name} " + json.dumps(r), flush=True)
        return r

    bwd_bytes = 8 * b * s * d * isz + b * n_head * s * 4 + b * s  # q k v out dO dq dk dv, lse, mask
    if rate == 0.0:
        out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)
        lib_out = torch.nn.functional.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias)
        return {"bwd": row(
            "attention_bwd heads-last",
            cuda_ms(lambda: A.attention_bwd_cuda(q, k, v, mask, out, lse, g, n_head=n_head), iters),
            cuda_ms(lambda: A.attention_bwd_plain(q, k, v, mask, g, n_head=n_head), iters),
            cuda_ms(lambda: torch.autograd.grad(lib_out, (hq, hk, hv), lib_g,
                                                retain_graph=True), iters),
            10 * b * s * s * d, bwd_bytes)}
    keep = A.draw_keep_mask((b, n_head, s, s), rate, generator=torch.Generator(DEVICE).manual_seed(0),
                            device=DEVICE)
    out, lse = A.attention_fwd_dropout_cuda(q, k, v, mask, keep, n_head=n_head, rate=rate)

    def lib_fwd():
        return torch.nn.functional.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias,
                                                                dropout_p=rate)

    fwd = row("attention_fwd_dropout",
              cuda_ms(lambda: A.attention_fwd_dropout_cuda(q, k, v, mask, keep, n_head=n_head,
                                                           rate=rate), iters),
              cuda_ms(lambda: A.attention_probs_dropout(q, k, v, mask, n_head=n_head, rate=rate,
                                                        keep=keep), iters),
              cuda_ms(lib_fwd, iters), 4 * b * s * s * d,
              4 * b * s * d * isz + b * s + b * n_head * s * s)
    lib_out = lib_fwd()
    bwd = row("attention_bwd_dropout",
              cuda_ms(lambda: A.attention_bwd_dropout_cuda(q, k, v, mask, keep, out, lse, g,
                                                           n_head=n_head, rate=rate), iters),
              cuda_ms(lambda: A.attention_bwd_dropout_plain(q, k, v, mask, keep, g,
                                                            n_head=n_head, rate=rate), iters),
              cuda_ms(lambda: torch.autograd.grad(lib_out, (hq, hk, hv), lib_g,
                                                  retain_graph=True), iters),
              10 * b * s * s * d, bwd_bytes + b * n_head * s * s)
    return {"fwd_dropout": fwd, "bwd_dropout": bwd}


def post(port: int, payload: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict", data=payload,
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def serve_end_to_end(tmp: str, heads: int = HEADS, throughput=THROUGHPUT):
    """Phase 3 (and 3d at ``heads=K6_HEADS``); returns the kernel launches
    of the main path's run and the predictor (phase 5 times it)."""
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.server import (
        PredictionServer,
        fusion_request,
        uncertainty_result,
    )
    from multimodal_uncertainty_tpu_torch.serving import FusionPredictor, fusion_micro_batcher
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    kind = "MIMO-shuffle-instance"
    dh = D // heads
    model = build_flava(kind, n_classes=N_CLASSES, heads=heads, layers=LAYERS, device=DEVICE,
                        generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(tmp, "model_best_val.pt")
    save_weights(model, None, ckpt)
    template = build_flava(kind, n_classes=N_CLASSES, heads=heads, layers=LAYERS, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    pred = FusionPredictor(template, ckpt, device=DEVICE)
    mb = fusion_micro_batcher(pred, max_batch=32, max_wait_ms=5, uncertainty=True)
    batches = []
    run_batch = mb.predict_batch

    def recording(samples):
        batches.append(list(samples))
        return run_batch(samples)

    mb.predict_batch = recording

    rng = np.random.default_rng(0)
    text_lengths = [int(x) for x in rng.integers(5, 78, size=N_REQUESTS)] + [LONG_TEXT] * 2
    samples = []
    for i, lt in enumerate(text_lengths):
        img = rng.normal(size=(IMG_TOKENS, D)).astype(np.float32)
        img[0, 0] = i  # identifies the sample inside a coalesced batch
        samples.append((img, rng.normal(size=(lt, D)).astype(np.float32)))
    bodies = [json.dumps({"img": im.tolist(), "txt": tx.tolist()}).encode() for im, tx in samples]

    srv = PredictionServer(mb, fusion_request, port=0, encode_result=uncertainty_result).start()
    answers = {}
    try:
        def client(idx):
            for i in idx:
                answers[i] = post(srv.port, bodies[i])

        threads = [threading.Thread(target=client, args=(range(t, len(bodies), 8),))
                   for t in range(8)]
        reset_counters()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = A.attention_fwd_cuda.launches_by_dh.get(dh, 0)
        check(A.attention_fwd_cuda.launches == launches,
              f"serving launched instances other than Dh={dh}: "
              f"{A.attention_fwd_cuda.launches_by_dh}")
        check(A.attention_bwd_cuda.launches == 0, "serving launched the backward kernel")
        check_fwd_routes(f"flava serving ({heads} heads)")
    finally:
        srv.close()
        mb.close()
    check(len(answers) == len(samples), f"{len(answers)} of {len(samples)} requests answered")
    sizes = [len(bt) for bt in batches]
    print(f"serving ({heads} heads, Dh={dh}): {len(samples)} requests in {wall:.3f} s over "
          f"{len(batches)} coalesced batches {sizes}; kernel launches {launches} at Dh={dh}",
          flush=True)
    check(launches == LAYERS * 3 * len(batches),
          f"kernel launches {launches} != {LAYERS} layers x 3 forwards x {len(batches)} batches")

    # the same batches with the plain attention on the card
    T.attention_qkv_packed = plain_packed
    try:
        reference = {}
        for bt in batches:
            for smp, res in zip(bt, run_batch(bt)):
                reference[int(smp[0][0, 0])] = res
    finally:
        T.attention_qkv_packed = A.attention_qkv_packed
    worst = 0.0
    for i, (status, out) in answers.items():
        probs = np.asarray(out["probs"])
        check(status == 200, f"request {i}: HTTP {status}")
        check(probs.shape == (N_CLASSES,) and bool(np.isfinite(probs).all()),
              f"request {i}: probs shape {probs.shape} or not finite")
        check(abs(probs.sum() - 1.0) < 1e-4, f"request {i}: probs sum {probs.sum()}")
        ref_probs, ref_diag = reference[i]
        worst = max(worst, float(np.abs(probs - ref_probs).max()),
                    *(abs(out[k] - float(ref_diag[k])) for k in ref_diag))
    print(f"serving ({heads} heads): answers vs plain attention on the card, max abs diff "
          f"{worst:.3g}", flush=True)
    check(worst <= 1e-4, f"served answers differ from the plain attention by {worst}")

    for n, text in throughput:
        predictor_throughput(pred, n, text, rng)
    return launches, pred


def mmbt_model(seed: int, device: str):
    from multimodal_uncertainty_tpu_torch.zoo import build_mmbt

    return build_mmbt(N_CLASSES, bert_config=MMBT_BERT, resnet_layers=MMBT_RESNET,
                      device=device, generator=torch.Generator().manual_seed(seed))


def serve_mmbt_end_to_end(tmp: str):
    """Phase 3b; returns the kernel launches of the main path's run and the
    predictor (phase 5 times it)."""
    from multimodal_uncertainty_tpu_torch.models import bert as B_
    from multimodal_uncertainty_tpu_torch.server import (
        PredictionServer,
        mmbt_request,
        uncertainty_result,
    )
    from multimodal_uncertainty_tpu_torch.serving import MMBTPredictor, mmbt_micro_batcher
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "mmbt_best_val.pt")
    save_weights(mmbt_model(0, "cpu"), None, ckpt)
    pred = MMBTPredictor(mmbt_model(1, "cpu"), ckpt, device=DEVICE)
    n_layers = len(pred.model.enc.encoder.layer)
    vocab = pred.model.config.vocab_size
    print(f"mmbt: model built, saved and restored on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mb = mmbt_micro_batcher(pred, max_batch=32, max_wait_ms=5, uncertainty=True)
    batches, seq_lens = [], []
    run_batch = mb.predict_batch

    def recording(samples):
        batches.append(list(samples))
        seq_lens.append(MMBT_IMG_TOKENS + -(-max(len(smp[0]) for smp in samples) // 32) * 32)
        return run_batch(samples)

    mb.predict_batch = recording

    rng = np.random.default_rng(3)
    lengths = [int(x) for x in rng.integers(MMBT_TEXT[0], MMBT_TEXT[1] + 1, size=MMBT_REQUESTS)]
    lengths += [MMBT_LONG_TEXT] * 2
    bodies = []
    for i, lt in enumerate(lengths):
        img = np.round(rng.normal(size=(MMBT_IMG, MMBT_IMG, 3)), 3)
        img[0, 0, 0] = i  # identifies the sample inside a coalesced batch
        bodies.append(json.dumps({"token_ids": rng.integers(0, vocab, size=lt).tolist(),
                                  "segment": [0] * lt, "image": img.tolist()}).encode())

    srv = PredictionServer(mb, mmbt_request, port=0, encode_result=uncertainty_result).start()
    answers = {}
    try:
        def client(idx):
            for i in idx:
                answers[i] = post(srv.port, bodies[i])

        threads = [threading.Thread(target=client, args=(range(t, len(bodies), 8),))
                   for t in range(8)]
        reset_counters()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = A.attention_fwd_cuda.launches
        check(A.attention_bwd_cuda.launches == 0, "serving launched the backward kernel")
        check_fwd_routes("mmbt serving")
    finally:
        srv.close()
        mb.close()
    check(len(answers) == len(bodies), f"{len(answers)} of {len(bodies)} requests answered")
    print(f"mmbt serving: {len(bodies)} requests in {wall:.3f} s over {len(batches)} coalesced "
          f"batches {[len(bt) for bt in batches]} (S {seq_lens}); kernel launches {launches}",
          flush=True)
    check(launches == n_layers * 3 * len(batches),
          f"kernel launches {launches} != {n_layers} layers x 3 forwards x {len(batches)} batches")
    check(max(seq_lens) == MMBT_IMG_TOKENS + -(-MMBT_LONG_TEXT // 32) * 32,
          f"no batch reached S={MMBT_IMG_TOKENS + -(-MMBT_LONG_TEXT // 32) * 32}: {seq_lens}")

    # the same batches with the plain attention on the card
    B_.attention_heads_last = plain_heads_last
    try:
        reference = {}
        for bt in batches:
            for smp, res in zip(bt, run_batch(bt)):
                reference[int(smp[2][0, 0, 0])] = res
    finally:
        B_.attention_heads_last = A.attention_heads_last
    worst = 0.0
    for i, (status, out) in answers.items():
        probs = np.asarray(out["probs"])
        check(status == 200, f"request {i}: HTTP {status}")
        check(probs.shape == (N_CLASSES,) and bool(np.isfinite(probs).all()),
              f"request {i}: probs shape {probs.shape} or not finite")
        check(abs(probs.sum() - 1.0) < 1e-4, f"request {i}: probs sum {probs.sum()}")
        ref_probs, ref_diag = reference[i]
        worst = max(worst, float(np.abs(probs - ref_probs).max()),
                    *(abs(out[k] - float(ref_diag[k])) for k in ref_diag))
    print(f"mmbt serving: answers vs plain attention on the card, max abs diff {worst:.3g}",
          flush=True)
    check(worst <= 1e-4, f"served MMBT answers differ from the plain attention by {worst}")
    return launches, pred


def mmbt_throughput(pred, n: int, text: int, iters: int = 3) -> dict:
    """Samples/s of ``MMBTPredictor.predict`` (host clock; each call ends in
    a copy to the host), then one profiled pass."""
    rng = np.random.default_rng(text)
    vocab = pred.model.config.vocab_size
    txt = rng.integers(0, vocab, size=(n, text))
    mask, seg = np.ones((n, text), np.int64), np.zeros((n, text), np.int64)
    img = rng.normal(size=(n, MMBT_IMG, MMBT_IMG, 3)).astype(np.float32)
    s = MMBT_IMG_TOKENS + text
    pred.predict(txt, mask, seg, img)
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.predict(txt, mask, seg, img)
    dt = time.perf_counter() - t0
    print(f"mmbt predictor: batch {n} (S={s}): {iters * n / dt:.1f} samples/s", flush=True)
    prof = profile_device(lambda: pred.predict(txt, mask, seg, img), 1,
                          f"mmbt predictor batch {n} (S={s}) per batch")
    return {"S": s, "samples_per_s": iters * n / dt, **prof}


KINDS = (("attention_bwd", ("attention_bwd",)), ("attention_fwd", ("attention_fwd",)),
         ("dw", ("dw_kernel", "dw_reduce")),
         ("batchnorm", ("bn_fw", "bn_bw", "batch_norm")),
         ("convolution backward", ("dgrad", "wgrad", "bwd_data", "bwd_filter", "BackwardData",
                                   "BackwardFilter")),
         ("convolution", ("conv", "fprop", "winograd", "fft", "cudnn", "Nhwc", "nhwc")),
         ("gemm", ("gemm", "nvjet", "splitKreduce")), ("optimizer", ("multi_tensor_apply",)),
         ("copy", ("Memcpy", "Memset")))


def kind_of(op: str) -> str:
    """The layer a device operation belongs to, by its kernel's name."""
    return next((kind for kind, keys in KINDS if any(k in op for k in keys)),
                "elementwise and other")


COUNTERS = (A.attention_fwd_cuda, A.attention_bwd_cuda, A.attention_fwd_dropout_cuda,
            A.attention_bwd_dropout_cuda, DW.dw_cuda, N.layer_norm_cuda)
# the attention backward launches its delta, dQ and dK/dV passes (the dropout forward and
# backward on the tensor cores one more each, the keep mask's packing: ``profile_device`` adds
# them); a dW launch one dw_kernel (and, when it splits K, one dw_reduce)
KERNELS_PER_LAUNCH = (1, 3, 1, 3, 1, 1)


def reset_counters() -> None:
    for c in COUNTERS:
        c.launches = 0
        if hasattr(c, "launches_by_dh"):
            c.launches_by_dh.clear()
        for route in ("launches_tc", "launches_tc32", "launches_simt", "launches_mma"):
            if hasattr(c, route):
                setattr(c, route, 0)


def primer_records(names) -> int:
    """How many of a profile's device records, by kernel name, are the
    primer's (``prime_profile``)."""
    from multimodal_uncertainty_tpu_torch.training.trainer import PROFILE_PRIMER_KERNEL

    return sum(PROFILE_PRIMER_KERNEL in name for name in names)


def profile_device(fn, iters: int, label: str, cpu_ops: bool = True) -> dict:
    """Run ``fn`` ``iters`` times under ``torch.profiler``: the wall ms per
    call (host clock, ending in a synchronise), the device's busy ms and share
    of it, the device ms by kind of operation (cuBLAS's Hopper GEMMs,
    ``nvjet_*`` and their ``splitKreduce``, count as ``gemm``), and by
    operation (top 10). The attention kernels' events are counted against the launch counters'
    change over the profiled calls (and the dW kernel's): a profile that lost events says
    ``incomplete`` and its times are not to be quoted. ``cpu_ops=False`` records the
    device's activity only (a whole CLI run: the host's operator events would take longer
    to collect than the run). The session opens with the trainer's primer
    (``prime_profile``), which is left out of every time here; a profile complete
    in its events also holds a primer record, so it lost none after the primer.
    ``spans`` holds every other device event's (start, end) in µs and its name,
    for ``device_window``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multimodal_uncertainty_tpu_torch.training.trainer import (
        PROFILE_PRIMER,
        PROFILE_PRIMER_KERNEL,
        prime_profile,
    )

    before = [c.launches for c in COUNTERS]
    packs = A.attention_fwd_dropout_cuda.launches_tc + A.attention_bwd_dropout_cuda.launches_tc
    with profile(activities=([ProfilerActivity.CPU] if cpu_ops else []) + [ProfilerActivity.CUDA]) as prof:
        prime_profile(torch.device(DEVICE))
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    expected = (sum(n * (c.launches - b) for c, b, n in zip(COUNTERS, before, KERNELS_PER_LAUNCH))
                + A.attention_fwd_dropout_cuda.launches_tc
                + A.attention_bwd_dropout_cuda.launches_tc - packs)
    device_ms: dict[str, float] = {}
    counts: dict[str, int] = {}
    spans = []
    events = 0
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    primed = primer_records(e.name for e in device)
    for e in device:
        if PROFILE_PRIMER_KERNEL in e.name:
            continue
        spans.append((e.time_range.start, e.time_range.end, e.name))
        device_ms[e.name] = device_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        counts[e.name] = counts.get(e.name, 0) + 1
        events += ("attention_fwd_" in e.name or "attention_bwd_" in e.name
                   or "dw_kernel" in e.name or "ln_rows_kernel" in e.name)
    complete = events == expected and primed > 0
    busy = sum(device_ms.values())
    by_kind: dict[str, float] = {}
    for name, ms in device_ms.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    top = sorted(device_ms.items(), key=lambda kv: -kv[1])[:10]
    state = (("complete" if complete else "incomplete")
             + f" ({events} of {expected} hand-written kernel events; {primed} of the "
             f"primer's {PROFILE_PRIMER} records)")
    print(f"profile: {label} [{state}]: wall {wall_ms:.3f} ms under the profiler, device "
          f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %); device ms by kind: "
          + "; ".join(f"{k} {ms:.3f}" for k, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]))
          + "; device ms by op: "
          + "; ".join(f"{ms:.3f} {name[:60]}" for name, ms in top), flush=True)
    # the host-to-device copies by source memory ("Memcpy HtoD (Pageable -> Device)", "...
    # (Pinned -> Device)"): ms and count
    htod = {name[len("Memcpy HtoD "):].strip("()"): (ms, counts[name] // iters)
            for name, ms in device_ms.items() if name.startswith("Memcpy HtoD")}
    return {"wall_ms": wall_ms, "busy_ms": busy, "by_kind": by_kind, "top": top,
            "complete": complete, "htod": htod, "spans": spans}


def predictor_throughput(pred, n: int, text: int, rng, iters: int = 5) -> None:
    """Samples/s of ``predict`` (host clock; each call ends in a copy to the
    host), then one profiled pass."""
    img = rng.normal(size=(n, IMG_TOKENS, D)).astype(np.float32)
    txt = rng.normal(size=(n, text, D)).astype(np.float32)
    s = IMG_PADDED + -(-text // 32) * 32
    heads = pred.model.mm_encoder.resblocks[0].attn.n_head
    pred.predict(img, txt)
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.predict(img, txt)
    dt = time.perf_counter() - t0
    print(f"predictor ({heads} heads): batch {n} (S={s}): {iters * n / dt:.1f} samples/s",
          flush=True)
    profile_device(lambda: pred.predict(img, txt), iters,
                   f"predictor ({heads} heads) batch {n} (S={s}) per batch")
    return iters * n / dt


def time_backward(b, s, dtype, heads: int = HEADS) -> dict:
    """The backward kernel at the training path's shape (no key mask), its
    plain version, and the backward of ``scaled_dot_product_attention``."""
    dh = D // heads
    qkv = torch.randn(b, s, 3 * D, device=DEVICE).to(dtype)
    g = torch.randn(b, s, D, device=DEVICE).to(dtype)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    out, lse = A.attention_fwd_cuda(q, k, v, None, n_head=heads)

    def split(t):
        return t.reshape(b, s, heads, dh).transpose(1, 2).detach().requires_grad_()

    hq, hk, hv = split(q), split(k), split(v)
    lib_out = torch.nn.functional.scaled_dot_product_attention(hq, hk, hv)
    lib_g = g.reshape(b, s, heads, dh).transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (hq, hk, hv), lib_g, retain_graph=True)

    iters = 10 if b * s * s > 32 * 736 * 736 else 30
    isz = qkv.element_size()
    flops = 10 * b * s * s * D
    nbytes = 8 * b * s * D * isz + b * heads * s * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {
        "B": b, "S": s, "Dh": dh, "dtype": str(dtype)[6:],
        "ms": cuda_ms(lambda: A.attention_bwd_cuda(q, k, v, None, out, lse, g, n_head=heads),
                      iters),
        "plain_ms": cuda_ms(lambda: A.attention_bwd_plain(q, k, v, None, g, n_head=heads), iters),
        "library_ms": cuda_ms(library, iters),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    print("time attention_bwd " + json.dumps(row), flush=True)
    return row


def write_shards(root: str, rng) -> None:
    """Synthetic packed FLAVA shards for ``food101`` (101 classes) in the layout
    ``data/flava_encoded.py`` reads: 197 image tokens, text of 5-77 tokens
    plus a few of 512, 768-wide fp32 rows."""
    shard_dir = os.path.join(root, "food101", "flava_packed")
    os.makedirs(shard_dir)
    with open(os.path.join(root, "food101", "train.jsonl"), "w") as f:
        for c in range(N_CLASSES):
            f.write(json.dumps({"label": f"class_{c}"}) + "\n")
    for phase, n, n_long in SPLITS:
        txt_len = rng.integers(5, 78, size=n)
        txt_len[rng.choice(n, size=n_long, replace=False)] = LONG_TEXT
        img = rng.standard_normal((n * IMG_TOKENS, D), dtype=np.float32)
        txt = rng.standard_normal((int(txt_len.sum()), D), dtype=np.float32)
        np.save(os.path.join(shard_dir, f"{phase}_img.npy"), img)
        np.save(os.path.join(shard_dir, f"{phase}_txt.npy"), txt)
        np.save(os.path.join(shard_dir, f"{phase}_img_offsets.npy"),
                np.arange(n + 1) * IMG_TOKENS)
        np.save(os.path.join(shard_dir, f"{phase}_txt_offsets.npy"),
                np.concatenate([[0], np.cumsum(txt_len)]))
        np.save(os.path.join(shard_dir, f"{phase}_labels.npy"), rng.integers(0, N_CLASSES, n))


def train_setup(steps_per_epoch: int, fast_dw: bool = False, heads: int = HEADS,
                dtype=torch.float32, remat: bool = False):
    """``setup_flava`` with the arguments the training CLI gives it below
    (``dtype`` bf16: ``--bf16``; ``remat``: ``--remat``)."""
    from multimodal_uncertainty_tpu_torch.zoo import setup_flava

    return setup_flava(model_type="MIMO-shuffle-instance", n_classes=N_CLASSES, lr=TRAIN_LR,
                       wd=0.001, n_epochs=TRAIN_EPOCHS, steps_per_epoch=steps_per_epoch,
                       multimodal_num_attention_heads=heads,
                       multimodal_num_hidden_layers=LAYERS, seed=TRAIN_SEED, fast_dw=fast_dw,
                       dtype=dtype, remat=remat, device=DEVICE)


def train_end_to_end(tmp: str, heads: int = HEADS, run_name: str = "run") -> dict:
    """Phase 4 (and 4d at ``heads=K6_HEADS``) in ``tmp/<run_name>``, on the
    shards under ``tmp/data`` (written by the first call); returns the kernel
    launches of the main path's run at the head dim D / heads."""
    import types

    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
    from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    dh = D // heads
    if not os.path.exists(os.path.join(tmp, "data")):
        t0 = time.perf_counter()
        write_shards(os.path.join(tmp, "data"), np.random.default_rng(1))
        print(f"training: shards written in {time.perf_counter() - t0:.1f} s", flush=True)
    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    run = os.path.join(tmp, run_name)

    losses, seq_lens = [], []
    train_step = steps.train_step

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])  # a device scalar, read after the run
        seq_lens.append(x[0].shape[1] + x[1].shape[1])
        return logs

    argv = ["--framework", "flava", "--save_path", run, "--dataset", "food101",
            "--model_type", "MIMO-shuffle-instance", "--batch_size", str(TRAIN_BATCH),
            "--multimodal_num_attention_heads", str(heads),
            "--multimodal_num_hidden_layers", str(LAYERS), "--lr", str(TRAIN_LR),
            "--n_epochs", str(TRAIN_EPOCHS), "--seed", str(TRAIN_SEED), "--ece",
            "--device", DEVICE]
    steps.train_step = recording
    try:
        reset_counters()
        prof = profile_device(lambda: train.main(argv), 1,
                              f"train CLI ({heads} heads), {TRAIN_EPOCHS} epochs with eval and "
                              f"checkpoints")
        fwd = A.attention_fwd_cuda.launches_by_dh.get(dh, 0)
        bwd = A.attention_bwd_cuda.launches_by_dh.get(dh, 0)
        check((A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches) == (fwd, bwd),
              f"training launched instances other than Dh={dh}: "
              f"{A.attention_fwd_cuda.launches_by_dh} {A.attention_bwd_cuda.launches_by_dh}")
        check_fwd_routes(f"flava training ({heads} heads)")
    finally:
        steps.train_step = train_step
    losses = [float(v) for v in losses]

    hist = load_history(run)
    n_train = SPLITS[0][1] // TRAIN_BATCH * TRAIN_EPOCHS
    n_eval = sum(-(-n // TRAIN_BATCH) for _, n, _ in SPLITS[1:]) * TRAIN_EPOCHS
    print(f"training ({heads} heads, Dh={dh}): {TRAIN_EPOCHS} epochs, {len(losses)} train steps "
          f"at batch {TRAIN_BATCH} "
          f"(S per step {seq_lens}) in {prof['wall_ms'] / 1e3:.3f} s; losses {losses}; history "
          + json.dumps({k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc", "val_ece",
                                              "test_loss", "test_acc", "time")})
          + f"; kernel launches fwd {fwd} bwd {bwd}", flush=True)
    check(len(hist["epoch"]) == TRAIN_EPOCHS and all(np.isfinite(hist["loss"])),
          f"history.csv: {hist['epoch']} {hist['loss']}")
    for f in ("history.csv", "model_best_val.pt", "model_last_epoch.pt",
              *(f"model_epoch_{e}.pt" for e in range(1, TRAIN_EPOCHS + 1))):
        check(os.path.exists(os.path.join(run, f)), f"missing {f}")
    check(len(losses) == n_train, f"{len(losses)} train steps, expected {n_train}")
    check(min(seq_lens) <= IMG_PADDED + 96 and max(seq_lens) == IMG_PADDED + LONG_TEXT,
          f"train batches should have S <= 320 and S = 736, got {sorted(set(seq_lens))}")
    check(bwd == LAYERS * n_train, f"backward launches {bwd} != {LAYERS} x {n_train} train steps")
    check(fwd == LAYERS * (n_train + n_eval),
          f"forward launches {fwd} != {LAYERS} x ({n_train} train + {n_eval} eval batches)")

    # resume from the last epoch's checkpoint: the same val metrics
    args = types.SimpleNamespace(batch_size=TRAIN_BATCH, seed=TRAIN_SEED, sample_size=None,
                                 n_workers=0)
    train_loader, valid, _ = get_dataset_flava(args, os.path.join(tmp, "data", "food101"))
    steps_per_epoch = len(train_loader)
    fresh = train_setup(steps_per_epoch, heads=heads)
    resume_train_state(fresh.model, fresh.optimizer, os.path.join(run, "model_last_epoch.pt"))
    again = Trainer(fresh.bundle, fresh.optimizer, seed=TRAIN_SEED, verbose=False).eval_loop(
        valid, "val")
    d_loss = abs(again["val_loss"] - hist["val_loss"][-1])
    d_acc = abs(again["val_acc"] - hist["val_acc"][-1])
    print(f"training ({heads} heads): resume from model_last_epoch.pt: val_loss {again['val_loss']} "
          f"(|diff| {d_loss:.3g}), val_acc {again['val_acc']} (|diff| {d_acc:.3g})", flush=True)
    check(d_loss <= 1e-6 * abs(hist["val_loss"][-1]) and d_acc <= 1e-6,
          "resume does not reproduce the last val metrics")

    # epoch 1 again with the plain attention forward and backward
    ref = train_setup(steps_per_epoch, heads=heads)
    trainer = Trainer(ref.bundle, ref.optimizer, seed=TRAIN_SEED, verbose=False)
    T.attention_qkv_packed = plain_packed
    plain_losses = []
    try:
        for i, batch in enumerate(train_loader.iter_epoch(1), start=1):
            x, y = steps.to_device(batch, DEVICE)
            logs = steps.train_step(ref.bundle, ref.optimizer, x, y, trainer.generator(1, i))
            plain_losses.append(float(logs["loss"]))
    finally:
        T.attention_qkv_packed = A.attention_qkv_packed
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    after, _ = load_weights(os.path.join(run, "model_epoch_1.pt"))
    bound = 2 * sum(ref.schedule(t) for t in range(steps_per_epoch))
    diffs = {n: (p.detach().cpu() - after[n]).abs() for n, p in ref.model.state_dict().items()}
    worst = max(float(d.max()) for d in diffs.values())
    over = sum(int((d > 1e-5).sum()) for d in diffs.values())
    total = sum(d.numel() for d in diffs.values())
    print(f"training ({heads} heads): kernel vs plain attention over the {steps_per_epoch} steps "
          f"of epoch 1: "
          f"losses {losses[:steps_per_epoch]} vs {plain_losses}, max rel diff {rel:.3g}; parameters max "
          f"|diff| {worst:.3g} (bound {bound:.3g}), {over} of {total} elements over 1e-5",
          flush=True)
    check(rel <= 1e-4, f"kernel vs plain training losses differ by {rel} relative")
    check(worst <= bound, f"kernel vs plain parameters differ by {worst} > {bound}")
    return {"fwd": fwd, "bwd": bwd, "loss_rel": rel, "run": run, "wall_s": prof["wall_ms"] / 1e3}


def plain_heads_last_dropout(q, k, v, key_mask=None, *, n_head, rate, generator=None):
    """``attention_heads_last_dropout`` through the plain versions, drawing
    its keep mask from the same generator in the same order."""
    b, s, _ = q.shape
    keep = A.draw_keep_mask((b, n_head, s, s), rate, generator=generator, device=q.device)
    return A.attention_probs_dropout(q, k, v, key_mask, n_head=n_head, rate=rate, keep=keep)


def write_food101(root: str, rng) -> None:
    """A synthetic Food-101 tree in the layout ``data/food101.py`` reads: 101
    labels, a ``vocab.txt`` of BERT-base-uncased's size with its special
    tokens at their ids ([PAD] 0, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103), texts of single-wordpiece words whose lengths give each batch the
    longest text of ``MMBT_LONGEST``, and 256x256 P6 images (no resize on
    the way to the 224 crop, so no PIL is needed)."""
    from multimodal_uncertainty_tpu_torch.data.images import write_ppm
    from multimodal_uncertainty_tpu_torch.data.loaders import _epoch_perm

    d = os.path.join(root, "food101")
    os.makedirs(os.path.join(d, "images"))
    special = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.writelines(special.get(i, f"[unused{i}]" if i < 100 else f"w{i}") + "\n"
                     for i in range(MMBT_VOCAB))
    words = np.asarray([f"w{i}" for i in range(104, MMBT_VOCAB)])
    b = MMBT_TRAIN_BATCH
    for split, n in MMBT_ROWS:
        order = _epoch_perm(MMBT_SEED, 1, n, True) if split == "train" else np.arange(n)
        lengths = np.zeros(n, np.int64)
        for j, top in enumerate(MMBT_LONGEST[split]):
            rows = order[j * b:(j + 1) * b]
            lengths[rows] = rng.integers(4, top + 1, size=len(rows))
            lengths[rows[0]] = top
        with open(os.path.join(d, f"{split}.jsonl"), "w") as f:
            for i in range(n):
                img = f"images/{split}_{i}.ppm"
                write_ppm(os.path.join(d, img), rng.integers(0, 256, (256, 256, 3), np.uint8))
                f.write(json.dumps({"id": f"{split}_{i}", "label": f"class_{i % N_CLASSES}",
                                    "text": " ".join(rng.choice(words, size=int(lengths[i]))),
                                    "img": img}) + "\n")


def mmbt_argv(run: str, *extra) -> list:
    return (["--framework", "mmbt", "--dataset", "food101", "--save_path", run,
             "--batch_size", str(MMBT_TRAIN_BATCH), "--gradient_accumulation_steps",
             str(MMBT_ACCUM), "--freeze_img", "2", "--freeze_txt", "2", "--lr", str(MMBT_LR),
             "--seed", str(MMBT_SEED), "--device", DEVICE]
            + (["--tiny"] if MMBT_TINY else []) + list(extra))


def mmbt_setup(argv: list):
    """The train CLI's own loaders and ``setup_mmbt`` for ``argv`` (fresh
    weights from the seed)."""
    from multimodal_uncertainty_tpu_torch import train

    args = train.add_conditional_args(train.build_parser().parse_args(argv))
    return train._mmbt_setup(args, resolve_device(DEVICE))


def train_mmbt_end_to_end(tmp: str) -> dict:
    """Phase 4b; returns the kernel launches of both MMBT training runs."""
    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.models import bert as B_
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
    from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    write_food101(os.path.join(tmp, "data"), np.random.default_rng(4))
    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    print(f"mmbt training: Food-101 tree written in {time.perf_counter() - t0:.1f} s", flush=True)

    losses, seq_lens, flags_seen = [], [], []
    train_step = steps.train_step

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])  # a device scalar, read after the run
        seq_lens.append(MMBT_IMG_TOKENS + x[0].shape[1])
        flags_seen.append(tuple(kwargs.get("flags") or ()))
        return logs

    def run_cli(argv):
        reset_counters()
        for record in (losses, seq_lens, flags_seen):
            record.clear()
        steps.train_step = recording
        try:
            t0 = time.perf_counter()
            train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            steps.train_step = train_step
        check_fwd_routes("mmbt training")
        return wall, [c.launches for c in COUNTERS], [float(v) for v in losses]

    run = os.path.join(tmp, "run")
    argv = mmbt_argv(run, "--n_epochs", "2")
    wall, (fwd, bwd, fwd_d, bwd_d, *_), run_losses = run_cli(argv)
    lens, flags = list(seq_lens), list(flags_seen)
    hist = load_history(run)
    train_loader, valid, _, fresh = mmbt_setup(argv)
    n_layers = len(fresh.model.enc.encoder.layer)
    per_epoch = len(train_loader)
    n_eval = sum(-(-n // MMBT_TRAIN_BATCH) for _, n in MMBT_ROWS[1:]) * 2
    print(f"mmbt training: 2 epochs, {len(run_losses)} micro-steps at batch {MMBT_TRAIN_BATCH} "
          f"(accumulation {MMBT_ACCUM}; S per step {lens}; freeze flags {flags}) in {wall:.3f} s; "
          f"losses {run_losses}; history " + json.dumps(
              {k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc", "test_loss", "test_acc",
                                    "time")})
          + f"; launches fwd {fwd} bwd {bwd} fwd_dropout {fwd_d} bwd_dropout {bwd_d}", flush=True)
    check(len(hist["epoch"]) == 2 and all(np.isfinite(hist["loss"]))
          and all(np.isfinite(hist["val_loss"])), f"history.csv: {hist}")
    for f in ("history.csv", "model_best_val.pt", "model_last_epoch.pt", "model_epoch_1.pt",
              "model_epoch_2.pt"):
        check(os.path.exists(os.path.join(run, f)), f"missing {f}")
    check(len(run_losses) == 2 * per_epoch, f"{len(run_losses)} micro-steps, expected {2 * per_epoch}")
    check(min(lens) == MMBT_IMG_TOKENS + 32 and max(lens) == MMBT_IMG_TOKENS + 512,
          f"MMBT train batches should run from S=37 to S=517, got {sorted(set(lens))}")
    check(flags[:per_epoch] == [(True, True)] * per_epoch
          and flags[per_epoch:] == [(False, False)] * per_epoch, f"freeze flags {flags}")
    check(bwd == n_layers * len(run_losses),
          f"K2 backward launches {bwd} != {n_layers} x {len(run_losses)} micro-steps")
    check(fwd == n_layers * (len(run_losses) + n_eval),
          f"K2 forward launches {fwd} != {n_layers} x ({len(run_losses)} + {n_eval} eval batches)")
    check(fwd_d == bwd_d == 0, "dropout kernels launched with --attention_probs_dropout 0")

    # resume from the last epoch's checkpoint: the same val metrics
    init = {n: t.detach().cpu().clone() for n, t in fresh.model.state_dict().items()}
    resume_train_state(fresh.model, fresh.optimizer, os.path.join(run, "model_last_epoch.pt"),
                       accumulator=fresh.accumulator, plateau=fresh.plateau)
    again = Trainer(fresh.bundle, fresh.optimizer, seed=MMBT_SEED, verbose=False).eval_loop(
        valid, "val")
    d_loss = abs(again["val_loss"] - hist["val_loss"][-1])
    d_acc = abs(again["val_acc"] - hist["val_acc"][-1])
    print(f"mmbt training: resume from model_last_epoch.pt: val_loss {again['val_loss']} "
          f"(|diff| {d_loss:.3g}), val_acc {again['val_acc']} (|diff| {d_acc:.3g})", flush=True)
    check(d_loss <= 1e-6 * abs(hist["val_loss"][-1]) and d_acc <= 1e-6,
          "MMBT resume does not reproduce the last val metrics")
    del fresh

    # the freeze schedule: ResNet weights bit-unchanged through epoch 1, its
    # BatchNorm statistics moving; both changed by epoch 2
    first, _ = load_weights(os.path.join(run, "model_epoch_1.pt"))
    second, _ = load_weights(os.path.join(run, "model_epoch_2.pt"))
    resnet = [n for n in init if n.startswith("enc.img_encoder.")]
    weights = [n for n in resnet if not n.endswith(("running_mean", "running_var",
                                                      "num_batches_tracked"))]
    stats = [n for n in resnet if n.endswith(("running_mean", "running_var"))]
    check(all(torch.equal(first[n], init[n]) for n in weights),
          "the frozen ResNet's weights changed in epoch 1")
    check(any(not torch.equal(first[n], init[n]) for n in stats),
          "the ResNet's BatchNorm statistics did not move in epoch 1")
    moved = sum(not torch.equal(second[n], first[n]) for n in weights)
    check(moved > 0, "the ResNet's weights did not change in epoch 2")
    print(f"mmbt training: freeze schedule: ResNet weights unchanged in epoch 1 "
          f"({len(weights)} tensors), {moved} of them changed in epoch 2", flush=True)

    # epoch 1 again with the plain attention forward and backward on the card
    _, _, _, ref = mmbt_setup(argv)
    trainer = Trainer(ref.bundle, ref.optimizer, seed=MMBT_SEED, verbose=False)
    B_.attention_heads_last = plain_heads_last
    plain_losses = []
    try:
        for i, batch in enumerate(train_loader.iter_epoch(1), start=1):
            x, y = steps.to_device(batch, DEVICE)
            logs = steps.train_step(ref.bundle, ref.optimizer, x, y, trainer.generator(1, i),
                                    flags=(True, True), accumulator=ref.accumulator)
            plain_losses.append(float(logs["loss"]))
    finally:
        B_.attention_heads_last = A.attention_heads_last
    rel = max(abs(a - b) / abs(b) for a, b in zip(run_losses, plain_losses))
    bound = 2 * sum(ref.optimizer.schedule(t) for t in range(per_epoch // MMBT_ACCUM))
    diffs = {n: (p.detach().cpu() - first[n]).abs() for n, p in ref.model.state_dict().items()}
    worst = max(float(d.float().max()) for d in diffs.values())
    print(f"mmbt training: kernels vs plain attention over the {per_epoch} micro-steps of epoch 1 "
          f"(hidden dropout {0.1} from the steps' seeds, attention-probs dropout 0): losses "
          f"{run_losses[:per_epoch]} vs {plain_losses}, max rel diff {rel:.3g}; parameters max "
          f"|diff| {worst:.3g} (bound {bound:.3g})", flush=True)
    check(rel <= 1e-4, f"MMBT kernel vs plain losses differ by {rel} relative")
    check(worst <= bound, f"MMBT kernel vs plain parameters differ by {worst} > {bound}")
    del ref, first, second, init

    # one epoch with dropout on the attention probabilities: K5
    run_d = os.path.join(tmp, "run_dropout")
    argv_d = mmbt_argv(run_d, "--n_epochs", "1", "--attention_probs_dropout", str(MMBT_DROPOUT))
    wall_d, (fwd2, bwd2, fwd_d, bwd_d, *_), drop_losses = run_cli(argv_d)
    n_micro = len(drop_losses)
    hist_d = load_history(run_d)
    print(f"mmbt training with attention-probs dropout {MMBT_DROPOUT}: {n_micro} micro-steps in "
          f"{wall_d:.3f} s; losses {drop_losses}; val_loss {hist_d['val_loss']}; launches fwd "
          f"{fwd2} bwd {bwd2} fwd_dropout {fwd_d} bwd_dropout {bwd_d}", flush=True)
    check(len(hist_d["epoch"]) == 1 and all(np.isfinite(hist_d["loss"])), f"history {hist_d}")
    check(fwd_d == bwd_d == n_layers * n_micro,
          f"K5 launches fwd {fwd_d} bwd {bwd_d} != {n_layers} x {n_micro} micro-steps")
    check(bwd2 == 0, f"K2 backward launched {bwd2} times under dropout")
    check(fwd2 == n_layers * n_eval // 2, f"K2 forward launches {fwd2} != eval batches' {n_eval // 2}")
    _, _, _, ref = mmbt_setup(argv_d)
    trainer = Trainer(ref.bundle, ref.optimizer, seed=MMBT_SEED, verbose=False)
    B_.attention_heads_last_dropout = plain_heads_last_dropout
    plain_losses = []
    try:
        for i, batch in zip(range(1, MMBT_ACCUM + 1), train_loader.iter_epoch(1)):
            x, y = steps.to_device(batch, DEVICE)
            logs = steps.train_step(ref.bundle, ref.optimizer, x, y, trainer.generator(1, i),
                                    flags=(True, True), accumulator=ref.accumulator)
            plain_losses.append(float(logs["loss"]))
    finally:
        B_.attention_heads_last_dropout = A.attention_heads_last_dropout
    rel_d = max(abs(a - b) / abs(b) for a, b in zip(drop_losses, plain_losses))
    print(f"mmbt training with dropout: kernels vs plain dropout attention, first {MMBT_ACCUM} "
          f"micro-steps from the same seeds (the same masks): losses {drop_losses[:MMBT_ACCUM]} "
          f"vs {plain_losses}, max rel diff {rel_d:.3g}", flush=True)
    check(rel_d <= 1e-4, f"MMBT dropout kernel vs plain losses differ by {rel_d} relative")
    return {"fwd": fwd, "bwd": bwd, "fwd_eval_dropout_run": fwd2, "fwd_dropout": fwd_d,
            "bwd_dropout": bwd_d, "loss_rel": rel, "loss_rel_dropout": rel_d}


def draw_like(g: torch.Generator, name: str, shape) -> torch.Tensor:
    """A pretrained-looking fp32 tensor for the parameter or buffer ``name``:
    convolutions He-normal (fan-out), the scales of BatchNorm and LayerNorm
    (the models' only 1-D weights) near 1, running variances in [0.8, 1.2],
    other weights, biases and means N(0, 0.02)."""
    shape = tuple(shape)
    z = torch.randn(shape, generator=g)
    if len(shape) == 4:
        return z * (2.0 / (shape[0] * shape[2] * shape[3])) ** 0.5
    if name.endswith("running_var"):
        return 0.8 + 0.4 * torch.rand(shape, generator=g)
    if len(shape) == 1 and name.endswith(("weight", "gamma")):
        return 1.0 + 0.02 * z
    return 0.02 * z


def write_mmbt_weights(root: str, model) -> tuple:
    """Phase 4h: full-width BERT and ResNet state dicts of ``model``'s shapes
    (BERT-base and ResNet-152 on the card), drawn from ``PRETRAINED_SEED``,
    written as a BERT file in the legacy ``pytorch_pretrained_bert`` names
    (``bert.`` prefix, LayerNorm ``gamma`` / ``beta``, its pre-training
    heads) and a torchvision ResNet file (with ``fc`` and
    ``num_batches_tracked``). Returns both paths and {MMBT name: tensor} of
    what the import must write."""
    g = torch.Generator().manual_seed(PRETRAINED_SEED)
    bert, resnet, want = {}, {}, {}
    for name, t in model.state_dict().items():
        if name.startswith("enc.img_encoder.model."):
            src = name[len("enc.img_encoder.model."):]
            if src.endswith("num_batches_tracked"):
                resnet[src] = torch.tensor(1000)  # dropped by the import
                continue
            resnet[src] = want[name] = draw_like(g, src, t.shape)
        elif name.startswith(("enc.txt_embeddings.", "enc.encoder.", "enc.pooler.")):
            src = "bert." + name[len("enc."):].replace("txt_embeddings.", "embeddings.", 1)
            if src.endswith("LayerNorm.weight"):
                src = src[:-len("weight")] + "gamma"
            elif src.endswith("LayerNorm.bias"):
                src = src[:-len("bias")] + "beta"
            bert[src] = want[name] = draw_like(g, src, t.shape)
    d = model.config.hidden_size
    resnet["fc.weight"], resnet["fc.bias"] = draw_like(g, "fc", (1000, 2048)), torch.zeros(1000)
    bert["bert.embeddings.position_ids"] = torch.arange(model.config.max_position_embeddings)[None]
    bert["cls.predictions.bias"] = torch.zeros(model.config.vocab_size)
    bert["cls.seq_relationship.weight"] = draw_like(g, "cls", (2, d))
    paths = (os.path.join(root, "bert-base-uncased.bin"), os.path.join(root, "resnet152.pth"))
    torch.save(bert, paths[0])
    torch.save(resnet, paths[1])
    return paths, want


def write_vilt_weights(root: str, cfg) -> tuple:
    """Phase 4h: a ViLT state dict of ``cfg``'s shapes (ViLT-B/32 on the
    card) in HF ``ViltForImagesAndTextClassification`` names, drawn from
    ``PRETRAINED_SEED + 1``. Returns its path and {ViLT name: tensor} of what
    the import must write (each block's ``qkv`` the rows of query, key and
    value)."""
    g = torch.Generator().manual_seed(PRETRAINED_SEED + 1)
    d, grid = cfg.hidden_size, cfg.image_size // cfg.patch_size
    e = "vilt.embeddings."
    names = {  # HF name: (the port's, shape)
        e + "text_embeddings.word_embeddings.weight": ("vilt.word_embeddings",
                                                       (cfg.vocab_size, d)),
        e + "text_embeddings.position_embeddings.weight": (
            "vilt.position_embeddings", (cfg.max_position_embeddings, d)),
        e + "text_embeddings.token_type_embeddings.weight": ("vilt.token_type_embeddings",
                                                             (cfg.type_vocab_size, d)),
        e + "text_embeddings.LayerNorm.weight": ("vilt.emb_LayerNorm.weight", (d,)),
        e + "text_embeddings.LayerNorm.bias": ("vilt.emb_LayerNorm.bias", (d,)),
        e + "token_type_embeddings.weight": ("vilt.modality_type_embeddings", (2, d)),
        e + "cls_token": ("vilt.image_cls", (1, 1, d)),
        e + "patch_embeddings.projection.weight": ("vilt.patch_embed.weight",
                                                   (d, 3, cfg.patch_size, cfg.patch_size)),
        e + "patch_embeddings.projection.bias": ("vilt.patch_embed.bias", (d,)),
        "vilt.layernorm.weight": ("vilt.ln_post.weight", (d,)),
        "vilt.layernorm.bias": ("vilt.ln_post.bias", (d,)),
        "vilt.pooler.dense.weight": ("vilt.pooler.weight", (d, d)),
        "vilt.pooler.dense.bias": ("vilt.pooler.bias", (d,)),
        "classifier.0.weight": ("cls_fc.weight", (d, d)),
        "classifier.0.bias": ("cls_fc.bias", (d,)),
        "classifier.1.weight": ("cls_ln.weight", (d,)),
        "classifier.1.bias": ("cls_ln.bias", (d,)),
        "classifier.3.weight": ("cls_out.weight", (cfg.num_labels, d)),
        "classifier.3.bias": ("cls_out.bias", (cfg.num_labels,)),
    }
    for i in range(cfg.num_hidden_layers):
        hf, port = f"vilt.encoder.layer.{i}.", f"vilt.block.{i}."
        for a, b, shape in (("attention.output.dense", "proj", (d, d)),
                            ("layernorm_before", "ln_1", (d,)), ("layernorm_after", "ln_2", (d,)),
                            ("intermediate.dense", "fc1", (cfg.intermediate_size, d)),
                            ("output.dense", "fc2", (d, cfg.intermediate_size))):
            names[hf + a + ".weight"] = (port + b + ".weight", shape)
            names[hf + a + ".bias"] = (port + b + ".bias", shape[:1])
    sd = {hf: draw_like(g, port, shape) for hf, (port, shape) in names.items()}
    want = {names[hf][0]: t for hf, t in sd.items()}
    pos = draw_like(g, "pos", (1, grid * grid + 1, d))
    sd[e + "position_embeddings"], want["vilt.image_position_embeddings"] = pos, pos[0]
    for i in range(cfg.num_hidden_layers):
        for leaf, shape in (("weight", (d, d)), ("bias", (d,))):
            parts = [draw_like(g, leaf, shape) for _ in range(3)]
            for which, t in zip(("query", "key", "value"), parts):
                sd[f"vilt.encoder.layer.{i}.attention.attention.{which}.{leaf}"] = t
            want[f"vilt.block.{i}.qkv.{leaf}"] = torch.cat(parts)
    path = os.path.join(root, "vilt-b32.bin")
    torch.save(sd, path)
    return path, want


def check_imported(own: dict, want: dict, label: str) -> int:
    """Every tensor the import was to write equals the file's bit for bit in
    ``own`` (a snapshot of the model's state on the card); returns how many
    were held."""
    bad = [k for k, t in want.items() if not torch.equal(own[k].cpu(), t)]
    check(not bad and len(want) > 0, f"{label}: {len(bad)} imported tensors differ from the "
                                     f"file's, e.g. {bad[:3]}")
    return len(want)


@contextlib.contextmanager
def no_checkpoint_files():
    """Within: the train CLI writes no checkpoint file (history.csv still).
    Phase 4h's three runs would write some 22 GB of checkpoints, and the chip
    machine's disk takes about 45 GiB of writes in one call; phases 4b and 4c
    hold the checkpoints of the same CLI paths."""
    from multimodal_uncertainty_tpu_torch.training import callbacks, loop

    real = loop.save_weights, callbacks.save_weights
    loop.save_weights = callbacks.save_weights = lambda *args, **kwargs: None
    try:
        yield
    finally:
        loop.save_weights, callbacks.save_weights = real


@contextlib.contextmanager
def marked_epoch_loop(before=None):
    """Within: the trainer's ``train_loop`` (every epoch with its eval) runs
    between two ``spin_kernel`` launches (``torch.cuda._sleep(0)``) that mark
    it on the device's timeline for ``device_window``, after
    ``before(trainer)`` (outside the marks) and a synchronise; its host wall
    in ms, synchronised at both ends, is appended to the yielded list."""
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    real, walls = Trainer.train_loop, []

    def marked(self, *args, **kwargs):
        if before is not None:
            before(self)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(0)
        try:
            return real(self, *args, **kwargs)
        finally:
            torch.cuda._sleep(0)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)

    Trainer.train_loop = marked
    try:
        yield walls
    finally:
        Trainer.train_loop = real


def device_window(prof: dict, marked: bool) -> dict:
    """Of a ``profile_device`` result: the device's busy ms (the union of its
    activities, so a copy on the side stream under a kernel counts once), the
    window's ms and ``Memcpy HtoD`` (ms, copies) by source memory, between
    ``marked_epoch_loop``'s two marks or (``marked`` false) over the whole
    profile, against its host wall. None where the profile lost a mark's
    event (CUPTI drops events at times: ``profile_device`` says
    ``incomplete``)."""
    spans = sorted(prof["spans"])
    marks = [sp for sp in spans if "spin_kernel" in sp[2]]
    if marked:
        if len(marks) != 2:
            return None
        lo, hi = marks[0][0], marks[1][1]
    else:
        lo, hi = spans[0][0], max(end for _, end, _ in spans)
    busy, end, htod = 0.0, lo, {}
    for a, b, name in spans:
        if "spin_kernel" in name or b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        if b > end:
            busy, end = busy + b - max(a, end), b
        if name.startswith("Memcpy HtoD"):
            src = name[len("Memcpy HtoD "):].strip("()")
            ms, n = htod.get(src, (0.0, 0))
            htod[src] = (ms + (b - a) / 1e3, n + 1)
    window = (hi - lo) / 1e3 if marked else prof["wall_ms"]
    return {"busy_ms": busy / 1e3, "window_ms": window, "share": busy / 1e3 / window,
            "htod": htod}


@contextlib.contextmanager
def batch_mover(plain: bool):
    """Within: the trainer's ``move_batches`` takes, whatever the batches'
    size, ``steps.to_device`` a batch at a time from pageable memory on the
    consumer's stream (``plain``) or ``loaders.prefetch_to_device``."""
    from multimodal_uncertainty_tpu_torch.training import trainer

    real = trainer.PREFETCH_MIN_BYTES
    trainer.PREFETCH_MIN_BYTES = float("inf") if plain else 0
    try:
        yield
    finally:
        trainer.PREFETCH_MIN_BYTES = real


def own_mover(loader) -> str:
    """The mover the trainer picks for ``loader``'s batches, with their size."""
    from multimodal_uncertainty_tpu_torch.data.loaders import flat_batch
    from multimodal_uncertainty_tpu_torch.training import trainer

    nbytes = sum(np.asarray(a).nbytes for a in flat_batch(loader.collate_fn(
        [loader.dataset[i] for i in range(min(loader.batch_size, len(loader.dataset)))])))
    route = "prefetch" if nbytes >= trainer.PREFETCH_MIN_BYTES else "plain"
    return f"{route} ({nbytes / 2 ** 20:.1f} MiB a batch, threshold " \
           f"{trainer.PREFETCH_MIN_BYTES / 2 ** 20:.0f} MiB)"


# the batch movers' comparisons (phases 4h, 4i): (name, the plain mover, extra CLI flags), in the
# order plain, prefetch, prefetch, plain; the first prefetch run passes the reference's flag, which
# changes nothing
MOVER_RUNS = (("plain", True, []), ("prefetch --device_prefetch", False, ["--device_prefetch"]),
              ("prefetch", False, []), ("plain again", True, []))


def print_movers(label: str, runs: dict) -> None:
    for name, r in runs.items():
        loop, whole = r["loop"], r["whole"]
        print(f"{label} ({name}): epoch loop " + (
            "busy not measured (the profile lost a mark)" if loop is None else
            f"busy {100 * loop['share']:.1f} % ({loop['busy_ms']:.3f} of {loop['window_ms']:.3f} "
            f"device ms)") + f", host wall {r['loop_wall_ms']:.3f} ms, Memcpy HtoD " + (
            "not measured" if loop is None else ", ".join(
                f"{src} {ms:.3f} ms in {n} copies" for src, (ms, n) in sorted(loop["htod"].items()))
            or "none")
              + f"; whole run busy {100 * whole['share']:.1f} % ({whole['busy_ms']:.3f} of "
              f"{whole['window_ms']:.3f} ms wall), Memcpy HtoD " + (", ".join(
                  f"{src} {ms:.3f} ms in {n} copies" for src, (ms, n)
                  in sorted(whole["htod"].items())) or "none")
              + f"; profile {'complete' if r['prof']['complete'] else 'incomplete'}", flush=True)


def batch_arrays(loader) -> int:
    """How many arrays a batch of ``loader`` (a ``MapLoader``) holds."""
    x, _ = loader.collate_fn([loader.dataset[0]])
    return len(x) + 1


def check_movers_agree(label: str, runs: dict, per_batch: int, batches: int) -> None:
    """Every run's losses and history (wall-clock columns aside) within 1e-6
    relative of the first's; in the epoch loop the prefetch runs copied
    ``per_batch`` arrays of ``batches`` batches from pinned memory, the plain
    runs as many or more from pageable memory and none from pinned."""
    first = next(iter(runs.values()))
    for name, r in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], first["losses"]))
        same = len(r["losses"]) == len(first["losses"]) and all(
            abs(a - b) <= 1e-6 * abs(b) for k in first["hist"] if k not in ("time", "epoch_begin_time")
            for a, b in zip(r["hist"][k], first["hist"][k]))
        check(rel <= 1e-6 and same, f"{label} ({name}): the run differs from the first "
                                    f"(losses {rel:.3g}, history equal {same})")
        if r["loop"] is None:
            continue
        htod = r["loop"]["htod"]
        pinned, pageable = (htod.get(f"{m} -> Device", (0.0, 0))[1] for m in ("Pinned", "Pageable"))
        check(pinned == 0 and pageable >= per_batch * batches if r["plain"]
              else pinned == per_batch * batches,
              f"{label} ({name}): epoch-loop copies {htod}, expected {per_batch} x {batches} "
              f"from {'pageable' if r['plain'] else 'pinned'} memory")


def train_pretrained_end_to_end(tmp: str) -> dict:
    """Phase 4h: MMBT from pretrained BERT / ResNet files through the train
    CLI on phase 4b's tree, 1 epoch in each of ``MOVER_RUNS`` (the
    prefetcher, with and without ``--device_prefetch``, against the plain
    batch mover), profiled; and ViLT from a pretrained file with
    ``--fast_dw``. Returns the kernel launches of these runs and the busy
    shares (epoch loop, whole run) of the MMBT runs."""
    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.loop import load_history

    t0 = time.perf_counter()
    weights = os.path.join(tmp, "pretrained")
    os.makedirs(weights)
    train_loader, _, _, fresh = mmbt_setup(mmbt_argv(os.path.join(tmp, "unused")))
    (bert_path, resnet_path), want = write_mmbt_weights(weights, fresh.model)
    n_layers, per_epoch = len(fresh.model.enc.encoder.layer), len(train_loader)
    del fresh
    print(f"pretrained weights: BERT and ResNet files of {len(want)} tensors "
          f"({sum(t.numel() for t in want.values()) * 4 / 1e9:.3f} GB fp32) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    losses, snaps, held = [], [], []
    train_step = steps.train_step

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])
        return logs

    def snapshot(trainer):  # before step 1, outside the marked loop: the imported tensors
        own = trainer.bundle.model.state_dict()
        snaps.append({k: own[k].detach().clone() for k in want})

    runs = {}
    n_eval = sum(-(-n // MMBT_TRAIN_BATCH) for _, n in MMBT_ROWS[1:])
    for i, (name, plain, extra) in enumerate(MOVER_RUNS):
        argv = mmbt_argv(os.path.join(tmp, f"pretrained_{i}"), "--n_epochs", "1",
                         "--bert_weights", bert_path, "--resnet_weights", resnet_path, *extra)
        losses.clear()
        steps.train_step = recording
        try:
            reset_counters()
            with no_checkpoint_files(), batch_mover(plain), marked_epoch_loop(snapshot) as walls:
                prof = profile_device(lambda: train.main(argv), 1,
                                      f"mmbt train CLI, 1 epoch, pretrained weights, {name}",
                                      cpu_ops=False)
            check_fwd_routes(f"mmbt training from pretrained weights ({name})")
            launches = [c.launches for c in COUNTERS]
        finally:
            steps.train_step = train_step
        held.append(check_imported(snaps.pop(), want, f"4h ({name}) before step 1"))
        hist = load_history(argv[argv.index("--save_path") + 1])
        runs[name] = {"losses": [float(v) for v in losses], "hist": hist, "prof": prof,
                      "plain": plain, "loop": device_window(prof, True),
                      "whole": device_window(prof, False), "loop_wall_ms": walls[0],
                      "fwd": launches[0], "bwd": launches[1]}
        check(len(hist["epoch"]) == 1 and all(np.isfinite(hist["loss"]))
              and all(np.isfinite(hist["val_loss"])), f"4h history ({name}): {hist}")
        check(len(runs[name]["losses"]) == per_epoch, f"4h ({name}): {len(losses)} micro-steps")
        check(launches[1] == n_layers * per_epoch and launches[0] == n_layers * (per_epoch + n_eval)
              and launches[2] == launches[3] == 0,
              f"4h ({name}): launches {launches[:4]}, expected fwd {n_layers * (per_epoch + n_eval)}"
              f" bwd {n_layers * per_epoch}")
    print(f"4h: the mmbt runs done at {time.perf_counter() - t0:.1f} s", flush=True)
    first = runs[MOVER_RUNS[0][0]]
    print(f"4h: mmbt from pretrained BERT-base + ResNet-152 ({held[0]} tensors bit-exact on the "
          f"card before step 1, in each of {len(held)} runs), {per_epoch} micro-steps: losses "
          + "; ".join(f"{name} {r['losses']}" for name, r in runs.items())
          + f"; val_acc {first['hist']['val_acc']}", flush=True)
    check_movers_agree("4h mmbt", runs, batch_arrays(train_loader), per_epoch + n_eval)
    print_movers("4h mmbt train CLI, 1 epoch from pretrained files", runs)
    own = own_mover(train_loader)
    print(f"4h: the trainer's own mover for mmbt: {own}", flush=True)
    check(own.startswith("plain"), f"4h: the trainer prefetches mmbt's batches: {own}")

    # ViLT-B/32 from a pretrained file, --fast_dw, 1 epoch on its own tree
    data = os.environ["DATA_DIR"]
    write_vilt_food101(os.path.join(tmp, "vilt_data"), np.random.default_rng(8))
    os.environ["DATA_DIR"] = os.path.join(tmp, "vilt_data")
    try:
        run = os.path.join(tmp, "pretrained_vilt")
        vilt_loader, _, _, vfresh = vilt_setup(vilt_argv(run))
        vilt_path, want = write_vilt_weights(weights, vfresh.model.config)
        v_layers, v_steps = len(vfresh.model.vilt.block), len(vilt_loader)
        vfresh.model.train()
        per_step = dw_eligible(vfresh.model)
        del vfresh
        print(f"4h: vilt tree and weights written at {time.perf_counter() - t0:.1f} s", flush=True)
        argv = vilt_argv(run, "--n_epochs", "1", "--fast_dw", "--vilt_weights", vilt_path)
        losses.clear()
        steps.train_step = recording
        try:
            with dw_shapes_seen() as shapes, no_checkpoint_files(), marked_epoch_loop(snapshot):
                reset_counters()
                train.main(argv)
                torch.cuda.synchronize()
                vfwd, vbwd, vdw = (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
                                   DW.dw_cuda.launches)
                routes = dw_routes(shapes, "4h vilt training from pretrained weights")
                check_fwd_routes("4h vilt training from pretrained weights")
        finally:
            steps.train_step = train_step
    finally:
        os.environ["DATA_DIR"] = data
    held.append(check_imported(snaps.pop(), want, "4h vilt before step 1"))
    hist = load_history(run)
    v_eval = sum(-(-n // VILT_TRAIN_BATCH) for _, n in VILT_ROWS[1:])
    print(f"4h: vilt run done at {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"4h: vilt from a pretrained ViLT file ({held[-1]} tensors bit-exact before step 1, "
          f"each qkv the rows of query, key and value), --fast_dw, {len(losses)} micro-steps: "
          f"losses {[float(v) for v in losses]}; launches fwd {vfwd} bwd {vbwd} dw {vdw}",
          flush=True)
    check(len(hist["epoch"]) == 1 and all(np.isfinite(hist["loss"]))
          and all(np.isfinite(hist["val_loss"])), f"4h vilt history: {hist}")
    check(len(losses) == v_steps and vdw == per_step * v_steps and vbwd == v_layers * v_steps
          and vfwd == v_layers * (v_steps + v_eval),
          f"4h vilt launches fwd {vfwd} bwd {vbwd} dw {vdw} over {len(losses)} micro-steps")
    return {"fwd": sum(r["fwd"] for r in runs.values()),
            "bwd": sum(r["bwd"] for r in runs.values()),
            "vilt_fwd": vfwd, "vilt_bwd": vbwd, "vilt_dw_routes": routes,
            "busy": {k: (r["loop"] and r["loop"]["share"], r["whole"]["share"])
                     for k, r in runs.items()},
            "dw_errs": compare_dw_at(shapes, "4h vilt training")}


def mmbt_sweep_end_to_end(tmp: str) -> dict:
    """Phase 6b: ``python -m multimodal_uncertainty_tpu_torch.
    eval_mmbt_robustness`` (its ``main``) on phase 4b's best checkpoint over
    its dev split (``MMBT_SWEEP_REPEATS`` controls per modality): the
    predictions file (S, V, C) float32 and the labels file (S,); K2's forward
    launched exactly layers x chunks of 8 variants x batches times, all at
    Dh 64 (the tiny BERT's 32 when rehearsed) on the split-fp32 route and
    nothing else; the image encoder run once a batch (a forward hook); the
    same sweep in-process with the plain attention on the card within
    ``SWEEP_TOL`` x max(1, max|plain|). Prints its variant-samples/s in the
    CLI (first call) and warm (in-process, with the kernels, after the
    CLI)."""
    from multimodal_uncertainty_tpu_torch import eval_mmbt_robustness as cli
    from multimodal_uncertainty_tpu_torch.evals import robustness_mmbt as R
    from multimodal_uncertainty_tpu_torch.models import bert as B_
    from multimodal_uncertainty_tpu_torch.models.resnet_tv import ImageEncoder
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into

    ckpt = os.path.join(tmp, "run", "model_best_val.pt")
    out_dir = os.path.join(tmp, "mmbt_sweep")
    argv = mmbt_argv(os.path.join(tmp, "run"))
    _, dev, _, fresh = mmbt_setup(argv)
    n_layers = len(fresh.model.enc.encoder.layer)
    dh = fresh.model.config.hidden_size // fresh.model.config.num_attention_heads
    v, n_dev = 3 + 2 * MMBT_SWEEP_REPEATS, MMBT_ROWS[1][1]
    seconds, real, encoded = {}, R.mmbt_robustness_sweep, []

    def timing(*args, **kwargs):
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        seconds["sweep"] = time.perf_counter() - t0
        return result

    def count(module, inputs, output):
        if isinstance(module, ImageEncoder):
            encoded.append(inputs[0].shape[0])

    R.mmbt_robustness_sweep = timing
    hook = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        reset_counters()
        t0 = time.perf_counter()
        cli.main(["--save_path", out_dir, "--phase", "dev", "--batch_size",
                  str(MMBT_TRAIN_BATCH), "--checkpoint_path", ckpt, "--n_repeats",
                  str(MMBT_SWEEP_REPEATS), "--dataset", "food101", "--datapath",
                  os.path.join(os.environ["DATA_DIR"], "food101"), "--seed", str(MMBT_SEED),
                  "--device", DEVICE] + (["--tiny"] if MMBT_TINY else []))
        wall = time.perf_counter() - t0
        fwd = A.attention_fwd_cuda.launches
        by_dh = dict(A.attention_fwd_cuda.launches_by_dh)
        others = [c.launches for c in COUNTERS[1:]]
        check_fwd_routes("mmbt sweep")
    finally:
        hook.remove()
        R.mmbt_robustness_sweep = real
    preds = np.load(os.path.join(out_dir, "robustness_model_best_val_predictions_dev.npy"))
    labels = np.load(os.path.join(out_dir, "robustness_model_best_val_labels_dev.npy"))
    check(preds.shape == (n_dev, v, fresh.model.clf.weight.shape[0]) and preds.dtype == np.float32
          and labels.shape == (n_dev,), f"6b files: {preds.shape} {preds.dtype} {labels.shape}")
    check(bool(np.isfinite(preds).all()), "6b predictions not finite")
    batches, chunks = -(-n_dev // MMBT_TRAIN_BATCH), -(-v // 8)
    check(fwd == n_layers * chunks * batches and by_dh == {dh: fwd} and not any(others),
          f"6b: K2 forward launches {fwd} ({by_dh}; others {others}) != {n_layers} layers x "
          f"{chunks} chunks x {batches} batches at Dh {dh}")
    check(encoded == [MMBT_TRAIN_BATCH] * batches,
          f"6b: the image encoder ran {len(encoded)} times ({encoded}), not once a batch")

    restore_into(fresh.model, load_weights(ckpt)[0])
    B_.attention_heads_last = plain_heads_last
    try:
        ref, ref_labels = real(fresh.model, dev, n_repeats=MMBT_SWEEP_REPEATS, seed=MMBT_SEED)
    finally:
        B_.attention_heads_last = A.attention_heads_last
    # the same sweep with the kernels again, warm (the CLI's run includes first-call set-up)
    t0 = time.perf_counter()
    real(fresh.model, dev, n_repeats=MMBT_SWEEP_REPEATS, seed=MMBT_SEED)
    warm = n_dev * v / (time.perf_counter() - t0)
    worst = float(np.abs(preds - ref).max())
    tol = SWEEP_TOL * max(1.0, float(np.abs(ref).max()))
    rate = n_dev * v / seconds["sweep"]
    print(f"6b: mmbt sweep: {n_dev} dev samples x {v} variants in {seconds['sweep']:.3f} s "
          f"({rate:.1f} variant-samples/s, warm {warm:.1f} in-process after it; CLI wall "
          f"{wall:.3f} s); K2 forward launches {fwd} = "
          f"{n_layers} x {chunks} x {batches} at Dh {dh}; image encoder {len(encoded)} runs; vs "
          f"plain attention on the card max abs diff {worst:.3g} (tol {tol:.3g})", flush=True)
    check(np.array_equal(labels, ref_labels), "6b labels differ from the plain run's")
    check(worst <= tol, f"6b: the sweep differs from the plain attention by {worst} > {tol}")
    return {"fwd": fwd, "variant_samples_per_s": rate, "warm_variant_samples_per_s": warm,
            "max_abs_diff": worst}


def mmbt_train_step_throughput(text: int, iters: int = 3, dtype=None, rate: float = 0.0) -> dict:
    """The MMBT train micro-step (forward, backward, gradient accumulation)
    at batch 32, both encoders live, on device-resident uint8 images: ms and
    samples/s (host clock, ending in a synchronise), one BertAdam apply's
    ms, then one profiled micro-step. ``dtype`` bf16: ``--bf16``; ``rate``:
    ``--attention_probs_dropout`` (K5 on every layer)."""
    import dataclasses

    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

    bert = (dataclasses.replace(MMBT_BERT or BertConfig.base(), attention_probs_dropout_prob=rate)
            if rate else MMBT_BERT)
    setup = setup_mmbt(n_classes=N_CLASSES, bert_config=bert, resnet_layers=MMBT_RESNET,
                       gradient_accumulation_steps=10**6, seed=0, dtype=dtype, device=DEVICE)
    b = MMBT_TRAIN_BATCH
    g = torch.Generator(device=DEVICE).manual_seed(5)
    vocab = setup.model.config.vocab_size
    ones = torch.ones(b, text, dtype=torch.int64, device=DEVICE)
    x = (torch.randint(104, vocab, (b, text), device=DEVICE, generator=g), ones, ones,
         torch.randint(0, 256, (b, MMBT_IMG, MMBT_IMG, 3), device=DEVICE, generator=g,
                       dtype=torch.uint8))
    y = torch.randint(0, N_CLASSES, (b,), device=DEVICE, generator=g)
    s = MMBT_IMG_TOKENS + text

    def step():
        return steps.train_step(setup.bundle, setup.optimizer, x, y,
                                torch.Generator().manual_seed(3), flags=(False, False),
                                accumulator=setup.accumulator)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    t0 = time.perf_counter()
    setup.optimizer.update(setup.accumulator.grads)
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    label = (f"mmbt train micro-step{' --bf16' if dtype == torch.bfloat16 else ''}"
             + (f" --attention_probs_dropout {rate}" if rate else ""))
    print(f"{label}: batch {b} (S={s}): {ms:.3f} ms, {b * 1e3 / ms:.1f} samples/s; "
          f"one BertAdam apply {apply_ms:.3f} ms", flush=True)
    prof = profile_device(step, 1, f"{label} batch {b} (S={s})")
    return {"S": s, "ms": ms, "samples_per_s": b * 1e3 / ms, "apply_ms": apply_ms, **prof}


def train_step_throughput(setup, text: int, iters: int = 5) -> dict:
    """The train step at batch 128 on device-resident inputs: ms and samples/s
    (host clock, ending in a synchronise), then one profiled step."""
    from multimodal_uncertainty_tpu_torch.training import steps

    g = torch.Generator(device=DEVICE).manual_seed(2)
    x = (torch.randn(TRAIN_BATCH, IMG_PADDED, D, device=DEVICE, generator=g),
         torch.randn(TRAIN_BATCH, text, D, device=DEVICE, generator=g))
    y = torch.randint(0, N_CLASSES, (TRAIN_BATCH,), device=DEVICE, generator=g)
    s = IMG_PADDED + text
    heads = setup.model.mm_encoder.resblocks[0].attn.n_head
    label = f"train step ({heads} heads{', --bf16' if setup.model.dtype == torch.bfloat16 else ''})"

    def step():
        return steps.train_step(setup.bundle, setup.optimizer, x, y, torch.Generator().manual_seed(3))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    print(f"{label}: batch {TRAIN_BATCH} (S={s}): {ms:.3f} ms, "
          f"{TRAIN_BATCH * 1e3 / ms:.1f} samples/s", flush=True)
    prof = profile_device(step, 1, f"{label} batch {TRAIN_BATCH} (S={s})")
    return {"S": s, "ms": ms, "samples_per_s": TRAIN_BATCH * 1e3 / ms, **prof}


def compare_dw(k, din, dout, dtype) -> float:
    """K8: the dW kernel against ``dw_plain`` on the same inputs; returns the
    max abs error. Tolerance ``DW_TOL`` x max(1, max|plain|)."""
    g = torch.Generator(device=DEVICE).manual_seed(k + din + dout)
    x = torch.randn(k, din, device=DEVICE, generator=g).to(dtype)
    dy = torch.randn(k, dout, device=DEVICE, generator=g).to(dtype)
    out = DW.dw_cuda(x, dy)
    ref = DW.dw_plain(x, dy)
    torch.cuda.synchronize()
    err, tol = max_err(out, ref), DW_TOL * max(1.0, float(ref.abs().max()))
    print(f"dw-vs-plain K={k} Din={din} Dout={dout} {str(dtype)[6:]}: {err:.3g} (tol {tol:.3g})",
          flush=True)
    check(out.dtype == torch.float32 and out.shape == (dout, din), "dw output dtype/shape")
    check(bool(torch.isfinite(out).all()), "dw output not finite")
    check(err <= tol, f"dw kernel disagrees with plain: {err} > {tol}")
    DW_CHECKED[(k, din, dout, dtype)] = err
    return err


def compare_dw_linear() -> float:
    """A ``fast_dw`` Linear's gradients through the dW Function against
    autograd through ``F.linear``, at the pooler's strided x[:, 0] and at fc1
    (B=32, S=185); returns the max abs error of dW."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear

    worst = 0.0
    g = torch.Generator(device=DEVICE).manual_seed(8)
    x = torch.randn(VILT_TRAIN_BATCH, VILT_MAX_TEXT + 145, 768, device=DEVICE, generator=g)
    for dout, take in ((768, lambda t: t[:, 0]), (3072, lambda t: t)):
        lin = Linear(768, dout, generator=torch.Generator().manual_seed(dout)).to(DEVICE).train()
        lin.fast_dw = True
        xi = x.clone().requires_grad_()
        lin(take(xi)).square().sum().backward()
        w = lin.weight.detach().clone().requires_grad_()
        xr = x.clone().requires_grad_()
        torch.nn.functional.linear(take(xr), w, lin.bias.detach()).square().sum().backward()
        torch.cuda.synchronize()
        err, tol = max_err(lin.weight.grad, w.grad), DW_TOL * max(1.0, float(w.grad.abs().max()))
        dx_err = max_err(xi.grad, xr.grad)
        dx_tol = DW_TOL * max(1.0, float(xr.grad.abs().max()))
        print(f"dw Linear 768x{dout} ({'x[:, 0]' if dout == 768 else 'B x S rows'}): dW {err:.3g} "
              f"(tol {tol:.3g}), dx {dx_err:.3g} (tol {dx_tol:.3g})", flush=True)
        check(err <= tol and dx_err <= dx_tol, "the dW Function disagrees with autograd")
        worst = max(worst, err)
    return worst


def time_dw(k, din, dout, dtype) -> dict:
    """K8 at one of the ``--fast_dw`` paths' shapes: the kernel, its plain
    version, one ``torch.matmul`` of the same product (TF32 off; a yardstick
    used nowhere in the port), and the bound: 2 K Din Dout operations at the
    card's rate for the input type, or the bytes (x and dy read once, dW
    written once). An fp32 row gives both of its bounds, the FMA units'
    (``fma_bound_ms``, 67 TFLOP/s) and the split-fp32 kernel's own three TF32
    products at 495 TFLOP/s (``tc32_bound_ms``), which is its ``bound_ms``."""
    g = torch.Generator(device=DEVICE).manual_seed(1)
    x = torch.randn(k, din, device=DEVICE, generator=g).to(dtype)
    dy = torch.randn(k, dout, device=DEVICE, generator=g).to(dtype)
    flops = 2 * k * din * dout
    nbytes = k * (din + dout) * x.element_size() + din * dout * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bounds = {}
    if dtype == torch.float32:
        bounds = {"fma_bound_ms": max(t_ops, t_bytes),
                  "tc32_bound_ms": max(3 * flops / TF32_FLOPS * 1e3, t_bytes)}
        t_ops = 3 * flops / TF32_FLOPS * 1e3
    row = {
        "K": k, "Din": din, "Dout": dout, "dtype": str(dtype)[6:], "route": DW.dw_route(k, dtype),
        "ms": cuda_ms(lambda: DW.dw_cuda(x, dy)),
        "plain_ms": cuda_ms(lambda: DW.dw_plain(x, dy)),
        "library_ms": cuda_ms(lambda: torch.matmul(x.t(), dy)),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        **bounds,
    }
    print("time dw " + json.dumps(row), flush=True)
    return row


def dw_eligible(model) -> int:
    """The Linears whose weight gradient a ``fast_dw`` training step computes
    with the kernel: both widths multiples of 128 and the weight trainable
    (a frozen one computes no dW)."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear

    return sum(isinstance(m, Linear) and m.weight.requires_grad
               and m.weight.shape[0] % DW.TILE == 0 and m.weight.shape[1] % DW.TILE == 0
               for m in model.modules())


@contextlib.contextmanager
def dw_shapes_seen():
    """Within: the (K, Din, Dout, dtype) of every weight gradient the dW
    route computes, one entry a call (``DW.weight_grad`` wrapped; the launch
    counters are the kernel's own and move as before)."""
    seen, real = [], DW.weight_grad

    def recording(x2d, dy2d):
        seen.append((x2d.shape[0], x2d.shape[1], dy2d.shape[1], x2d.dtype))
        return real(x2d, dy2d)

    DW.weight_grad = recording
    try:
        yield seen
    finally:
        DW.weight_grad = real


def compare_dw_at(seen: list, label: str) -> list:
    """K8 against ``dw_plain`` (``compare_dw``) at each shape a path gave the
    dW route that no earlier check covered; returns the max abs errors."""
    new = sorted(set(seen) - DW_CHECKED.keys(), key=lambda t: (t[0], t[1], t[2], str(t[3])))
    print(f"{label}: the dW route ran at {len(set(seen))} shapes, {len(new)} not yet checked",
          flush=True)
    return [compare_dw(*shape) for shape in new]


def dw_routes(seen: list, label: str) -> dict:
    """The dW launches since the counters were reset, by kernel: each call
    ``dw_shapes_seen`` recorded took the kernel ``DW.dw_route`` names for its
    K and dtype (fp32: the small-K ``simt`` at K <= ``DW.SIMT_MAX_K``, split
    fp32 ``tc32`` above; bf16: the small-K ``mma`` at K <= ``DW.MMA_MAX_K``,
    stream-K ``tc`` above), and no other launch happened."""
    want = {r: sum(DW.dw_route(k, dtype) == r for k, _, _, dtype in seen)
            for r in ("tc32", "simt", "tc", "mma")}
    got = {r: getattr(DW.dw_cuda, f"launches_{r}") for r in want}
    check(got == want and DW.dw_cuda.launches == len(seen),
          f"{label}: dW launches by kernel {got} (of {DW.dw_cuda.launches}), expected {want}")
    return got


def bf16_small_dw(seen: list, want: set, label: str) -> int:
    """The bf16 dW calls ``dw_shapes_seen`` recorded at K <=
    ``DW.MMA_MAX_K`` (the small-K kernel's): their shapes must be
    exactly ``want`` (MMBT's pooler's K = 32 and image embedding's 96; none
    in FLAVA's step). Returns their count."""
    small = [t for t in seen if t[3] == torch.bfloat16 and t[0] <= DW.MMA_MAX_K]
    check(set(small) == want, f"{label}: bf16 dW shapes at K <= {DW.MMA_MAX_K}: "
                              f"{sorted(set(small), key=str)}, expected {sorted(want, key=str)}")
    return len(small)


def linear_weight_grads(model, grads=None) -> dict:
    """A copy of the gradient of every trainable ``Linear`` weight: its
    ``.grad``, or its entry in ``grads`` (an accumulator's sum)."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear

    return {f"{n}.weight": (m.weight.grad if grads is None else grads[f"{n}.weight"]).detach().clone()
            for n, m in model.named_modules() if isinstance(m, Linear) and m.weight.requires_grad}


def compare_grads(fast: dict, plain: dict, label: str,
                  what: str = "--fast_dw vs autograd's dW") -> float:
    """Gradients of one step with a kernel (the dW kernel; an attention
    instance) against the same step's without it, leaf by leaf: |fast -
    plain| <= ``DW_TOL`` x max|plain| of the leaf. Returns the worst ratio of
    error to max|plain|."""
    check(set(fast) == set(plain) and len(plain) > 0, f"{label}: leaves differ or none")
    worst, worst_name = 0.0, None
    for name, ref in plain.items():
        err, scale = max_err(fast[name], ref), float(ref.abs().max())
        check(bool(torch.isfinite(fast[name]).all()), f"{label}: gradient of {name} not finite")
        check(err <= DW_TOL * scale, f"{label}: gradient of {name} differs by {err} > "
                                     f"{DW_TOL} x {scale}")
        ratio = err / scale if scale else 0.0
        if ratio >= worst:
            worst, worst_name = ratio, name
    print(f"{label}: {len(plain)} gradients, {what}: worst |diff| / "
          f"max|grad| {worst:.3g} ({worst_name}; tol {DW_TOL})", flush=True)
    return worst


@contextlib.contextmanager
def first_update_grads():
    """Within: a copy of the gradients the first ``AdamW.update`` applies
    (under accumulation, the sum of the first window, taken before any
    weight has moved)."""
    from multimodal_uncertainty_tpu_torch.training import optim

    kept, real = {}, optim.AdamW.update

    def keeping(self, grads=None):
        if not kept:
            kept.update({n: g.detach().clone() for n, g in grads.items()})
        return real(self, grads)

    optim.AdamW.update = keeping
    try:
        yield kept
    finally:
        optim.AdamW.update = real


def vilt_model(seed: int, device: str):
    import dataclasses

    from multimodal_uncertainty_tpu_torch.models.vilt import ViltConfig
    from multimodal_uncertainty_tpu_torch.zoo import build_vilt

    cfg = VILT_CFG or dataclasses.replace(ViltConfig.b32(), num_labels=N_CLASSES)
    return build_vilt(N_CLASSES, vilt_config=cfg, device=device,
                      generator=torch.Generator().manual_seed(seed))


def rect_mask(h: int, w: int) -> np.ndarray:
    m = np.zeros((VILT_IMG, VILT_IMG), np.int64)
    m[:h, :w] = 1
    return m


def serve_vilt_end_to_end(tmp: str):
    """Phase 3c; returns the kernel launches of the main path's run and the
    predictor (phase 5 times it)."""
    from functools import partial

    from multimodal_uncertainty_tpu_torch.models import vilt as V
    from multimodal_uncertainty_tpu_torch.server import (
        PredictionServer,
        uncertainty_result,
        vilt_request,
    )
    from multimodal_uncertainty_tpu_torch.serving import ViltPredictor, vilt_micro_batcher
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights

    t0 = time.perf_counter()
    ckpt = os.path.join(tmp, "vilt_best_val.pt")
    save_weights(vilt_model(0, "cpu"), None, ckpt)
    pred = ViltPredictor(vilt_model(1, "cpu"), ckpt, device=DEVICE)
    n_layers, cfg = len(pred.model.vilt.block), pred.model.config
    patches = (VILT_IMG // cfg.patch_size) ** 2
    print(f"vilt: model built, saved and restored on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mb = vilt_micro_batcher(pred, max_batch=32, max_wait_ms=5, uncertainty=True)
    batches, seq_lens = [], []
    run_batch = mb.predict_batch

    def recording(samples):
        batches.append(list(samples))
        seq_lens.append(-(-max(len(smp["input_ids"]) for smp in samples) // 8) * 8 + 1 + patches)
        return run_batch(samples)

    mb.predict_batch = recording

    rng = np.random.default_rng(5)
    lengths = rng.integers(VILT_MIN_TEXT, VILT_MAX_TEXT + 1, size=VILT_REQUESTS)
    lengths[0] = VILT_MAX_TEXT
    t0 = time.perf_counter()
    bodies = []
    for i, lt in enumerate(int(n) for n in lengths):
        img = np.round(rng.normal(size=(VILT_IMG, VILT_IMG, 3)), 2)
        img[0, 0, 0] = i  # identifies the sample inside a coalesced batch
        body = {"input_ids": [101] + rng.integers(104, cfg.vocab_size, size=lt - 1).tolist(),
                "attention_mask": [1] * lt, "token_type_ids": [0] * lt,
                "pixel_values": img.tolist()}
        if i % 4 == 1:  # a top-left 256 x 320 region of real pixels
            body["pixel_mask"] = rect_mask(256, 320).tolist()
        elif i == 2:  # no real pixel: the image [CLS] alone
            body["pixel_mask"] = rect_mask(0, 0).tolist()
        bodies.append(json.dumps(body).encode())
    print(f"vilt serving: {len(bodies)} request bodies encoded in "
          f"{time.perf_counter() - t0:.1f} s ({sum(map(len, bodies)) / 1e6:.1f} MB)", flush=True)

    decode = partial(vilt_request, max_len=pred.max_text_len)
    srv = PredictionServer(mb, decode, port=0, encode_result=uncertainty_result).start()
    answers = {}
    try:
        def client(idx):
            for i in idx:
                answers[i] = post(srv.port, bodies[i])

        threads = [threading.Thread(target=client, args=(range(t, len(bodies), 8),))
                   for t in range(8)]
        reset_counters()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = A.attention_fwd_cuda.launches
        check(A.attention_bwd_cuda.launches == 0 and DW.dw_cuda.launches == 0,
              "serving launched a backward kernel")
        check_fwd_routes("vilt serving")
    finally:
        srv.close()
        mb.close()
    check(len(answers) == len(bodies), f"{len(answers)} of {len(bodies)} requests answered")
    print(f"vilt serving: {len(bodies)} requests in {wall:.3f} s over {len(batches)} coalesced "
          f"batches {[len(bt) for bt in batches]} (S {seq_lens}); kernel launches {launches}",
          flush=True)
    check(launches == n_layers * 3 * len(batches),
          f"kernel launches {launches} != {n_layers} layers x 3 forwards x {len(batches)} batches")

    # the same batches with the plain attention on the card
    V.attention_qkv_packed = plain_packed
    try:
        reference = {}
        for bt in batches:
            for smp, res in zip(bt, run_batch(bt)):
                reference[int(smp["pixel_values"][0, 0, 0])] = res
    finally:
        V.attention_qkv_packed = A.attention_qkv_packed
    worst = 0.0
    for i, (status, out) in answers.items():
        probs = np.asarray(out["probs"])
        check(status == 200, f"request {i}: HTTP {status}")
        check(probs.shape == (N_CLASSES,) and bool(np.isfinite(probs).all()),
              f"request {i}: probs shape {probs.shape} or not finite")
        check(abs(probs.sum() - 1.0) < 1e-4, f"request {i}: probs sum {probs.sum()}")
        ref_probs, ref_diag = reference[i]
        worst = max(worst, float(np.abs(probs - ref_probs).max()),
                    *(abs(out[k] - float(ref_diag[k])) for k in ref_diag))
    print(f"vilt serving: answers vs plain attention on the card, max abs diff {worst:.3g}",
          flush=True)
    check(worst <= 1e-4, f"served ViLT answers differ from the plain attention by {worst}")
    return launches, pred


def vilt_throughput(pred, n: int, iters: int = 5) -> dict:
    """Samples/s of ``ViltPredictor.predict`` at the longest text (S = 40 +
    145; host clock, each call ends in a copy to the host), then one profiled
    call."""
    rng = np.random.default_rng(n)
    lt = pred.max_text_len
    batch = {"input_ids": rng.integers(104, pred.model.config.vocab_size, size=(n, lt)),
             "attention_mask": np.ones((n, lt), np.int64),
             "token_type_ids": np.zeros((n, lt), np.int64),
             "pixel_values": rng.normal(size=(n, VILT_IMG, VILT_IMG, 3)).astype(np.float32)}
    s = lt + 1 + (VILT_IMG // pred.model.config.patch_size) ** 2
    pred.predict(batch)
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.predict(batch)
    dt = time.perf_counter() - t0
    print(f"vilt predictor: batch {n} (S={s}): {iters * n / dt:.1f} samples/s", flush=True)
    prof = profile_device(lambda: pred.predict(batch), 1,
                          f"vilt predictor batch {n} (S={s}) per batch")
    return {"S": s, "samples_per_s": iters * n / dt, **prof}


def write_vilt_food101(root: str, rng) -> None:
    """A synthetic Food-101 tree in the layout ``data/vilt_data.py`` reads: 101
    labels, a ``vocab.txt`` of BERT-base-uncased's size with its special tokens
    at their ids, texts of 2-60 single-wordpiece words (cut to 40 ids), and
    384x384 P6 images (no resize on the way to the 384 crop, so no PIL is
    needed)."""
    from multimodal_uncertainty_tpu_torch.data.images import write_ppm

    d = os.path.join(root, "food101")
    os.makedirs(os.path.join(d, "images"))
    special = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]", 103: "[MASK]"}
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.writelines(special.get(i, f"[unused{i}]" if i < 100 else f"w{i}") + "\n"
                     for i in range(MMBT_VOCAB))
    words = np.asarray([f"w{i}" for i in range(104, MMBT_VOCAB)])
    for split, n in VILT_ROWS:
        with open(os.path.join(d, f"{split}.jsonl"), "w") as f:
            for i in range(n):
                img = f"images/{split}_{i}.ppm"
                write_ppm(os.path.join(d, img),
                          rng.integers(0, 256, (VILT_IMG, VILT_IMG, 3), np.uint8))
                text = " ".join(rng.choice(words, size=int(rng.integers(2, 61))))
                f.write(json.dumps({"id": f"{split}_{i}", "label": f"class_{i % N_CLASSES}",
                                    "text": text, "img": img}) + "\n")


def vilt_argv(run: str, *extra) -> list:
    return (["--framework", "vilt", "--dataset", "food101", "--save_path", run,
             "--batch_size", str(VILT_TRAIN_BATCH), "--gradient_accumulation_steps",
             str(VILT_ACCUM), "--lr", str(VILT_LR), "--seed", str(VILT_SEED), "--device", DEVICE]
            + (["--tiny"] if VILT_TINY else []) + list(extra))


def vilt_setup(argv: list):
    """The train CLI's own loaders and ``setup_vilt`` for ``argv`` (fresh
    weights from the seed)."""
    from multimodal_uncertainty_tpu_torch import train

    args = train.add_conditional_args(train.build_parser().parse_args(argv))
    return train._vilt_setup(args, resolve_device(DEVICE))


def train_vilt_end_to_end(tmp: str) -> dict:
    """Phase 4c; returns the kernel launches of the main path's run."""
    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
    from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    write_vilt_food101(os.path.join(tmp, "data"), np.random.default_rng(6))
    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    print(f"vilt training: Food-101 tree written in {time.perf_counter() - t0:.1f} s", flush=True)

    losses, seq_lens = [], []
    train_step = steps.train_step

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])  # a device scalar, read after the run
        seq_lens.append(x["input_ids"].shape[1] + 1 + x["pixel_mask"].shape[1]
                        * x["pixel_mask"].shape[2] // 32 ** 2)
        return logs

    run = os.path.join(tmp, "vilt_run")
    argv = vilt_argv(run, "--n_epochs", "2", "--fast_dw")
    steps.train_step = recording
    try:
        with dw_shapes_seen() as shapes, first_update_grads() as fast_grads:
            reset_counters()
            t0 = time.perf_counter()
            train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fwd, bwd, dw = (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
                            DW.dw_cuda.launches)
            routes = dw_routes(shapes, "vilt training")
            check_fwd_routes("vilt training")
    finally:
        steps.train_step = train_step
    run_losses = [float(v) for v in losses]
    hist = load_history(run)
    train_loader, valid, _, fresh = vilt_setup(argv)
    n_layers, per_epoch = len(fresh.model.vilt.block), len(train_loader)
    n_eval = sum(-(-n // VILT_TRAIN_BATCH) for _, n in VILT_ROWS[1:]) * 2
    fresh.model.train()
    per_step = dw_eligible(fresh.model)
    print(f"vilt training: 2 epochs, {len(run_losses)} micro-steps at batch {VILT_TRAIN_BATCH} "
          f"(accumulation {VILT_ACCUM}, --fast_dw; S per step {seq_lens}) in {wall:.3f} s; "
          f"losses {run_losses}; history " + json.dumps(
              {k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc", "test_loss", "test_acc",
                                    "time")})
          + f"; launches fwd {fwd} bwd {bwd} dw {dw} ({per_step} Linears take the dW kernel)",
          flush=True)
    check(len(hist["epoch"]) == 2 and all(np.isfinite(hist["loss"]))
          and all(np.isfinite(hist["val_loss"])), f"history.csv: {hist}")
    for f in ("history.csv", "model_best_val.pt", "model_last_epoch.pt", "model_epoch_1.pt",
              "model_epoch_2.pt"):
        check(os.path.exists(os.path.join(run, f)), f"missing {f}")
    check(len(run_losses) == 2 * per_epoch,
          f"{len(run_losses)} micro-steps, expected {2 * per_epoch}")
    # 4 a block (qkv, proj, fc1, fc2), the pooler and cls_fc; cls_out's 101 outputs are no
    # multiple of 128 and the patch embedding is a convolution
    check(per_step == 4 * n_layers + 2, f"{per_step} Linears take the dW kernel, expected "
                                        f"{4 * n_layers + 2}")
    check(dw == per_step * len(run_losses),
          f"dW launches {dw} != {per_step} x {len(run_losses)} micro-steps")
    check(bwd == n_layers * len(run_losses),
          f"K1 backward launches {bwd} != {n_layers} x {len(run_losses)} micro-steps")
    check(fwd == n_layers * (len(run_losses) + n_eval),
          f"K1 forward launches {fwd} != {n_layers} x ({len(run_losses)} + {n_eval} eval batches)")
    dw_errs = compare_dw_at(shapes, "vilt training")

    # resume from the last epoch's checkpoint: the same val metrics
    resume_train_state(fresh.model, fresh.optimizer, os.path.join(run, "model_last_epoch.pt"),
                       accumulator=fresh.accumulator, plateau=fresh.plateau)
    again = Trainer(fresh.bundle, fresh.optimizer, seed=VILT_SEED, verbose=False).eval_loop(
        valid, "val")
    d_loss = abs(again["val_loss"] - hist["val_loss"][-1])
    d_acc = abs(again["val_acc"] - hist["val_acc"][-1])
    print(f"vilt training: resume from model_last_epoch.pt: val_loss {again['val_loss']} "
          f"(|diff| {d_loss:.3g}), val_acc {again['val_acc']} (|diff| {d_acc:.3g})", flush=True)
    check(d_loss <= 1e-6 * abs(hist["val_loss"][-1]) and d_acc <= 1e-6,
          "ViLT resume does not reproduce the last val metrics")
    del fresh

    # epoch 1 again without --fast_dw: autograd's dW (cuBLAS) in place of the kernel
    _, _, _, ref = vilt_setup(vilt_argv(run, "--n_epochs", "2"))
    trainer = Trainer(ref.bundle, ref.optimizer, seed=VILT_SEED, verbose=False)
    plain_losses = []
    reset_counters()
    with first_update_grads() as plain_grads:
        for i, batch in enumerate(train_loader.iter_epoch(1), start=1):
            x, y = steps.to_device(batch, DEVICE)
            logs = steps.train_step(ref.bundle, ref.optimizer, x, y, trainer.generator(1, i),
                                    accumulator=ref.accumulator)
            plain_losses.append(float(logs["loss"]))
    check(DW.dw_cuda.launches == 0, "the run without --fast_dw launched the dW kernel")
    # the sum of micro-steps 1-2, before any update: the gradients --fast_dw computed
    grad_ratio = compare_grads(fast_grads, plain_grads,
                               f"vilt training, summed gradients of micro-steps 1-{VILT_ACCUM}")
    del fast_grads, plain_grads
    rel = max(abs(a - b) / abs(b) for a, b in zip(run_losses, plain_losses))
    first, _ = load_weights(os.path.join(run, "model_epoch_1.pt"))
    bound = 2 * VILT_LR * (per_epoch // VILT_ACCUM)
    diffs = {n: (p.detach().cpu() - first[n]).abs() for n, p in ref.model.state_dict().items()}
    worst = max(float(d.max()) for d in diffs.values())
    print(f"vilt training: --fast_dw vs autograd's dW over the {per_epoch} micro-steps of epoch "
          f"1: losses {run_losses[:per_epoch]} vs {plain_losses}, max rel diff {rel:.3g}; "
          f"parameters max |diff| {worst:.3g} (bound {bound:.3g}, which AdamW's normalised "
          f"steps meet whatever the gradient: the gradients above are the check of dW)",
          flush=True)
    check(rel <= 1e-4, f"ViLT --fast_dw vs plain losses differ by {rel} relative")
    check(worst <= bound, f"ViLT --fast_dw vs plain parameters differ by {worst} > {bound}")
    return {"fwd": fwd, "bwd": bwd, "dw": dw, "dw_routes": routes, "dw_per_step": per_step,
            "loss_rel": rel,
            "grad_ratio": grad_ratio, "dw_errs": dw_errs}


def fast_dw_steps() -> dict:
    """Phases 4 and 4b with ``--fast_dw``: one train step of the full-width
    FLAVA fusion model (batch 32, S = 224 + 96) and one micro-step of the
    full-width MMBT (batch 32, S = 5 + 160) with both encoders live, then one
    with both frozen, each counted from 0: the dW launches equal the Linears
    whose widths are multiples of 128 and whose weight is trainable; the loss
    equals the same step's without the kernel (1e-5 relative), and so does
    every trainable Linear weight's gradient (``compare_grads``); K8 is held
    to ``dw_plain`` at every shape these steps gave it."""
    from multimodal_uncertainty_tpu_torch.models.layers import set_fast_dw
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

    g = torch.Generator(device=DEVICE).manual_seed(9)
    x = (torch.randn(32, IMG_PADDED, D, device=DEVICE, generator=g),
         torch.randn(32, 96, D, device=DEVICE, generator=g))
    y = torch.randint(0, N_CLASSES, (32,), device=DEVICE, generator=g)
    out, grad_ratios = {}, {}
    losses, grads = [], []
    for fast in (False, True):
        setup = train_setup(5, fast_dw=fast)
        setup.model.train()
        expected = dw_eligible(setup.model) if fast else 0
        with dw_shapes_seen() as shapes:
            reset_counters()
            logs = steps.train_step(setup.bundle, setup.optimizer, x, y,
                                    torch.Generator().manual_seed(3))
            losses.append(float(logs["loss"]))
            torch.cuda.synchronize()
            check(DW.dw_cuda.launches == expected,
                  f"FLAVA step: dW launches {DW.dw_cuda.launches} != {expected}")
            routes = dw_routes(shapes, "fast_dw: FLAVA train step")
        out["flava"] = DW.dw_cuda.launches
        grads.append(linear_weight_grads(setup.model))  # the step's, from the same weights
        del setup
    grad_ratios["flava"] = compare_grads(grads[1], grads[0], "fast_dw: FLAVA train step")
    dw_errs = compare_dw_at(shapes, "fast_dw: FLAVA train step")
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    print(f"fast_dw: FLAVA train step (batch 32, S={IMG_PADDED + 96}): dW launches "
          f"{out['flava']} (2 projections + 4 x {LAYERS} layers); loss {losses[1]} vs "
          f"{losses[0]} without, rel diff {rel:.3g}", flush=True)
    check(rel <= 1e-5, f"FLAVA --fast_dw loss differs by {rel} relative")

    setup = setup_mmbt(n_classes=N_CLASSES, bert_config=MMBT_BERT, resnet_layers=MMBT_RESNET,
                       gradient_accumulation_steps=10**6, seed=0, device=DEVICE)
    vocab = setup.model.config.vocab_size
    ones = torch.ones(32, 160, dtype=torch.int64, device=DEVICE)
    xm = (torch.randint(104, vocab, (32, 160), device=DEVICE, generator=g), ones, ones,
          torch.randint(0, 256, (32, MMBT_IMG, MMBT_IMG, 3), device=DEVICE, generator=g,
                        dtype=torch.uint8))
    ym = torch.randint(0, N_CLASSES, (32,), device=DEVICE, generator=g)
    for flags, name in (((False, False), "mmbt"), ((True, True), "mmbt frozen")):
        losses, grads = [], []
        for fast in (False, True):  # accumulation never applies: the weights stay
            set_fast_dw(setup.model, fast)
            setup.accumulator.clear()  # so that it holds this micro-step's gradient / every
            with dw_shapes_seen() as shapes:
                reset_counters()
                logs = steps.train_step(setup.bundle, setup.optimizer, xm, ym,
                                        torch.Generator().manual_seed(4), flags=flags,
                                        accumulator=setup.accumulator)
                losses.append(float(logs["loss"]) * setup.accumulator.every)  # undo loss / accum
                torch.cuda.synchronize()
                expected = dw_eligible(setup.model) if fast else 0
                check(DW.dw_cuda.launches == expected,
                      f"{name} micro-step: dW launches {DW.dw_cuda.launches} != {expected}")
                micro_routes = dw_routes(shapes, f"fast_dw: {name} micro-step")
            grads.append(linear_weight_grads(setup.model, setup.accumulator.grads))
        out[name] = DW.dw_cuda.launches
        routes = {r: n + micro_routes[r] for r, n in routes.items()}
        grad_ratios[name] = compare_grads(grads[1], grads[0], f"fast_dw: {name} micro-step")
        dw_errs += compare_dw_at(shapes, f"fast_dw: {name} micro-step")
        rel = abs(losses[1] - losses[0]) / abs(losses[0])
        print(f"fast_dw: MMBT micro-step (batch 32, S={MMBT_IMG_TOKENS + 160}, freeze flags "
              f"{flags}): dW launches {out[name]}; loss {losses[1]} vs {losses[0]} without, "
              f"rel diff {rel:.3g}", flush=True)
        check(rel <= 1e-5, f"MMBT --fast_dw loss differs by {rel} relative")
    n_layers = len(setup.model.enc.encoder.layer)
    # 6 a BERT layer (query, key, value, attention output, intermediate, output), the
    # pooler and the image embedding; frozen encoders leave the last two
    check(out["mmbt"] == 6 * n_layers + 2 and out["mmbt frozen"] == 2,
          f"MMBT dW launches {out}")
    check(out["flava"] == 2 + 4 * LAYERS, f"FLAVA dW launches {out['flava']}")
    return {**out, "routes": routes, "grad_ratios": grad_ratios, "dw_errs": dw_errs}


@contextlib.contextmanager
def attention_launches():
    """Within: one (direction, dtype, head dim, dropout, source) entry for
    every attention kernel launch (``A._launch_fwd`` / ``A._launch_bwd``
    wrapped), the source being the one the launch asked ``_build.load`` for.
    The launch counters move as before."""
    seen = []
    real_fwd, real_bwd = A._launch_fwd, A._launch_bwd

    def launch(direction, real, q, keep, n_head, *args):
        with sources_loaded() as names:
            result = real(*args)
        attention = [n for n in names if n.startswith("attention")]
        check(len(attention) == 1, f"one attention launch asked for the sources {names}")
        seen.append((direction, q.dtype, q.shape[-1] // n_head, keep is not None, attention[0]))
        return result

    A._launch_fwd = lambda q, k, v, key_mask, keep, rate, n_head, who: launch(
        "fwd", real_fwd, q, keep, n_head, q, k, v, key_mask, keep, rate, n_head, who)
    A._launch_bwd = lambda q, k, v, key_mask, keep, rate, out, lse, dout, n_head, grads, who: (
        launch("bwd", real_bwd, q, keep, n_head, q, k, v, key_mask, keep, rate, out, lse, dout,
               n_head, grads, who))
    try:
        yield seen
    finally:
        A._launch_fwd, A._launch_bwd = real_fwd, real_bwd


def check_bf16_launches(seen: list, label: str) -> dict:
    """Every attention launch of a ``--bf16`` path (``attention_launches``)
    was a bf16 one on the source ``A.fwd_source`` / ``A.bwd_source`` names for
    its head dim and dropout, and the counters saw each of them; returns the
    launches by (direction, dropout, source)."""
    wrong = [e for e in seen if e[1] != torch.bfloat16]
    check(not wrong, f"{label}: {len(wrong)} attention launches not in bf16, e.g. {wrong[:3]}")
    for direction, dtype, dh, dropout, source in seen:
        want = (A.fwd_source if direction == "fwd" else A.bwd_source)(dtype, dh, dropout)
        check(source == want, f"{label}: a bf16 {direction} launch at Dh={dh} ran {source}, "
                              f"not {want}")
    counted = (A.attention_fwd_cuda.launches + A.attention_fwd_dropout_cuda.launches,
               A.attention_bwd_cuda.launches + A.attention_bwd_dropout_cuda.launches)
    check(counted == (sum(e[0] == "fwd" for e in seen), sum(e[0] == "bwd" for e in seen)),
          f"{label}: counters {counted} against {len(seen)} recorded launches")
    tc = (sum(e[4] in A.TC_FWD_SOURCES for e in seen),
          sum(e[4] in A.TC_BWD_SOURCES for e in seen))
    check((A.attention_fwd_cuda.launches_tc + A.attention_fwd_dropout_cuda.launches_tc,
           A.attention_bwd_cuda.launches_tc + A.attention_bwd_dropout_cuda.launches_tc) == tc
          and A.attention_fwd_cuda.launches_tc32 + A.attention_fwd_dropout_cuda.launches_tc32 == 0,
          f"{label}: tensor-core route counters against {tc}")
    by_route: dict = {}
    for direction, _, dh, dropout, source in seen:
        key = f"{direction}{' dropout' if dropout else ''} Dh={dh} {source}"
        by_route[key] = by_route.get(key, 0) + 1
    print(f"{label}: attention launches, all bf16, by route: {json.dumps(by_route)}", flush=True)
    return by_route


def checkpoint_dtypes(path: str, label: str) -> None:
    """A ``--bf16`` run's checkpoint holds fp32 parameters and buffers, fp32
    optimizer moments and (under accumulation) fp32 accumulated gradients;
    BatchNorm's running statistics are finite."""
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights

    model, opt = load_weights(path)
    trees = {"model": model, "mu": opt["opt_state"]["mu"], "nu": opt["opt_state"]["nu"],
             "accum_grads": opt.get("accum_grads", {})}
    bad = [(t, n) for t, tree in trees.items() for n, v in tree.items()
           if v.is_floating_point() and v.dtype != torch.float32]
    check(not bad, f"{label}: checkpoint tensors not fp32: {bad[:5]}")
    stats = [v for n, v in model.items() if n.endswith(("running_mean", "running_var"))]
    check(all(bool(torch.isfinite(v).all()) for v in stats),
          f"{label}: BatchNorm running statistics not finite")
    print(f"{label}: checkpoint {os.path.basename(path)}: {len(model)} model tensors, moments"
          f"{' and accumulated gradients' if trees['accum_grads'] else ''} fp32; "
          f"{len(stats)} BatchNorm statistics, all finite", flush=True)


def compare_bf16_grads(fast: dict, plain: dict, label: str) -> float:
    """One bf16 step's gradients with the kernels against the same step's with
    the plain attention (and autograd's dW), leaf by leaf: |fast - plain| <=
    ``BF16_GRAD_TOL`` x max(1, max|plain|). Returns the worst ratio of error
    to the leaf's max|plain| (printed; BERT's and the packed key biases, whose
    true gradient is 0, are rounding noise there)."""
    check(set(fast) == set(plain) and plain, f"{label}: leaves differ or none")
    worst, worst_name = 0.0, None
    for name, ref in plain.items():
        check(fast[name].dtype == torch.float32 and bool(torch.isfinite(fast[name]).all()),
              f"{label}: gradient of {name} not finite fp32")
        err, scale = max_err(fast[name], ref), float(ref.abs().max())
        check(err <= BF16_GRAD_TOL * max(1.0, scale),
              f"{label}: gradient of {name} differs by {err} > {BF16_GRAD_TOL} x max(1, {scale})")
        if scale and err / scale >= worst and not name.endswith(("key.bias", "in_proj.bias")):
            worst, worst_name = err / scale, name
    print(f"{label}: {len(plain)} gradients within {BF16_GRAD_TOL} x max(1, max|plain|); worst "
          f"|diff| / max|grad| outside the key biases {worst:.3g} ({worst_name})", flush=True)
    return worst


def flava_bf16_argv(run: str, *extra) -> list:
    return ["--framework", "flava", "--save_path", run, "--dataset", "food101",
            "--model_type", "MIMO-shuffle-instance", "--batch_size", str(TRAIN_BATCH),
            "--multimodal_num_attention_heads", str(HEADS),
            "--multimodal_num_hidden_layers", str(LAYERS), "--lr", str(TRAIN_LR),
            "--n_epochs", str(TRAIN_EPOCHS), "--seed", str(TRAIN_SEED), "--device", DEVICE,
            "--bf16", *extra]


def flava_batch_movers(tmp: str) -> dict:
    """Phase 4i: phase 4f's train CLI (``--bf16``, batch 128, 2 epochs on
    phase 4's shards) in each of ``MOVER_RUNS``: the prefetcher (pinned
    buffers, a side stream) against the plain batch mover (``steps.to_device``
    from pageable memory as each batch comes), each
    under the profiler (device activity only; no checkpoint file): losses and
    history equal, launches exact, each run's epoch-loop and whole-run busy
    share and ``Memcpy HtoD`` by source printed. Returns the launches and the
    shares."""
    import types

    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.loop import load_history

    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    args = types.SimpleNamespace(batch_size=TRAIN_BATCH, seed=TRAIN_SEED, sample_size=None,
                                 n_workers=0)
    loader = get_dataset_flava(args, os.path.join(tmp, "data", "food101"))[0]
    per_batch = batch_arrays(loader)
    n_train = SPLITS[0][1] // TRAIN_BATCH * TRAIN_EPOCHS
    n_eval = sum(-(-n // TRAIN_BATCH) for _, n, _ in SPLITS[1:]) * TRAIN_EPOCHS
    losses, train_step = [], steps.train_step

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])
        return logs

    runs = {}
    for i, (name, plain, extra) in enumerate(MOVER_RUNS):
        argv = flava_bf16_argv(os.path.join(tmp, f"run_bf16_mover_{i}"), *extra)
        losses.clear()
        steps.train_step = recording
        try:
            reset_counters()
            with no_checkpoint_files(), batch_mover(plain), marked_epoch_loop() as walls:
                prof = profile_device(lambda: train.main(argv), 1,
                                      f"flava train CLI --bf16, {TRAIN_EPOCHS} epochs, {name}",
                                      cpu_ops=False)
            fwd, bwd = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
        finally:
            steps.train_step = train_step
        hist = load_history(argv[argv.index("--save_path") + 1])
        runs[name] = {"losses": [float(v) for v in losses], "hist": hist, "prof": prof,
                      "plain": plain, "loop": device_window(prof, True),
                      "whole": device_window(prof, False), "loop_wall_ms": walls[0],
                      "fwd": fwd, "bwd": bwd}
        check(len(hist["epoch"]) == TRAIN_EPOCHS and all(np.isfinite(hist["loss"]))
              and len(losses) == n_train, f"4i ({name}): {len(losses)} steps, history {hist}")
        check((fwd, bwd) == (LAYERS * (n_train + n_eval), LAYERS * n_train),
              f"4i ({name}): launches fwd {fwd} bwd {bwd}")
    check_movers_agree("4i flava --bf16", runs, per_batch, n_train + n_eval)
    print_movers(f"4i flava train CLI --bf16, {TRAIN_EPOCHS} epochs", runs)
    own = own_mover(loader)
    print(f"4i: the trainer's own mover for flava: {own}", flush=True)
    check(own.startswith("prefetch"), f"4i: the trainer moves flava's batches plainly: {own}")
    return {"fwd": sum(r["fwd"] for r in runs.values()),
            "bwd": sum(r["bwd"] for r in runs.values()),
            "busy": {k: (r["loop"] and r["loop"]["share"], r["whole"]["share"])
                     for k, r in runs.items()}}


def train_bf16_end_to_end(tmp: str) -> dict:
    """Phase 4f: ``train --framework flava --bf16`` on phase 4's shards under
    ``tmp/data`` (batch 128, 2 epochs, S = 320 and 736), then one-step checks
    at batch 32 (``flava_bf16_steps``). Returns the launches of the run."""
    import types

    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    run = os.path.join(tmp, "run_bf16")
    argv = flava_bf16_argv(run)
    losses, seq_lens, train_step = [], [], steps.train_step

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])
        seq_lens.append(x[0].shape[1] + x[1].shape[1])
        return logs

    steps.train_step = recording
    try:
        with attention_launches() as seen:
            reset_counters()
            prof = profile_device(lambda: train.main(argv), 1,
                                  f"train CLI --bf16 ({HEADS} heads), {TRAIN_EPOCHS} epochs with "
                                  f"eval and checkpoints")
            fwd, bwd = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
            routes = check_bf16_launches(seen, "flava training --bf16")
            for direction, source, n, wrapper in (
                    ("fwd", A.fwd_source, fwd, A.attention_fwd_cuda),
                    ("bwd", A.bwd_source, bwd, A.attention_bwd_cuda)):
                dh = D // HEADS
                tc_route = f"{direction} Dh={dh} {source(torch.bfloat16, dh, False)}"
                check(routes.get(tc_route) == n == wrapper.launches_tc,
                      f"--bf16: {routes.get(tc_route)} of {n} {direction} launches on {tc_route}, "
                      f"launches_tc {wrapper.launches_tc}")
    finally:
        steps.train_step = train_step
    losses = [float(v) for v in losses]
    hist = load_history(run)
    n_train = SPLITS[0][1] // TRAIN_BATCH * TRAIN_EPOCHS
    n_eval = sum(-(-n // TRAIN_BATCH) for _, n, _ in SPLITS[1:]) * TRAIN_EPOCHS
    print(f"training --bf16 ({HEADS} heads): {len(losses)} train steps at batch {TRAIN_BATCH} "
          f"(S per step {seq_lens}) in {prof['wall_ms'] / 1e3:.3f} s; losses {losses}; history "
          + json.dumps({k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc", "time")})
          + f"; launches fwd {fwd} bwd {bwd}", flush=True)
    check(len(hist["epoch"]) == TRAIN_EPOCHS and all(np.isfinite(hist["loss"]))
          and all(np.isfinite(hist["val_loss"])), f"history.csv: {hist}")
    check(len(losses) == n_train and max(seq_lens) == IMG_PADDED + LONG_TEXT
          and min(seq_lens) <= IMG_PADDED + 96, f"train steps {len(losses)} at S {seq_lens}")
    check((fwd, bwd) == (LAYERS * (n_train + n_eval), LAYERS * n_train),
          f"--bf16 launches fwd {fwd} bwd {bwd}, expected {LAYERS} x ({n_train} + {n_eval}) and "
          f"{LAYERS} x {n_train}")
    checkpoint_dtypes(os.path.join(run, "model_last_epoch.pt"), "flava training --bf16")

    # resume from the last epoch's checkpoint into a fresh bf16 setup: the same val metrics
    args = types.SimpleNamespace(batch_size=TRAIN_BATCH, seed=TRAIN_SEED, sample_size=None,
                                 n_workers=0)
    train_loader, valid, _ = get_dataset_flava(args, os.path.join(tmp, "data", "food101"))
    fresh = train_setup(len(train_loader), dtype=torch.bfloat16)
    resume_train_state(fresh.model, fresh.optimizer, os.path.join(run, "model_last_epoch.pt"))
    again = Trainer(fresh.bundle, fresh.optimizer, seed=TRAIN_SEED, verbose=False).eval_loop(
        valid, "val")
    d_loss, d_acc = abs(again["val_loss"] - hist["val_loss"][-1]), abs(
        again["val_acc"] - hist["val_acc"][-1])
    print(f"training --bf16: resume from model_last_epoch.pt: val_loss {again['val_loss']} "
          f"(|diff| {d_loss:.3g}), val_acc {again['val_acc']} (|diff| {d_acc:.3g})", flush=True)
    check(d_loss <= 1e-6 * abs(hist["val_loss"][-1]) and d_acc <= 1e-6,
          "the --bf16 resume does not reproduce the last val metrics")
    del fresh
    return {"fwd": fwd, "bwd": bwd, "routes": routes, "wall_s": prof["wall_ms"] / 1e3,
            **flava_bf16_steps()}


def flava_bf16_steps() -> dict:
    """Phase 4f's one-step checks at full width (batch 32, S = 224 + 96), from
    one set of weights and one batch: the bf16 step with the kernels and
    ``--fast_dw`` (every dW launch on ``dw_kernel_tc``, one a trainable
    Linear whose widths are multiples of 128) against the bf16 step with the
    plain attention and autograd's dW (``compare_bf16_grads``); its loss
    within ``BF16_LOSS_RTOL`` of the fp32 step's with the kernels; then the
    same kernels-vs-plain step at 8, 4, 16, 32, 2, 1, 6, 12 and 24 heads (Dh
    96, 192, 48, 24: K6's bf16 tensor-core sources; 384 and 768: the
    tensor-core forward and backward on clusters, ``csrc/attention_fwd_tc_
    wide.cuh`` and ``csrc/attention_bwd_tc_wide.cuh``, none on the FMA
    clusters of ``csrc/attention_bwd_wide.cu``; 128, 64 and 32: K1's bf16
    tensor-core sources), ``LAYERS`` launches in each direction, every one on
    the tensor-core source ``fwd_source`` / ``bwd_source`` names for its head
    dim, all counted in ``launches_tc``."""
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.models.layers import set_fast_dw
    from multimodal_uncertainty_tpu_torch.training import steps

    g = torch.Generator(device=DEVICE).manual_seed(14)
    x = (torch.randn(32, IMG_PADDED, D, device=DEVICE, generator=g),
         torch.randn(32, 96, D, device=DEVICE, generator=g))
    y = torch.randint(0, N_CLASSES, (32,), device=DEVICE, generator=g)
    out = {}
    for heads in BF16_STEP_HEADS:
        dh = D // heads
        losses, grads = {}, {}
        for mode in ("kernels", "plain", "fp32") if heads == HEADS else ("kernels", "plain"):
            setup = train_setup(5, heads=heads, dtype=torch.float32 if mode == "fp32"
                                else torch.bfloat16)
            set_fast_dw(setup.model, mode == "kernels" and heads == HEADS)
            if mode == "plain":
                T.attention_qkv_packed = plain_packed
            try:
                with attention_launches() as seen, dw_shapes_seen() as shapes:
                    reset_counters()
                    logs = steps.train_step(setup.bundle, setup.optimizer, x, y,
                                            torch.Generator().manual_seed(3))
                    losses[mode] = float(logs["loss"])
                    torch.cuda.synchronize()
                    if mode == "kernels":
                        out[f"routes {heads} heads"] = check_bf16_launches(
                            seen, f"flava bf16 step ({heads} heads)")
                        check(A.attention_fwd_cuda.launches_by_dh == {dh: LAYERS}
                              and A.attention_bwd_cuda.launches_by_dh == {dh: LAYERS},
                              f"{heads} heads: launches {A.attention_fwd_cuda.launches_by_dh} "
                              f"{A.attention_bwd_cuda.launches_by_dh}")
                        out[f"fwd {heads} heads"] = out[f"bwd {heads} heads"] = LAYERS
                        fma = [r for r in out[f"routes {heads} heads"] if "attention_bwd_wide" in r]
                        check(not fma, f"{heads} heads: bf16 backward launches on the FMA "
                                       f"clusters: {fma}")
                        for direction, source, tc_sources, wrapper in (
                                ("fwd", A.fwd_source(torch.bfloat16, dh, False),
                                 A.TC_FWD_SOURCES, A.attention_fwd_cuda),
                                ("bwd", A.bwd_source(torch.bfloat16, dh, False),
                                 A.TC_BWD_SOURCES, A.attention_bwd_cuda)):
                            route = f"{direction} Dh={dh} {source}"
                            check(source in tc_sources
                                  and out[f"routes {heads} heads"].get(route) == LAYERS
                                  and wrapper.launches_tc == LAYERS,
                                  f"{heads} heads: launches {out[f'routes {heads} heads']}, "
                                  f"{direction} launches_tc {wrapper.launches_tc}, not {LAYERS} "
                                  f"on a tensor-core source")
                        if heads == HEADS:
                            routes = dw_routes(shapes, "flava bf16 step --fast_dw")
                            small = bf16_small_dw(shapes, set(), "flava bf16 step --fast_dw")
                            check(routes == {"tc32": 0, "simt": 0, "mma": small,
                                             "tc": dw_eligible(setup.model) - small},
                                  f"--bf16 --fast_dw dW launches {routes}")
                            out["dw"], out["dw_small"] = routes["tc"], routes["mma"]
                            out["dw_shapes"] = list(shapes)
            finally:
                T.attention_qkv_packed = A.attention_qkv_packed
            if mode != "fp32":
                grads[mode] = {n: p.grad.detach().clone()
                               for n, p in setup.model.named_parameters()}
            del setup
        out[f"grad_ratio {heads} heads"] = compare_bf16_grads(
            grads["kernels"], grads["plain"], f"flava bf16 step ({heads} heads), kernels"
            f"{' and --fast_dw' if heads == HEADS else ''} vs plain attention")
        rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
        print(f"flava bf16 step ({heads} heads, batch 32, S={IMG_PADDED + 96}): losses {losses}",
              flush=True)
        check(rel <= BF16_LOSS_RTOL, f"{heads} heads: bf16 kernel vs plain loss {rel} relative")
        if heads == HEADS:
            rel32 = abs(losses["kernels"] - losses["fp32"]) / abs(losses["fp32"])
            check(rel32 <= BF16_LOSS_RTOL, f"the bf16 first-step loss is {rel32} off the fp32 one")
            out["loss_rel_fp32"] = rel32
    out["dw_errs"] = compare_dw_at(out.pop("dw_shapes"), "flava bf16 step --fast_dw")
    return out


def train_mmbt_bf16_end_to_end(tmp: str) -> dict:
    """Phase 4g: ``train --framework mmbt --bf16`` on phase 4b's Food-101 tree
    under ``tmp/data`` (BERT-base + ResNet-152, batch 32, accumulation 4):
    one epoch (both encoders frozen, as in 4b's first), a resume, one epoch
    with ``--attention_probs_dropout 0.1``, then the one-micro-step checks
    (``mmbt_bf16_micro_step``). Returns the launches of the runs."""
    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    out = {}
    for name, extra in (("", ()), (" dropout", ("--attention_probs_dropout", str(MMBT_DROPOUT)))):
        run = os.path.join(tmp, f"run_bf16{name.replace(' ', '_')}")
        argv = mmbt_argv(run, "--n_epochs", "1", "--bf16", *extra)
        with attention_launches() as seen:
            reset_counters()
            t0 = time.perf_counter()
            train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            routes = check_bf16_launches(seen, f"mmbt training --bf16{name}")
            counts = [c.launches for c in COUNTERS[:4]]
            # K5: every forward and backward launch on the tensor cores at BERT-base's Dh 64
            for direction, sources, source, wrapper in (
                    ("fwd", A.TC_FWD_SOURCES, A.TC_FWD_SOURCE, A.attention_fwd_dropout_cuda),
                    ("bwd", A.TC_BWD_SOURCES, A.TC_BWD_SOURCE, A.attention_bwd_dropout_cuda)):
                drop = [e for e in seen if e[0] == direction and e[3]]
                drop_tc = sum(e[4] in sources for e in drop)
                check(drop_tc == wrapper.launches_tc and (MMBT_TINY or drop_tc == len(drop)),
                      f"mmbt --bf16{name}: {drop_tc} of {len(drop)} dropout {direction} launches "
                      f"on {source}, launches_tc {wrapper.launches_tc}")
        hist = load_history(run)
        train_loader, valid, _, fresh = mmbt_setup(argv)
        n_layers, n_micro = len(fresh.model.enc.encoder.layer), len(train_loader)
        n_eval = sum(-(-n // MMBT_TRAIN_BATCH) for _, n in MMBT_ROWS[1:])
        print(f"mmbt training --bf16{name}: 1 epoch, {n_micro} micro-steps in {wall:.3f} s; "
              "history " + json.dumps({k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc",
                                                            "time")})
              + f"; launches fwd, bwd, fwd_dropout, bwd_dropout {counts}", flush=True)
        check(len(hist["epoch"]) == 1 and all(np.isfinite(hist["loss"]))
              and all(np.isfinite(hist["val_loss"])), f"history.csv: {hist}")
        want = ([n_layers * (n_micro + n_eval), n_layers * n_micro, 0, 0] if not extra else
                [n_layers * n_eval, 0, n_layers * n_micro, n_layers * n_micro])
        check(counts == want, f"mmbt --bf16{name}: launches {counts}, expected {want}")
        checkpoint_dtypes(os.path.join(run, "model_last_epoch.pt"), f"mmbt training --bf16{name}")
        out[f"counts{name}"], out[f"routes{name}"] = counts, routes
        if not extra:  # resume into a fresh bf16 setup: the same val metrics
            resume_train_state(fresh.model, fresh.optimizer,
                               os.path.join(run, "model_last_epoch.pt"),
                               accumulator=fresh.accumulator, plateau=fresh.plateau)
            again = Trainer(fresh.bundle, fresh.optimizer, seed=MMBT_SEED,
                            verbose=False).eval_loop(valid, "val")
            d_loss, d_acc = abs(again["val_loss"] - hist["val_loss"][-1]), abs(
                again["val_acc"] - hist["val_acc"][-1])
            print(f"mmbt training --bf16: resume from model_last_epoch.pt: val_loss "
                  f"{again['val_loss']} (|diff| {d_loss:.3g}), val_acc {again['val_acc']} "
                  f"(|diff| {d_acc:.3g})", flush=True)
            check(d_loss <= 1e-6 * abs(hist["val_loss"][-1]) and d_acc <= 1e-6,
                  "the MMBT --bf16 resume does not reproduce the last val metrics")
        del fresh
    return {**out, **mmbt_bf16_micro_step()}


def mmbt_bf16_micro_step() -> dict:
    """Phase 4g's one-micro-step checks at full width (batch 32, S = 5 + 160,
    both encoders live), from one set of weights, batch and step seed: the
    bf16 micro-step with the kernels and ``--fast_dw`` (every dW launch on
    ``dw_kernel_tc``: 6 a BERT layer, the pooler at K = 32 on its strided
    x[:, 0] and the image embedding at K = 96) against the bf16 micro-step
    with the plain attention and autograd's dW (``compare_bf16_grads``), the
    loss within ``BF16_LOSS_RTOL`` of the fp32 micro-step's; BatchNorm's
    running statistics stay fp32 and finite."""
    from multimodal_uncertainty_tpu_torch.models import bert as B_
    from multimodal_uncertainty_tpu_torch.models.layers import set_fast_dw
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

    setup = setup_mmbt(n_classes=N_CLASSES, bert_config=MMBT_BERT, resnet_layers=MMBT_RESNET,
                       gradient_accumulation_steps=10**6, seed=0, dtype=torch.bfloat16,
                       device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(15)
    vocab = setup.model.config.vocab_size
    ones = torch.ones(32, 160, dtype=torch.int64, device=DEVICE)
    x = (torch.randint(104, vocab, (32, 160), device=DEVICE, generator=g), ones, ones,
         torch.randint(0, 256, (32, MMBT_IMG, MMBT_IMG, 3), device=DEVICE, generator=g,
                       dtype=torch.uint8))
    y = torch.randint(0, N_CLASSES, (32,), device=DEVICE, generator=g)
    losses, grads, out = {}, {}, {}
    for mode in ("kernels", "plain", "fp32"):  # accumulation never applies: the weights stay
        set_fast_dw(setup.model, mode == "kernels")
        setup.model.enc.dtype = setup.model.enc.img_encoder.dtype = (
            None if mode == "fp32" else torch.bfloat16)
        setup.accumulator.clear()
        if mode == "plain":
            B_.attention_heads_last = plain_heads_last
        try:
            with attention_launches() as seen, dw_shapes_seen() as shapes:
                reset_counters()
                logs = steps.train_step(setup.bundle, setup.optimizer, x, y,
                                        torch.Generator().manual_seed(4), flags=(False, False),
                                        accumulator=setup.accumulator)
                losses[mode] = float(logs["loss"]) * setup.accumulator.every
                torch.cuda.synchronize()
                if mode == "kernels":
                    out["step routes"] = check_bf16_launches(seen, "mmbt bf16 micro-step")
                    routes = dw_routes(shapes, "mmbt bf16 micro-step --fast_dw")
                    h = setup.model.config.hidden_size
                    small = bf16_small_dw(shapes, {(32, h, h, torch.bfloat16),
                                                   (32 * 3, 2048, h, torch.bfloat16)},
                                          "mmbt bf16 micro-step --fast_dw")
                    check(routes == {"tc32": 0, "simt": 0, "mma": small,
                                     "tc": dw_eligible(setup.model) - small},
                          f"mmbt --bf16 --fast_dw dW launches {routes}")
                    out["dw"], out["dw_small"] = routes["tc"], routes["mma"]
                    dw_shapes = list(shapes)
        finally:
            B_.attention_heads_last = A.attention_heads_last
        if mode != "fp32":
            grads[mode] = {n: t.detach().clone() for n, t in setup.accumulator.grads.items()}
    stats = [b for n, b in setup.model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    check(all(b.dtype == torch.float32 and bool(torch.isfinite(b).all()) for b in stats),
          "mmbt bf16: BatchNorm running statistics not finite fp32")
    out["grad_ratio"] = compare_bf16_grads(grads["kernels"], grads["plain"],
                                           "mmbt bf16 micro-step, kernels and --fast_dw vs plain")
    rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    rel32 = abs(losses["kernels"] - losses["fp32"]) / abs(losses["fp32"])
    print(f"mmbt bf16 micro-step (batch 32, S={MMBT_IMG_TOKENS + 160}): losses {losses}; "
          f"{len(stats)} BatchNorm statistics fp32 and finite", flush=True)
    check(rel <= BF16_LOSS_RTOL and rel32 <= BF16_LOSS_RTOL,
          f"mmbt bf16 micro-step loss {rel} off the plain one, {rel32} off the fp32 one")
    del setup
    out["dw_errs"] = compare_dw_at(dw_shapes, "mmbt bf16 micro-step --fast_dw")
    out["loss_rel_fp32"] = rel32
    return out


def vilt_train_step_throughput(iters: int = 5) -> dict:
    """The ViLT train micro-step (forward, backward, gradient accumulation) at
    batch 32, S = 40 + 145, on device-resident uint8 pixels, with autograd's dW
    and with ``--fast_dw``'s kernel, in turns (off, on, on, off): ms and
    samples/s (host clock, ending in a synchronise), then one profiled
    micro-step of each."""
    from multimodal_uncertainty_tpu_torch.models.layers import set_fast_dw
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_vilt

    setup = setup_vilt(n_classes=N_CLASSES, vilt_config=VILT_CFG,
                       gradient_accumulation_steps=10**6, seed=0, device=DEVICE)
    b, lt = VILT_TRAIN_BATCH, VILT_MAX_TEXT
    g = torch.Generator(device=DEVICE).manual_seed(7)
    x = {"input_ids": torch.randint(104, setup.model.config.vocab_size, (b, lt), device=DEVICE,
                                    generator=g),
         "attention_mask": torch.ones(b, lt, dtype=torch.int64, device=DEVICE),
         "token_type_ids": torch.zeros(b, lt, dtype=torch.int64, device=DEVICE),
         "pixel_values": torch.randint(0, 256, (b, VILT_IMG, VILT_IMG, 3), device=DEVICE,
                                       generator=g, dtype=torch.uint8),
         "pixel_mask": torch.ones(b, VILT_IMG, VILT_IMG, dtype=torch.int64, device=DEVICE)}
    y = torch.randint(0, N_CLASSES, (b,), device=DEVICE, generator=g)
    s = lt + 1 + (VILT_IMG // setup.model.config.patch_size) ** 2

    def step():
        return steps.train_step(setup.bundle, setup.optimizer, x, y,
                                torch.Generator().manual_seed(3), accumulator=setup.accumulator)

    times = {False: [], True: []}
    for fast in (False, True, True, False):
        set_fast_dw(setup.model, fast)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        times[fast].append((time.perf_counter() - t0) * 1e3 / iters)
    rows = {}
    for fast in (False, True):
        ms = sum(times[fast]) / len(times[fast])
        label = "--fast_dw" if fast else "autograd dW"
        print(f"vilt train micro-step ({label}): batch {b} (S={s}): {ms:.3f} ms "
              f"(runs {[round(t, 3) for t in times[fast]]}), {b * 1e3 / ms:.1f} samples/s",
              flush=True)
        set_fast_dw(setup.model, fast)
        prof = profile_device(step, 1, f"vilt train micro-step ({label}) batch {b} (S={s})")
        rows[fast] = {"S": s, "ms": ms, "samples_per_s": b * 1e3 / ms, **prof}
    return rows


def head_count_steps() -> dict:
    """Phase 4e: one FLAVA train step (batch ``STEP_BATCH``, S = 224 + 96) at
    each head count of ``STEP_HEADS`` (Dh 768, 384, 192, 48, 24), from the
    same weights, batch and step seed, with the kernels and with the plain
    attention on the card: exactly ``LAYERS`` forward and backward launches
    of the head dim's instances and none of another, and every parameter's
    gradient within ``DW_TOL`` x the leaf's max |gradient| of the plain
    step's (``compare_grads``). Returns the launches and worst ratios by
    head count."""
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training import steps

    g = torch.Generator(device=DEVICE).manual_seed(11)
    x = (torch.randn(STEP_BATCH, IMG_PADDED, D, device=DEVICE, generator=g),
         torch.randn(STEP_BATCH, 96, D, device=DEVICE, generator=g))
    y = torch.randint(0, N_CLASSES, (STEP_BATCH,), device=DEVICE, generator=g)
    out = {}
    for heads in STEP_HEADS:
        dh = D // heads
        grads, losses = [], []
        for plain in (False, True):
            setup = train_setup(5, heads=heads)
            setup.model.train()
            if plain:
                T.attention_qkv_packed = plain_packed
            try:
                reset_counters()
                logs = steps.train_step(setup.bundle, setup.optimizer, x, y,
                                        torch.Generator().manual_seed(3))
                losses.append(float(logs["loss"]))
                torch.cuda.synchronize()
            finally:
                T.attention_qkv_packed = A.attention_qkv_packed
            counts = (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches,
                      A.attention_fwd_cuda.launches_by_dh.get(dh, 0),
                      A.attention_bwd_cuda.launches_by_dh.get(dh, 0))
            want = (0, 0, 0, 0) if plain else (LAYERS,) * 4
            check(counts == want, f"{heads} heads ({'plain' if plain else 'kernels'}): launches "
                                  f"{counts} != {want} (total fwd, bwd; at Dh={dh} fwd, bwd)")
            check_fwd_routes(f"flava train step ({heads} heads)")
            grads.append({n: p.grad.detach().clone()
                          for n, p in setup.model.named_parameters() if p.grad is not None})
            del setup
        ratio = compare_grads(grads[0], grads[1], f"train step at {heads} heads (Dh={dh})",
                              what="kernels vs plain attention")
        rel = abs(losses[0] - losses[1]) / abs(losses[1])
        print(f"train step at {heads} heads (Dh={dh}), batch {STEP_BATCH}: launches fwd {LAYERS} "
              f"bwd {LAYERS} at Dh={dh}; loss {losses[0]} vs {losses[1]} plain, rel diff "
              f"{rel:.3g}", flush=True)
        check(rel <= 1e-5, f"{heads} heads: kernel vs plain loss differs by {rel} relative")
        out[heads] = {"dh": dh, "fwd": LAYERS, "bwd": LAYERS, "grad_ratio": ratio}
    return out


def sweep_end_to_end(tmp: str, run: str, heads: int, n_repeats: int) -> dict:
    """Phase 6: ``python -m multimodal_uncertainty_tpu_torch.
    eval_transformer_robustness`` (its ``main``) on ``run``'s best checkpoint
    over phase 4's dev split, at ``heads`` heads with ``n_repeats`` controls
    per modality (V = 3 + 2 x n_repeats): the predictions file is (S, V, E,
    C) float32 and the labels file (S,); the forward instance of D / heads
    ran exactly layers x chunks of 16 variants x batches times, and nothing
    else; the same sweep in-process with the plain attention on the card
    gives the same array within ``SWEEP_TOL`` x max(1, max|plain|). Prints
    the sweep's variant-samples/s (host clock around the sweep inside the
    CLI; its arrays end on the host)."""
    import types

    from multimodal_uncertainty_tpu_torch import eval_transformer_robustness as cli
    from multimodal_uncertainty_tpu_torch.data.flava_encoded import get_dataset_flava
    from multimodal_uncertainty_tpu_torch.evals import robustness_transformer as R
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into

    dh, v = D // heads, 3 + 2 * n_repeats
    ckpt = os.path.join(run, "model_best_val.pt")
    out_dir = os.path.join(tmp, f"sweep_{heads}_heads")
    seconds, real = {}, R.transformer_robustness_sweep

    def timing(*args, **kwargs):
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        seconds["sweep"] = time.perf_counter() - t0
        return result

    R.transformer_robustness_sweep = timing
    try:
        reset_counters()
        t0 = time.perf_counter()
        cli.main(["--save_path", out_dir, "--phase", "dev", "--batch_size", str(SWEEP_BATCH),
                  "--checkpoint_path", ckpt, "--model_type", "MIMO-shuffle-instance",
                  "--n_repeats", str(n_repeats), "--multimodal_num_attention_heads", str(heads),
                  "--multimodal_num_hidden_layers", str(LAYERS), "--dataset", "food101",
                  "--seed", str(TRAIN_SEED), "--device", DEVICE])
        wall = time.perf_counter() - t0
        fwd = A.attention_fwd_cuda.launches_by_dh.get(dh, 0)
        check(A.attention_fwd_cuda.launches == fwd and A.attention_bwd_cuda.launches == 0,
              f"the sweep launched other kernels: {A.attention_fwd_cuda.launches_by_dh} "
              f"{A.attention_bwd_cuda.launches_by_dh}")
        check_fwd_routes(f"flava sweep ({heads} heads)")
    finally:
        R.transformer_robustness_sweep = real
    n_dev = SPLITS[1][1]
    preds = np.load(os.path.join(out_dir, "robustness_model_best_val_predictions_dev.npy"))
    labels = np.load(os.path.join(out_dir, "robustness_model_best_val_labels_dev.npy"))
    check(preds.shape == (n_dev, v, 2, N_CLASSES) and preds.dtype == np.float32
          and labels.shape == (n_dev,), f"sweep files: {preds.shape} {preds.dtype} {labels.shape}")
    check(bool(np.isfinite(preds).all()), "sweep predictions not finite")
    batches, chunks = -(-n_dev // SWEEP_BATCH), -(-v // 16)
    check(fwd == LAYERS * chunks * batches,
          f"sweep launches {fwd} != {LAYERS} layers x {chunks} chunks x {batches} batches")

    setup = train_setup(5, heads=heads)
    restore_into(setup.model, load_weights(ckpt)[0])
    args = types.SimpleNamespace(batch_size=SWEEP_BATCH, seed=TRAIN_SEED, sample_size=None,
                                 n_workers=0)
    _, dev, _ = get_dataset_flava(args, os.path.join(tmp, "data", "food101"))
    T.attention_qkv_packed = plain_packed
    try:
        ref, ref_labels = real(setup.model, dev, n_repeats=n_repeats, seed=TRAIN_SEED)
    finally:
        T.attention_qkv_packed = A.attention_qkv_packed
    worst = float(np.abs(preds - ref).max())
    tol = SWEEP_TOL * max(1.0, float(np.abs(ref).max()))
    rate = n_dev * v / seconds["sweep"]
    print(f"sweep ({heads} heads, Dh={dh}): {n_dev} dev samples x {v} variants in "
          f"{seconds['sweep']:.3f} s ({rate:.1f} variant-samples/s; CLI wall {wall:.3f} s); "
          f"kernel launches {fwd} = {LAYERS} x {chunks} x {batches}; vs plain attention on the "
          f"card max abs diff {worst:.3g} (tol {tol:.3g})", flush=True)
    check(np.array_equal(labels, ref_labels), "sweep labels differ from the plain run's")
    check(worst <= tol, f"sweep differs from the plain attention by {worst} > {tol}")
    return {"fwd": fwd, "variant_samples_per_s": rate, "max_abs_diff": worst}


def write_fmnist(root: str) -> None:
    """FashionMNIST's idx-ubyte files at the dataset's own size
    (``FMNIST_SPLITS``) under ``root/FashionMNIST/raw``, in its format (28 x
    28 uint8 images, uint8 labels 0-9), drawn from ``FMNIST_SEED``: one
    smooth template a class, pixel noise of ``FMNIST_NOISE`` and a fifth of
    the labels redrawn at random, so the loss stays away from 0."""
    from multimodal_uncertainty_tpu_torch.data.fmnist import write_idx

    raw = os.path.join(root, "FashionMNIST", "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(FMNIST_SEED)
    yy, xx = np.meshgrid(np.arange(28), np.arange(28), indexing="ij")
    templates = np.stack([(np.sin(xx / 3.0 + c) + np.cos(yy / 2.0 + 2 * c)) * 0.25 + 0.5
                          for c in range(10)])
    for prefix, n in FMNIST_SPLITS:
        labels = rng.integers(0, 10, n)
        imgs = templates[labels] + rng.normal(0.0, FMNIST_NOISE, (n, 28, 28))
        labels = np.where(rng.random(n) < 0.2, rng.integers(0, 10, n), labels)
        write_idx(os.path.join(raw, f"{prefix}-images-idx3-ubyte"),
                  np.round(np.clip(imgs, 0.0, 1.0) * 255.0).astype(np.uint8))
        write_idx(os.path.join(raw, f"{prefix}-labels-idx1-ubyte"), labels.astype(np.uint8))


def fmnist_argv(run: str, *extra) -> list:
    """The FashionMNIST train CLI at the root's defaults (batch 32, lr 0.1,
    momentum 0.9, wd 1e-3) but ``FMNIST_EPOCHS``, MIMO-shuffle-instance and
    ``--ece``, on ``DEVICE``."""
    return ["--save_path", run, "--batch_size", str(FMNIST_BATCH), "--n_epochs",
            str(FMNIST_EPOCHS), "--model_type", "MIMO-shuffle-instance", "--ece",
            "--device", DEVICE, *extra]


def fmnist_tf_args(heads: int) -> list:
    return ["--transformer", "--lr", str(FMNIST_TF_LR), "--multimodal_num_attention_heads",
            str(heads), "--multimodal_num_hidden_layers", str(LAYERS)]


def fmnist_setup(argv: list):
    """``setup_fashionmnist`` as the train CLI builds it from ``argv``, and
    the train and eval loaders."""
    from multimodal_uncertainty_tpu_torch import train_fashionmnist as cli
    from multimodal_uncertainty_tpu_torch.data.fmnist import get_fmnist
    from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist

    args = cli.build_parser().parse_args(argv)
    train, valid, _ = get_fmnist(batch_size=args.batch_size, seed=args.seed,
                                 sample_size=args.sample_size)
    setup = setup_fashionmnist(
        model_type=args.model_type, transformer=args.transformer, lr=args.lr, wd=args.wd,
        momentum=args.momentum, warmup=args.warmup, total_steps=len(train) * args.n_epochs,
        multimodal_num_attention_heads=args.multimodal_num_attention_heads,
        multimodal_num_hidden_layers=args.multimodal_num_hidden_layers,
        diversity=args.diversity, diversity_coef=args.diversity_coef, seed=args.seed,
        device=DEVICE)
    return setup, train, valid, args


def fmnist_train_end_to_end(tmp: str, run_name: str, *extra, heads=None,
                            check_plain: bool = False, plain_steps=FMNIST_PLAIN_STEPS) -> dict:
    """Phase 4j: ``python -m multimodal_uncertainty_tpu_torch.train_fashionmnist``
    (its ``main``) in ``tmp/<run_name>`` on the idx files under ``tmp/fmnist``
    (written by the first call), with ``extra`` flags (``heads``: the MIMO
    transformer at that head count). ``--n_epochs 2`` trains one epoch:
    history.csv has one finite row, the checkpoints exist, a resume from
    model_last_epoch.pt reproduces val_loss and val_acc (1e-6); the
    transformer's attention launched exactly layers x (train steps + 2 x
    eval batches) forwards and layers x train steps backwards, all at Dh =
    768 / heads (the ResNet none). ``check_plain``: the first
    ``plain_steps`` steps of epoch 1 (None: all of them) rerun from the same
    weights, batches and permutations, with the kernels (the CLI's losses bit
    for bit) and with the plain attention on the card: the losses of the
    first ``FMNIST_PLAIN_STEPS`` within 1e-4 relative (the gap of the rest
    printed), parameters after them within 2 x the sum of the learning rates.
    Returns the launches, the epoch's wall (history's time: train, val and
    test), the train part's wall and samples/s."""
    from multimodal_uncertainty_tpu_torch import train_fashionmnist as cli
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.loop import load_history, resume_train_state
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    data = os.path.join(tmp, "fmnist")
    if not os.path.exists(data):
        t0 = time.perf_counter()
        write_fmnist(data)
        print(f"fmnist: idx files written in {time.perf_counter() - t0:.1f} s", flush=True)
    os.environ["DATA_DIR"] = data
    run = os.path.join(tmp, run_name)
    argv = fmnist_argv(run, *extra, *(fmnist_tf_args(heads) if heads else []))
    losses, marks = [], {}
    train_step, eval_loop = steps.train_step, Trainer.eval_loop

    def recording(bundle, optimizer, x, y, generator=None, **kwargs):
        marks.setdefault("train", time.perf_counter())
        logs = train_step(bundle, optimizer, x, y, generator, **kwargs)
        losses.append(logs["loss"])  # a device scalar, read after the run
        return logs

    def timed_eval(self, *args, **kwargs):
        marks.setdefault("eval", time.perf_counter())  # the train part's losses are read by now
        return eval_loop(self, *args, **kwargs)

    steps.train_step, Trainer.eval_loop = recording, timed_eval
    try:
        reset_counters()
        t0 = time.perf_counter()
        cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        steps.train_step, Trainer.eval_loop = train_step, eval_loop
    fwd, bwd = A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches
    losses = [float(v) for v in losses]
    setup, train_loader, valid, args = fmnist_setup(argv)
    hist = load_history(run)
    n_train, n_eval = len(train_loader), 2 * len(valid)  # val and test both read t10k
    samples = train_loader.n
    train_s = marks["eval"] - marks["train"]
    label = f"fmnist {run_name}"
    print(f"{label}: {len(hist['epoch'])} epoch of {n_train} steps at batch {FMNIST_BATCH} "
          f"({samples} samples), epoch wall {hist['time'][-1]:.3f} s (train part {train_s:.3f} "
          f"s, {samples / train_s:.1f} train samples/s), CLI wall {wall:.3f} s; history "
          + json.dumps({k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc", "val_ece")})
          + f"; attention launches fwd {fwd} bwd {bwd}", flush=True)
    check(len(hist["epoch"]) == FMNIST_EPOCHS - 1 and all(np.isfinite(hist["loss"])),
          f"{label}: history.csv {hist['epoch']} {hist['loss']} (n_epochs - 1 epochs)")
    for f in ("history.csv", "model_best_val.pt", "model_last_epoch.pt", "model_epoch_1.pt"):
        check(os.path.exists(os.path.join(run, f)), f"{label}: missing {f}")
    check(len(losses) == n_train, f"{label}: {len(losses)} train steps, expected {n_train}")
    if heads:
        dh = D // heads
        check((A.attention_fwd_cuda.launches_by_dh.get(dh, 0),
               A.attention_bwd_cuda.launches_by_dh.get(dh, 0)) == (fwd, bwd),
              f"{label}: launches at head dims other than {dh}: "
              f"{A.attention_fwd_cuda.launches_by_dh} {A.attention_bwd_cuda.launches_by_dh}")
        check(fwd == LAYERS * (n_train + n_eval) and bwd == LAYERS * n_train,
              f"{label}: launches fwd {fwd} bwd {bwd}, not {LAYERS} x ({n_train} + {n_eval}) and "
              f"{LAYERS} x {n_train}")
        check_fwd_routes(label)
    else:
        check(fwd == bwd == 0, f"{label}: the ResNet launched attention kernels ({fwd}, {bwd})")

    last = os.path.join(run, "model_last_epoch.pt")
    resume_train_state(setup.model, setup.optimizer, last, plateau=setup.plateau)
    again = Trainer(setup.bundle, setup.optimizer, seed=args.seed, verbose=False,
                    size_fn=setup.size_fn).eval_loop(valid, "val")
    d_loss = abs(again["val_loss"] - hist["val_loss"][-1])
    d_acc = abs(again["val_acc"] - hist["val_acc"][-1])
    print(f"{label}: resume from model_last_epoch.pt: val_loss |diff| {d_loss:.3g}, val_acc "
          f"|diff| {d_acc:.3g}", flush=True)
    check(d_loss <= 1e-6 * abs(hist["val_loss"][-1]) and d_acc <= 1e-6,
          f"{label}: resume does not reproduce the last val metrics")
    out = {"fwd": fwd, "bwd": bwd, "run": run, "wall_s": wall, "epoch_s": hist["time"][-1],
           "train_s": train_s, "samples_per_s": samples / train_s, "val_acc": hist["val_acc"][-1]}
    if not check_plain:
        return out

    # the first FMNIST_PLAIN_STEPS steps of epoch 1 again, in-process from fresh weights: with
    # the kernels (the CLI's losses, bit for bit) and with the plain attention
    runs = {}
    for name, attention in (("kernels", A.attention_qkv_packed), ("plain", plain_packed)):
        ref, _, _, _ = fmnist_setup(argv)
        gen = Trainer(ref.bundle, ref.optimizer, seed=args.seed, verbose=False).generator
        T.attention_qkv_packed = attention
        got = []
        try:
            for i, batch in zip(range(1, (plain_steps or n_train) + 1),
                                train_loader.iter_epoch(1)):
                x, y = steps.to_device(batch, DEVICE)
                got.append(steps.train_step(ref.bundle, ref.optimizer, x, y, gen(1, i))["loss"])
        finally:
            T.attention_qkv_packed = A.attention_qkv_packed
        runs[name] = ([float(v) for v in got], ref.model.state_dict())
    k = min(plain_steps or n_train, n_train)
    rels = [abs(a - b) / abs(b) for a, b in zip(losses[:k], runs["plain"][0])]
    same = runs["kernels"][0] == losses[:k]
    bound = 2 * sum(abs(ref.schedule(t)) for t in range(k))
    worst = max(float((p - runs["kernels"][1][n]).abs().max())
                for n, p in runs["plain"][1].items())
    print(f"{label}: kernel vs plain attention over the first {k} steps of epoch 1: losses max "
          f"rel diff {max(rels):.3g} (at step {int(np.argmax(rels)) + 1}; the running max at "
          + ", ".join(f"{n}: {max(rels[:n]):.3g}" for n in (10, 30, 100, 300, 1000, 1500)
                      if n < k)
          + f"); the in-process "
          f"kernel steps {'repeat' if same else 'do not repeat'} the CLI's losses; parameters "
          f"after them max |diff| {worst:.3g} (bound {bound:.3g})", flush=True)
    gated = min(k, FMNIST_PLAIN_STEPS)
    check(len(rels) == k and max(rels[:gated]) <= 1e-4,
          f"{label}: kernel vs plain training losses of the first {gated} steps differ by "
          f"{max(rels[:gated])} relative")
    check(same, f"{label}: the kernel steps rerun in-process differ from the CLI's")
    check(worst <= bound, f"{label}: kernel vs plain parameters differ by {worst} > {bound}")
    return {**out, "loss_rel": max(rels[:gated])}


def fmnist_step_profile(heads=None, iters: int = 20) -> dict:
    """One FashionMNIST train step (the ResNet, or the transformer at
    ``heads``; batch 32, MIMO-shuffle-instance) under ``torch.profiler``:
    its wall ms, device busy share and device ms by kind."""
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist

    setup = setup_fashionmnist(model_type="MIMO-shuffle-instance", transformer=bool(heads),
                               lr=FMNIST_TF_LR if heads else 0.1, total_steps=1000,
                               multimodal_num_attention_heads=heads or HEADS,
                               multimodal_num_hidden_layers=LAYERS, device=DEVICE)
    x = torch.rand(FMNIST_BATCH, 4, 1, 14, 14, device=DEVICE)
    y = torch.randint(0, 10, (FMNIST_BATCH,), device=DEVICE)
    gen = torch.Generator().manual_seed(0)

    def step():
        steps.train_step(setup.bundle, setup.optimizer, x, y, gen)

    for _ in range(3):
        step()
    model = f"transformer, {heads} heads" if heads else "ResNet"
    prof = profile_device(step, iters, f"fmnist train step ({model}, batch {FMNIST_BATCH})")
    return {"ms": prof["wall_ms"], "busy_ms": prof["busy_ms"], "by_kind": prof["by_kind"],
            "complete": prof["complete"], "samples_per_s": FMNIST_BATCH / prof["wall_ms"] * 1e3}


def fmnist_evals_end_to_end(tmp: str, run: dict, model_type: str, heads=None) -> dict:
    """Phase 6c: ``eval_robustness`` and ``eval_prediction_saving`` (their
    ``main``) on ``run``'s best checkpoint over the t10k split, batch 64:
    the sweep's (4, S, M, C) float32 predictions and its labels ((S,), or
    (3 S,) repeated under weight-sharing), the dump's (S, 4, C) and (S,)
    labels equal to the idx file's; the transformer's attention launched
    exactly layers x batches forwards a CLI (4 x 64 rows a launch), the
    ResNet none; the sweep in-process with the plain attention within
    ``SWEEP_TOL`` x max(1, max|plain|); the dump's ensemble accuracy within
    ``FMNIST_ACC_TOL`` points of history's val_acc; the round-1 analysis on
    both. Returns the launches and the sweep's variant-samples/s (host clock
    around the sweep inside the CLI; its arrays end on the host)."""
    from multimodal_uncertainty_tpu_torch import eval_prediction_saving, eval_robustness
    from multimodal_uncertainty_tpu_torch.analysis import round1
    from multimodal_uncertainty_tpu_torch.data.fmnist import _read_idx, get_fmnist
    from multimodal_uncertainty_tpu_torch.evals import robustness_fmnist as R
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights, restore_into
    from multimodal_uncertainty_tpu_torch.zoo import setup_fashionmnist

    ckpt = os.path.join(run["run"], "model_best_val.pt")
    out_dir = run["run"] + "_evals"
    argv = ["--checkpoint_path", ckpt, "--model_type", model_type, "--save_path", out_dir,
            "--batch_size", str(FMNIST_EVAL_BATCH), "--device", DEVICE]
    if heads:
        argv += ["--transformer", "--multimodal_num_attention_heads", str(heads),
                 "--multimodal_num_hidden_layers", str(LAYERS)]
    seconds, real = {}, R.missing_view_sweep

    def timing(*args, **kwargs):
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        seconds["sweep"] = time.perf_counter() - t0
        return result

    launches, returned = {}, {}
    R.missing_view_sweep = timing
    try:
        for name, cli in (("sweep", eval_robustness), ("dump", eval_prediction_saving)):
            reset_counters()
            returned[name] = cli.main(argv)
            launches[name] = (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches)
            if heads:
                check_fwd_routes(f"fmnist {name}")
    finally:
        R.missing_view_sweep = real
    raw = os.path.join(os.environ["DATA_DIR"], "FashionMNIST", "raw")
    truth = _read_idx(os.path.join(raw, "t10k-labels-idx1-ubyte")).astype(np.int64)
    n, ws = len(truth), model_type == "single-model-weight-sharing"
    m = 3 if ws else 4
    sweep = np.load(os.path.join(out_dir, "model_best_val_predictions_robustness.npy"))
    dump = np.load(os.path.join(out_dir, "model_best_val_predictions.npy"))
    labels = np.load(os.path.join(out_dir, "model_best_val_labels.npy"))  # the dump's, written last
    label = f"fmnist evals ({os.path.basename(run['run'])})"
    check(sweep.shape == (4, n, m, 10) and sweep.dtype == np.float32
          and dump.shape == (n, 4, 10) and dump.dtype == np.float32,
          f"{label}: files {sweep.shape} {sweep.dtype} {dump.shape} {dump.dtype}")
    check(bool(np.isfinite(sweep).all() and np.isfinite(dump).all()), f"{label}: not finite")
    check(np.array_equal(labels, truth), f"{label}: the dump's labels are not the t10k labels")
    check(np.array_equal(returned["sweep"][1], np.repeat(truth, 3) if ws else truth),
          f"{label}: the sweep's labels (repeated a kept view under weight-sharing)")
    batches = -(-n // FMNIST_EVAL_BATCH)
    want = (LAYERS * batches, 0) if heads else (0, 0)
    check(launches["sweep"] == want and launches["dump"] == want,
          f"{label}: attention launches {launches}, not {want} each")
    if heads:
        dh = D // heads
        check(A.attention_fwd_cuda.launches_by_dh.get(dh, 0) == want[0],
              f"{label}: launches at other head dims {A.attention_fwd_cuda.launches_by_dh}")
    worst = tol = 0.0
    if heads:  # the sweep again with the plain attention on the card
        setup = setup_fashionmnist(model_type=model_type, transformer=True,
                                   multimodal_num_attention_heads=heads,
                                   multimodal_num_hidden_layers=LAYERS, device=DEVICE)
        restore_into(setup.model, load_weights(ckpt)[0])
        _, valid, _ = get_fmnist(batch_size=FMNIST_EVAL_BATCH)
        T.attention_qkv_packed = plain_packed
        try:
            ref, ref_labels = real(setup.model, valid, model_type=model_type)
        finally:
            T.attention_qkv_packed = A.attention_qkv_packed
        worst = float(np.abs(sweep - ref).max())
        tol = SWEEP_TOL * max(1.0, float(np.abs(ref).max()))
        check(np.array_equal(ref_labels, truth), f"{label}: sweep labels")
        check(worst <= tol,
              f"{label}: the sweep differs from the plain attention by {worst} > {tol}")
    acc = round1.accuracy_breakdown(dump, labels)
    div, _ = round1.head_diversity(dump, labels)
    missing = round1.missing_view_accuracy(sweep, truth)  # the kept views' mean a sample
    rate = 4 * n / seconds["sweep"]
    print(f"{label}: sweep {sweep.shape} in {seconds['sweep']:.3f} s ({rate:.1f} "
          f"variant-samples/s), dump {dump.shape}; attention launches {launches}; vs plain "
          f"attention max abs diff {worst:.3g} (tol {tol:.3g}); round 1: accuracy "
          f"{json.dumps(acc)}, head diversity (Kendall tau) {div:.4f}, missing-view accuracy "
          f"{missing}", flush=True)
    # history's val_acc: the head mean's accuracy; weight-sharing's, each view's on its own
    dump_acc = 100 * (np.mean(acc["accuracy_viewwise"]) if ws else acc["accuracy_overall"])
    check(abs(dump_acc - run["val_acc"]) <= FMNIST_ACC_TOL,
          f"{label}: the dump's accuracy {dump_acc} is not history's val_acc {run['val_acc']}")
    check(all(0.0 <= a <= 1.0 for a in missing) and np.isfinite(div), f"{label}: round 1")
    return {"fwd": launches["sweep"][0] + launches["dump"][0], "variant_samples_per_s": rate,
            "max_abs_diff": worst}


def fmnist_end_to_end(tmp: str, t_start: float) -> dict:
    """Phases 4j and 6c in ``tmp``: the FashionMNIST train CLI for the MIMO
    ResNet, the transformer at ``FMNIST_HEADS`` (held to the plain attention)
    and at ``FMNIST_K6_HEADS``, and weight-sharing on a short run; then both
    eval CLIs on the ResNet's, the 3-head transformer's and weight-sharing's
    best checkpoints."""
    k6_flags = ["--sample_size", str(FMNIST_K6_SAMPLES)] if FMNIST_K6_SAMPLES else []
    runs = {"resnet": fmnist_train_end_to_end(tmp, "resnet"),
            "transformer": fmnist_train_end_to_end(tmp, "transformer", heads=FMNIST_HEADS,
                                                   check_plain=True),
            "transformer k6": fmnist_train_end_to_end(tmp, f"transformer_{FMNIST_K6_HEADS}_heads",
                                                      *k6_flags, heads=FMNIST_K6_HEADS),
            "weight-sharing": fmnist_train_end_to_end(
                tmp, "weight_sharing", "--model_type", "single-model-weight-sharing",
                "--sample_size", str(FMNIST_WS_SAMPLES))}
    t4 = time.perf_counter() - t_start
    print(f"phase 4j done at {t4:.1f} s", flush=True)
    evals = {"resnet": fmnist_evals_end_to_end(tmp, runs["resnet"], "MIMO-shuffle-instance"),
             "transformer": fmnist_evals_end_to_end(tmp, runs["transformer"],
                                                    "MIMO-shuffle-instance", FMNIST_HEADS),
             "weight-sharing": fmnist_evals_end_to_end(tmp, runs["weight-sharing"],
                                                       "single-model-weight-sharing")}
    t6 = time.perf_counter() - t_start
    print(f"phase 6c done at {t6:.1f} s", flush=True)
    return {"runs": runs, "evals": evals, "at": (t4, t6)}


def k4_mask(b: int, s: int) -> torch.Tensor:
    """Phase 7's key masks at long S: sample 0 has bench_flash's mask (its
    last fifth of keys masked), sample 1 keeps every key, sample 2 none (all
    its query rows are fully masked: the uniform average)."""
    m = torch.ones(b, s, dtype=torch.bool, device=DEVICE)
    m[0, (4 * s) // 5:] = False
    if b > 2:
        m[2] = False
    return m


def flash_gates(dtype, ref_max: dict) -> dict:
    """K4's gates on out and dq, dk, dv: fp32 1e-4 / 1e-4 x max(1, max|ref|)
    absolute. bf16 rounds relative to the magnitude, and at long S the
    softmax averages over thousands of keys, so |out| and the gradients sit
    near 0.1: the bf16 gates are 2e-2 / 3e-2 x max|ref| of each tensor (a
    floor at 1 would make them as large as the values)."""
    if dtype == torch.bfloat16:
        return {n: (TOL if n == "out" else BWD_TOL)[dtype] * m for n, m in ref_max.items()}
    return {n: (TOL if n == "out" else BWD_TOL)[dtype] * max(1.0, m) for n, m in ref_max.items()}


def compare_flash(dtype) -> dict:
    """K4: ``attention_flash`` forward and backward (the autograd Function, one
    launch each) at B=3, S=16384, 12 heads of 64, held against the plain
    versions one head at a time: heads are independent, so this is exact, and
    one head's (3, 1, S, S) fp32 logits take 3.2 GB where all twelve would
    take 39 GB. lse to 1e-4 / 2e-2 (fp32 / bf16), out, dq, dk, dv to
    ``flash_gates`` over all heads. Returns the max abs errors."""
    b, s, n_head, dh = 3, K4_S, K4_HEADS, K4_DH
    d = n_head * dh
    g = torch.Generator(device=DEVICE).manual_seed(16384)
    q, k, v, go = (torch.randn(b, s, d, device=DEVICE, generator=g).to(dtype) for _ in range(4))
    mask = k4_mask(b, s)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    tc32_0 = A.attention_fwd_cuda.launches_tc32
    out = A.attention_flash(*ins, mask, n_head=n_head)
    out.backward(go)
    lse = A.attention_flash_fwd(q, k, v, mask, n_head=n_head)[1]
    torch.cuda.synchronize()
    check_tc32_route(dtype, dh, A.attention_fwd_cuda.launches_tc32 - tc32_0, 2)
    check(out.dtype == dtype and out.shape == (b, s, d), "attention_flash output dtype/shape")
    check(all(bool(torch.isfinite(t.float()).all()) for t in (out, *(t.grad for t in ins))),
          "attention_flash output or gradient not finite")
    errs = dict.fromkeys(("out", "lse", "dq", "dk", "dv"), 0.0)
    ref_max = dict.fromkeys(("out", "dq", "dk", "dv"), 0.0)
    for h in range(n_head):
        cols = slice(h * dh, (h + 1) * dh)
        qh, kh, vh, gh = (t[..., cols].contiguous() for t in (q, k, v, go))
        ref, ref_lse = A.attention_fwd_plain(qh, kh, vh, mask, n_head=1)
        errs["out"] = max(errs["out"], max_err(out[..., cols], ref))
        errs["lse"] = max(errs["lse"], max_err(lse[:, h], ref_lse[:, 0]))
        ref_max["out"] = max(ref_max["out"], float(ref.float().abs().max()))
        del ref, ref_lse
        for name, t, r in zip(("dq", "dk", "dv"), ins,
                              A.attention_bwd_plain(qh, kh, vh, mask, gh, n_head=1)):
            errs[name] = max(errs[name], max_err(t.grad[..., cols], r))
            ref_max[name] = max(ref_max[name], float(r.float().abs().max()))
    tols = {"lse": TOL[dtype], **flash_gates(dtype, ref_max)}
    print(f"attention_flash-vs-plain B={b} S={s} H={n_head} Dh={dh} {str(dtype)[6:]}, per head: "
          + " ".join(f"{n} {errs[n]:.3g} (tol {tols[n]:.3g})" for n in errs), flush=True)
    for n in errs:
        check(errs[n] <= tols[n], f"attention_flash {n} disagrees with plain: {errs[n]} > {tols[n]}")
    return errs


def flash_bench() -> tuple:
    """K4's entry point as a user runs it: ``python -m
    multimodal_uncertainty_tpu_torch.tools.bench_flash`` (its ``main``) at
    its defaults, counted from 0. Every flash row must be a time, and the
    S=16384 row must show its kernels launched (one warm-up and
    ``--iters`` steps); returns the rows and the launches of the run."""
    from multimodal_uncertainty_tpu_torch.tools import bench_flash

    reset_counters()
    rows = bench_flash.main(["--iters", str(FLASH_ITERS)])
    launches = {"attention_fwd": A.attention_fwd_cuda.launches_by_dh.get(K4_DH, 0),
                "attention_bwd": A.attention_bwd_cuda.launches_by_dh.get(K4_DH, 0)}
    check(A.attention_fwd_cuda.launches + A.attention_bwd_cuda.launches == sum(launches.values()),
          f"bench_flash launched instances other than Dh={K4_DH}")
    check([r["S"] for r in rows][-1] == K4_S, "bench_flash has no S=16384 row")
    for r in rows:
        for label in ("flash_fwd", "flash_train"):
            check(isinstance(r[label], dict) and r[label]["ms"] > 0,
                  f"bench_flash S={r['S']} {label}: {r[label]}")
        check(r["flash_fwd"]["launches"] == {"attention_fwd_cuda": FLASH_ITERS + 1,
                                             "attention_bwd_cuda": 0}
              and r["flash_train"]["launches"] == {"attention_fwd_cuda": FLASH_ITERS + 1,
                                                   "attention_bwd_cuda": FLASH_ITERS + 1},
              f"bench_flash S={r['S']}: launches {r['flash_fwd']['launches']}, "
              f"{r['flash_train']['launches']}")
    check(launches["attention_fwd"] == 2 * (FLASH_ITERS + 1) * len(rows)
          and launches["attention_bwd"] == (FLASH_ITERS + 1) * len(rows),
          f"bench_flash launches {launches}")
    check(A.attention_bwd_cuda.launches_tc == launches["attention_bwd"],
          f"bench_flash: {A.attention_bwd_cuda.launches_tc} of {launches['attention_bwd']} bf16 "
          f"backward launches at Dh={K4_DH} took the tensor-core route")
    check(A.attention_fwd_cuda.launches_tc == launches["attention_fwd"],
          f"bench_flash: {A.attention_fwd_cuda.launches_tc} of {launches['attention_fwd']} bf16 "
          f"forward launches at Dh={K4_DH} took the tensor-core route")
    print(f"bench_flash: {len(rows)} rows, launches {launches} (on the tensor cores: forward "
          f"{A.attention_fwd_cuda.launches_tc}, backward {A.attention_bwd_cuda.launches_tc})",
          flush=True)
    return rows, launches


def time_flash(dtype) -> tuple:
    """K4 at bench_flash's S=16384 row (B=1, 12 heads of 64, its mask): the
    forward and backward kernels, the plain versions one head at a time (all
    twelve heads at once would need ~60 GB of (S, S) planes in the backward),
    ``scaled_dot_product_attention`` and its backward, and the bounds: 4 B S^2
    D and 10 B S^2 D operations at the card's rate for the input type (the
    tensor cores' for bf16), or the bytes."""
    b, s, n_head, dh = 1, K4_S, K4_HEADS, K4_DH
    d = n_head * dh
    g = torch.Generator(device=DEVICE).manual_seed(1)
    q, k, v, go = (torch.randn(b, s, d, device=DEVICE, generator=g).to(dtype) for _ in range(4))
    mask = k4_mask(b, s)
    out, lse = A.attention_fwd_cuda(q, k, v, mask, n_head=n_head)
    bias = torch.zeros(b, 1, 1, s, device=DEVICE, dtype=dtype).masked_fill(
        ~mask[:, None, None, :], A.NEG_INF)

    def heads(t):
        return t.reshape(b, s, n_head, dh).transpose(1, 2).detach().requires_grad_()

    hq, hk, hv = heads(q), heads(k), heads(v)
    vq, vk, vv = (t.reshape(b, s, n_head, dh).transpose(1, 2) for t in (q, k, v))
    lib_g = go.reshape(b, s, n_head, dh).transpose(1, 2)
    per_head = [tuple(t[..., h * dh:(h + 1) * dh].contiguous() for t in (q, k, v, go))
                for h in range(n_head)]

    def plain_fwd():
        for qh, kh, vh, _ in per_head:
            A.attention_fwd_plain(qh, kh, vh, mask, n_head=1)

    def plain_bwd():
        for qh, kh, vh, gh in per_head:
            A.attention_bwd_plain(qh, kh, vh, mask, gh, n_head=1)

    lib_out = torch.nn.functional.scaled_dot_product_attention(hq, hk, hv, attn_mask=bias)
    isz = q.element_size()
    rows = {}
    for name, flops, nbytes, kernel, plain, library in (
        ("fwd", 4 * b * s * s * d, 4 * b * s * d * isz + b * s + b * n_head * s * 4,
         lambda: A.attention_fwd_cuda(q, k, v, mask, n_head=n_head), plain_fwd,
         lambda: torch.nn.functional.scaled_dot_product_attention(vq, vk, vv, attn_mask=bias)),
        ("bwd", 10 * b * s * s * d, 8 * b * s * d * isz + b * n_head * s * 4 + b * s,
         lambda: A.attention_bwd_cuda(q, k, v, mask, out, lse, go, n_head=n_head), plain_bwd,
         lambda: torch.autograd.grad(lib_out, (hq, hk, hv), lib_g, retain_graph=True)),
    ):
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        bounds = ({"bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes"} if name == "bwd"
                  else fwd_bounds(flops, nbytes, dtype, dh))
        rows[name] = {"B": b, "S": s, "Dh": dh, "dtype": str(dtype)[6:],
                      "ms": cuda_ms(kernel, K4_TIME_ITERS),
                      "plain_ms": cuda_ms(plain, K4_TIME_ITERS),
                      "library_ms": cuda_ms(library, K4_TIME_ITERS), **bounds}
        print(f"time attention_flash {name} " + json.dumps(rows[name]), flush=True)
    return rows["fwd"], rows["bwd"]


def compare_layer_norm(shape, eps, mean, dtype) -> float:
    """K7: the LayerNorm kernel against the plain version on the same inputs
    (weights near 1, biases near 0); returns the max abs error. fp32: 1e-5 x
    max(1, max|ref|), sums in another order; bf16: one rounding step of the
    largest output, 2^-7 x max(1, max|ref|)."""
    g = torch.Generator(device=DEVICE).manual_seed(shape[-1])
    x = (mean + torch.randn(*shape, device=DEVICE, generator=g)).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[-1], device=DEVICE, generator=g)
    b = 0.1 * torch.randn(shape[-1], device=DEVICE, generator=g)
    with torch.no_grad():
        y = N.layer_norm_cuda(x, w, b, eps)
    ref = N.layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    err, tol = max_err(y, ref), LN_TOL[dtype] * scale
    print(f"layer_norm-vs-plain {shape} eps {eps:g} mean {mean:g} {str(dtype)[6:]}: {err:.3g} "
          f"(tol {tol:.3g})", flush=True)
    check(y.dtype == dtype and y.shape == x.shape, "layer_norm output dtype/shape")
    check(bool(torch.isfinite(y.float()).all()), "layer_norm output not finite")
    check(err <= tol, f"layer_norm kernel disagrees with plain: {err} > {tol}")
    return err


def layer_norm_predictor() -> int:
    """K7 on a serving path: the full-width FLAVA predictor (3 layers, 3
    heads) with every ``LayerNormFP32`` set to ``impl="kernel"``, against
    the same predictor with the default, on one uncertainty batch (32
    samples, S = 224 + 96: three forwards). The probabilities and
    diagnostics agree within 1e-4, and the kernel ran exactly (2 + 2 x
    layers) x 3 times, counted from 0, every time on a ``LN_PATH_SHAPE``
    input (the shape K7 is compared and timed at); returns that count."""
    from multimodal_uncertainty_tpu_torch.models.layers import LayerNormFP32
    from multimodal_uncertainty_tpu_torch.serving import FusionPredictor
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    rng = np.random.default_rng(7)
    img = rng.normal(size=(32, IMG_TOKENS, D)).astype(np.float32)
    txt = rng.normal(size=(32, 77, D)).astype(np.float32)
    lengths = rng.integers(5, 78, size=32)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_best_val.pt")
        save_weights(build_flava("MIMO-shuffle-instance", n_classes=N_CLASSES, heads=HEADS,
                                 layers=LAYERS, device="cpu",
                                 generator=torch.Generator().manual_seed(3)), None, ckpt)
        preds = [FusionPredictor(build_flava("MIMO-shuffle-instance", n_classes=N_CLASSES,
                                             heads=HEADS, layers=LAYERS, device="cpu"),
                                 ckpt, device=DEVICE) for _ in range(2)]
    norms = [m for m in preds[1].model.modules() if isinstance(m, LayerNormFP32)]
    seen = []
    hooks = [m.register_forward_pre_hook(lambda _, args: seen.append(tuple(args[0].shape)))
             for m in norms]
    for m in norms:
        m.impl = "kernel"
    ref, ref_diag = preds[0].predict_with_uncertainty(img, txt, txt_lengths=lengths)
    reset_counters()
    got, diag = preds[1].predict_with_uncertainty(img, txt, txt_lengths=lengths)
    launches = N.layer_norm_cuda.launches
    for h in hooks:
        h.remove()
    worst = max(float(np.abs(got - ref).max()),
                *(float(np.abs(diag[k] - ref_diag[k]).max()) for k in ref_diag))
    print(f"flava predictor, LayerNormFP32 impl=kernel ({len(norms)} LayerNorms): "
          f"{launches} layer_norm launches, answers vs the default max abs diff {worst:.3g}",
          flush=True)
    check(len(norms) == 2 + 2 * LAYERS, f"{len(norms)} LayerNormFP32 in the fusion model")
    check(launches == 3 * len(norms), f"layer_norm launches {launches} != 3 x {len(norms)}")
    check(set(seen) == {LN_PATH_SHAPE}, f"LayerNorm inputs {set(seen)}, not {LN_PATH_SHAPE}")
    check(bool(np.isfinite(got).all()) and got.shape == (32, N_CLASSES), "predictor output")
    check(worst <= 1e-4, f"the kernel LayerNorm's answers differ from the default by {worst}")
    return launches


def time_layer_norm(rows: int, dtype) -> dict:
    """K7 at ``rows`` rows of 768: the kernel, the plain version,
    ``F.layer_norm`` (its weights cast to x's dtype, a yardstick), and the
    bound: x read once and y written once (and w, b) at 3.35 TB/s."""
    d = D
    g = torch.Generator(device=DEVICE).manual_seed(2)
    x = torch.randn(rows, d, device=DEVICE, generator=g).to(dtype)
    w = 1 + 0.1 * torch.randn(d, device=DEVICE, generator=g)
    b = 0.1 * torch.randn(d, device=DEVICE, generator=g)
    wl, bl = w.to(dtype), b.to(dtype)
    nbytes = 2 * rows * d * x.element_size() + 2 * d * 4
    flops = 8 * rows * d
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32] * 1e3, nbytes / PEAK_BYTES * 1e3
    with torch.no_grad():
        row = {"rows": rows, "D": d, "dtype": str(dtype)[6:],
               "ms": cuda_ms(lambda: N.layer_norm_cuda(x, w, b)),
               "plain_ms": cuda_ms(lambda: N.layer_norm(x, w, b)),
               "library_ms": cuda_ms(lambda: torch.nn.functional.layer_norm(x, (d,), wl, bl)),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    print("time layer_norm " + json.dumps(row), flush=True)
    return row


def dw_bench() -> tuple:
    """K8b: ``python -m multimodal_uncertainty_tpu_torch.tools.bench_dw`` (its
    ``main``) at its shape (K = 70144, 768 x 3072, bf16), counted from 0:
    every row a time, and the kernel row ran the dW kernel once for its
    warm-up and once a call. Returns the rows and the dW launches."""
    from multimodal_uncertainty_tpu_torch.tools import bench_dw

    reset_counters()
    rows = bench_dw.main(["--iters", str(DW_BENCH_ITERS)])
    launches = DW.dw_cuda.launches
    check(list(rows) == ["fwd_ref", "plain", "plain_pre_t", "kernel"]
          and all(r["ms"] > 0 for r in rows.values()), f"bench_dw rows {rows}")
    check(launches == DW_BENCH_ITERS + 1, f"bench_dw: {launches} dW launches")
    check(DW.dw_cuda.launches_tc == launches,
          f"bench_dw: {DW.dw_cuda.launches_tc} of {launches} dW launches on the tensor-core kernel")
    return rows, launches


def timed_step(run) -> dict:
    """``run()`` once, on the host clock around a synchronise: its ms and the
    peak of the memory allocated on the card during it (GiB, and above what
    was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"ms": (time.perf_counter() - t0) * 1e3, "peak_gib": peak / 2 ** 30,
            "peak_above_gib": (peak - before) / 2 ** 30}


def compare_remat(remat: dict, plain: dict, dtype, label: str) -> float:
    """Gradients of a step with remat against the same step's without, leaf
    by leaf within ``REMAT_GRAD_TOL`` x max(1, max|ref|); returns the largest
    |diff|."""
    check(set(remat) == set(plain) and plain, f"{label}: gradient leaves differ")
    worst = 0.0
    for name, ref in plain.items():
        err = max_err(remat[name], ref)
        check(err <= REMAT_GRAD_TOL[dtype] * max(1.0, float(ref.abs().max())),
              f"{label}: gradient of {name} differs by {err} with remat")
        worst = max(worst, err)
    return worst


def flava_remat_steps() -> dict:
    """Phase 4k, ``--remat`` on FLAVA at full width (768 wide, 3 layers of 3
    heads, Dh 256) on one batch of 128 at S = 224 + 512, in fp32 and bf16:
    one train step with remat against one without, from the same weights,
    batch and step seed: the loss within ``REMAT_LOSS_RTOL``, every gradient
    within ``REMAT_GRAD_TOL``, the attention forward launched 2 x the step's
    without remat (the backward's recompute) and the backward as often; then
    a second step of each timed, with its peak memory."""
    from multimodal_uncertainty_tpu_torch.training import steps

    g = torch.Generator(device=DEVICE).manual_seed(16)
    x = (torch.randn(REMAT_BATCH, IMG_PADDED, D, device=DEVICE, generator=g),
         torch.randn(REMAT_BATCH, LONG_TEXT, D, device=DEVICE, generator=g))
    y = torch.randint(0, N_CLASSES, (REMAT_BATCH,), device=DEVICE, generator=g)
    dh, out = D // HEADS, {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for remat in (False, True):
            setup = train_setup(5, dtype=dtype, remat=remat)

            def step():
                return steps.train_step(setup.bundle, setup.optimizer, x, y,
                                        torch.Generator().manual_seed(3))

            reset_counters()
            loss = float(step()["loss"])
            torch.cuda.synchronize()
            launches = (A.attention_fwd_cuda.launches_by_dh.get(dh, 0),
                        A.attention_bwd_cuda.launches_by_dh.get(dh, 0))
            check(launches == (A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches),
                  f"flava remat step: launches at head dims other than {dh}")
            grads = {n: p.grad.detach().float().clone() for n, p in setup.model.named_parameters()}
            runs[remat] = {"loss": loss, "launches": launches, "grads": grads, **timed_step(step)}
            del setup
        label = f"flava {str(dtype)[6:]} train step --remat (batch {REMAT_BATCH}, S={IMG_PADDED + LONG_TEXT})"
        plain, rem = runs[False], runs[True]
        rel = abs(rem["loss"] - plain["loss"]) / abs(plain["loss"])
        worst = compare_remat(rem.pop("grads"), plain.pop("grads"), dtype, label)
        print(f"{label}: loss {rem['loss']} vs {plain['loss']} without (rel {rel:.3g}); "
              f"gradients max |diff| {worst:.3g}; launches fwd, bwd {rem['launches']} vs "
              f"{plain['launches']}; step {rem['ms']:.3f} ms vs {plain['ms']:.3f}, peak memory "
              f"{rem['peak_gib']:.3f} GiB ({rem['peak_above_gib']:.3f} above the step's start) vs "
              f"{plain['peak_gib']:.3f} ({plain['peak_above_gib']:.3f})", flush=True)
        check(rel <= REMAT_LOSS_RTOL, f"{label}: loss {rel} relative off the step without remat")
        check(rem["launches"] == (2 * plain["launches"][0], plain["launches"][1])
              and plain["launches"] == (LAYERS, LAYERS),
              f"{label}: launches {rem['launches']}, not twice the forward of {plain['launches']}")
        out[dtype] = {"remat": rem, "plain": plain, "loss_rel": rel, "grad_err": worst}
    return out


def mmbt_remat_micro_step() -> dict:
    """Phase 4k, ``--remat`` on MMBT at full width (BERT-base + ResNet-152 at
    224) with attention-probability dropout ``MMBT_DROPOUT`` (K5), one
    micro-step at batch 32, S = 5 + 512, both encoders live, with remat and
    without, from the same weights, batch and step seed: the loss and the
    gradients under ``flava_remat_steps``' gates, the BatchNorm running
    statistics after it identical, K5's forward launched 2 x and its backward
    1 x; a second micro-step of each timed, with its peak memory."""
    import dataclasses

    from multimodal_uncertainty_tpu_torch.models.bert import BertConfig
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.zoo import setup_mmbt

    cfg = dataclasses.replace(MMBT_BERT or BertConfig.base(),
                              attention_probs_dropout_prob=MMBT_DROPOUT)
    g = torch.Generator(device=DEVICE).manual_seed(17)
    ones = torch.ones(32, MMBT_REMAT_TEXT, dtype=torch.int64, device=DEVICE)
    x = (torch.randint(104, cfg.vocab_size, (32, MMBT_REMAT_TEXT), device=DEVICE, generator=g),
         ones, ones, torch.randint(0, 256, (32, MMBT_IMG, MMBT_IMG, 3), device=DEVICE,
                                   generator=g, dtype=torch.uint8))
    y = torch.randint(0, N_CLASSES, (32,), device=DEVICE, generator=g)
    runs = {}
    for remat in (False, True):
        setup = setup_mmbt(n_classes=N_CLASSES, bert_config=cfg, resnet_layers=MMBT_RESNET,
                           gradient_accumulation_steps=MMBT_REMAT_ACCUM, seed=MMBT_SEED,
                           remat=remat, device=DEVICE)

        def step():
            return steps.train_step(setup.bundle, setup.optimizer, x, y,
                                    torch.Generator().manual_seed(4), flags=(False, False),
                                    accumulator=setup.accumulator)

        reset_counters()
        loss = float(step()["loss"]) * MMBT_REMAT_ACCUM
        torch.cuda.synchronize()
        launches = (A.attention_fwd_dropout_cuda.launches, A.attention_bwd_dropout_cuda.launches,
                    A.attention_fwd_cuda.launches, A.attention_bwd_cuda.launches)
        grads = {n: t * MMBT_REMAT_ACCUM for n, t in setup.accumulator.grads.items()}
        stats = {n: b.clone() for n, b in setup.model.named_buffers() if "running" in n}
        runs[remat] = {"loss": loss, "launches": launches, "grads": grads, "stats": stats,
                       **timed_step(step)}
        del setup
    label = f"mmbt micro-step --remat (batch 32, S={MMBT_IMG_TOKENS + MMBT_REMAT_TEXT}, K5)"
    plain, rem = runs[False], runs[True]
    rel = abs(rem["loss"] - plain["loss"]) / abs(plain["loss"])
    worst = compare_remat(rem.pop("grads"), plain.pop("grads"), torch.float32, label)
    moved = [n for n in plain["stats"] if not torch.equal(rem["stats"][n], plain["stats"][n])]
    n_stats = len(plain["stats"])
    rem.pop("stats"), plain.pop("stats")
    layers = (MMBT_BERT or BertConfig.base()).num_hidden_layers
    print(f"{label}: loss {rem['loss']} vs {plain['loss']} without (rel {rel:.3g}); gradients "
          f"max |diff| {worst:.3g}; {n_stats} BatchNorm statistics, {len(moved)} differ; "
          f"launches K5 fwd, K5 bwd, K2 fwd, K2 bwd {rem['launches']} vs {plain['launches']}; "
          f"micro-step {rem['ms']:.3f} ms vs {plain['ms']:.3f}, peak memory {rem['peak_gib']:.3f} "
          f"GiB ({rem['peak_above_gib']:.3f} above the step's start) vs {plain['peak_gib']:.3f} "
          f"({plain['peak_above_gib']:.3f})", flush=True)
    check(rel <= REMAT_LOSS_RTOL, f"{label}: loss {rel} relative off the step without remat")
    check(not moved, f"{label}: BatchNorm statistics differ with remat: {moved[:5]}")
    check(plain["launches"] == (layers, layers, 0, 0)
          and rem["launches"] == (2 * layers, layers, 0, 0),
          f"{label}: launches {rem['launches']} against {plain['launches']} without remat")
    return {"remat": rem, "plain": plain, "loss_rel": rel, "grad_err": worst}


def flava_argv(run: str, *extra) -> list:
    """The FLAVA train CLI as phase 4 runs it (3 heads, batch ``TRAIN_BATCH``,
    ``TRAIN_EPOCHS``, on phase 4's shards), with ``extra`` flags after."""
    return ["--framework", "flava", "--save_path", run, "--dataset", "food101",
            "--model_type", "MIMO-shuffle-instance", "--batch_size", str(TRAIN_BATCH),
            "--multimodal_num_attention_heads", str(HEADS),
            "--multimodal_num_hidden_layers", str(LAYERS), "--lr", str(TRAIN_LR),
            "--n_epochs", str(TRAIN_EPOCHS), "--seed", str(TRAIN_SEED), "--device", DEVICE,
            *extra]


def flava_diversity_end_to_end(tmp: str) -> dict:
    """Phase 4k, ``--diversity guided`` and ``random`` through FLAVA's train
    CLI (its ``main``), one epoch at batch ``DIVERSITY_BATCH`` on phase 4's
    shards under ``tmp/data``: history finite, K1 launches exact; the epoch's
    steps rerun in-process from the same weights, batches and step seeds
    with the plain attention: losses within 1e-4 relative; the first step's
    loss without the term differs (the term is in the loss)."""
    import dataclasses

    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.models import transformer as T
    from multimodal_uncertainty_tpu_torch.training import steps
    from multimodal_uncertainty_tpu_torch.training.loop import load_history
    from multimodal_uncertainty_tpu_torch.training.trainer import Trainer

    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    out = {"fwd": 0, "bwd": 0}
    dh = D // HEADS
    for kind in DIVERSITY_KINDS:
        run = os.path.join(tmp, f"diversity_{kind}")
        argv = flava_argv(run, "--batch_size", str(DIVERSITY_BATCH), "--n_epochs", "1",
                          "--diversity", kind)
        losses, train_step = [], steps.train_step

        def recording(*args, **kwargs):
            logs = train_step(*args, **kwargs)
            losses.append(logs["loss"])
            return logs

        steps.train_step = recording
        try:
            reset_counters()
            with no_checkpoint_files():
                train.main(argv)
        finally:
            steps.train_step = train_step
        fwd, bwd = (A.attention_fwd_cuda.launches_by_dh.get(dh, 0),
                    A.attention_bwd_cuda.launches_by_dh.get(dh, 0))
        out["fwd"], out["bwd"] = out["fwd"] + fwd, out["bwd"] + bwd
        losses = [float(v) for v in losses]
        hist = load_history(run)
        n_train = SPLITS[0][1] // DIVERSITY_BATCH
        n_eval = sum(-(-n // DIVERSITY_BATCH) for _, n, _ in SPLITS[1:])
        check(hist["epoch"] == [1] and all(np.isfinite(hist["loss"])) and len(losses) == n_train,
              f"diversity {kind}: history {hist['epoch']} {hist['loss']}, {len(losses)} steps")
        check((fwd, bwd) == (LAYERS * (n_train + n_eval), LAYERS * n_train),
              f"diversity {kind}: launches fwd {fwd} bwd {bwd}")
        args = train.add_conditional_args(train.build_parser().parse_args(argv))
        rerun = {}
        for mode, n_steps in (("plain", n_train), ("no term", 1)):
            loader, _, _, ref = train._flava_setup(args, resolve_device(DEVICE))
            if mode == "no term":
                ref.bundle = dataclasses.replace(ref.bundle, diversity_kind="none")
            gen = Trainer(ref.bundle, ref.optimizer, seed=args.seed, verbose=False).generator
            T.attention_qkv_packed = plain_packed if mode == "plain" else A.attention_qkv_packed
            try:
                rerun[mode] = [float(steps.train_step(ref.bundle, ref.optimizer,
                                                      *steps.to_device(batch, DEVICE),
                                                      gen(1, i))["loss"])
                               for i, batch in zip(range(1, n_steps + 1), loader.iter_epoch(1))]
            finally:
                T.attention_qkv_packed = A.attention_qkv_packed
        plain, first = rerun["plain"], {"no term": rerun["no term"][0]}
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
        print(f"diversity {kind} (flava train CLI, batch {DIVERSITY_BATCH}, {n_train} steps): "
              f"losses {losses}; against the plain attention max rel diff {rel:.3g}; the first "
              f"step's loss without the term {first['no term']} (with it {losses[0]}); launches "
              f"fwd {fwd} bwd {bwd}; history " + json.dumps(
                  {k: hist[k] for k in ("loss", "acc", "val_loss", "val_acc")}), flush=True)
        check(rel <= 1e-4, f"diversity {kind}: kernel vs plain losses differ by {rel} relative")
        check(first["no term"] != losses[0], f"diversity {kind}: the term changed no loss")
        out[kind] = rel
    return out


def kernel_events(events) -> int:
    """The hand-written kernels' events among a trace's device events (the
    names ``profile_device`` counts)."""
    return sum(e.get("cat") == "kernel"
               and any(k in e.get("name", "") for k in ("attention_fwd_", "attention_bwd_",
                                                         "dw_kernel", "ln_rows_kernel"))
               for e in events)


def expected_events(before: list, after: list) -> int:
    """Kernel events the launch counters' change from ``before`` to ``after``
    (``counter_state``) stands for."""
    return (sum(n * (a - b) for a, b, n in zip(after[:-1], before[:-1], KERNELS_PER_LAUNCH))
            + after[-1] - before[-1])


def counter_state() -> list:
    """The launch counters, and last the packing launches of the tensor-core
    dropout kernels."""
    return [c.launches for c in COUNTERS] + [A.attention_fwd_dropout_cuda.launches_tc
                                             + A.attention_bwd_dropout_cuda.launches_tc]


def final_gap(run_a: str, run_b: str, wa: dict, wb: dict) -> tuple:
    """(max |a - b| over the final weights ``wa`` and ``wb``, over
    history.csv's values but the times) of two runs."""
    from multimodal_uncertainty_tpu_torch.training.loop import load_history

    check(set(wa) == set(wb), "final weights' keys differ")
    weights = max(max_err(wa[k].cpu(), wb[k].cpu()) for k in wa if wa[k].is_floating_point())
    ha, hb = load_history(run_a), load_history(run_b)
    check(list(ha) == list(hb) and ha["epoch"] == hb["epoch"],
          f"history.csv differs: {ha['epoch']} {hb['epoch']}")
    hist = max(abs(float(a) - float(b)) for k in ha if "time" not in k
               for a, b in zip(ha[k], hb[k]))
    return weights, hist


def preemption_end_to_end(tmp: str) -> dict:
    """Phase 4k, preemption, ``--profile_dir`` and ``out.log`` on FLAVA's
    train CLI (phase 4's shards under ``tmp/data``, batch 128, 2 epochs,
    ``--checkpoint_every_steps 3``): run A in-process with ``--profile_dir``
    on epoch 2, run B in-process (the yardstick: A's and B's final weights
    and history, bit for bit or their largest gap), both without epoch
    checkpoint files (``no_checkpoint_files``: the disk's writes), no thread
    of theirs left (the prefetcher's stopped); run C as a subprocess, SIGTERMed once its
    ``model_midtrain.pt`` is first being written in epoch 1: it exits 0 with
    the file, whose ``mid`` blob names where it stopped; ``--resume`` in a
    second subprocess exits 0 and ends no further from A than B is. A's
    trace is read by ``utils/traces.py`` (busy ms, the train step's device
    ms) and holds as many hand-written kernel events as the launch counters
    moved over its epoch, after a record of the trainer's primer; A's out.log
    holds both epochs' progress lines, C's the preemption's too."""
    import signal

    from multimodal_uncertainty_tpu_torch import train
    from multimodal_uncertainty_tpu_torch.training import trainer as TR
    from multimodal_uncertainty_tpu_torch.training.checkpoint import load_weights
    from multimodal_uncertainty_tpu_torch.training.loop import load_history
    from multimodal_uncertainty_tpu_torch.utils import traces

    os.environ["DATA_DIR"] = os.path.join(tmp, "data")
    runs = {k: os.path.join(tmp, f"preempt_{k}") for k in "abc"}
    every = ("--checkpoint_every_steps", str(PREEMPT_EVERY))
    prof_dir = os.path.join(tmp, "trace")
    marks, real_start, real_stop = {}, TR.start_profile, TR.stop_profile

    def start(device):
        marks["before"] = counter_state()
        return real_start(device)

    def stop(prof, device, path):
        real_stop(prof, device, path)
        marks["after"] = counter_state()

    threads = set(threading.enumerate())
    reset_counters()
    TR.start_profile, TR.stop_profile = start, stop
    try:
        t0 = time.perf_counter()
        with no_checkpoint_files():
            weights = {"a": train.main(flava_argv(runs["a"], *every, "--profile_dir", prof_dir,
                                                  "--profile_epoch", "2")).bundle.model}
        wall_a = time.perf_counter() - t0
    finally:
        TR.start_profile, TR.stop_profile = real_start, real_stop
    t0 = time.perf_counter()
    with no_checkpoint_files():
        weights["b"] = train.main(flava_argv(runs["b"], *every)).bundle.model
    wall_b = time.perf_counter() - t0
    weights = {k: {n: t.detach().cpu() for n, t in m.state_dict().items()}
               for k, m in weights.items()}
    launches = (A.attention_fwd_cuda.launches_by_dh.get(D // HEADS, 0),
                A.attention_bwd_cuda.launches_by_dh.get(D // HEADS, 0))
    left = [t.name for t in threading.enumerate() if t not in threads and t.is_alive()
            and not t.name.startswith("checkpoint-writer")]
    check(not left, f"preemption: threads left by the train CLI: {left}")

    # the runs below are processes of their own: hand back the card memory this one caches
    # (the earlier phases' blocks), or they run out of it
    gc.collect()
    torch.cuda.empty_cache()
    print(f"preemption: this process holds {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB on "
          f"the card ({torch.cuda.memory_allocated() / 2 ** 30:.3f} allocated) before its "
          f"subprocesses", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    cmd = [sys.executable, "-m", "multimodal_uncertainty_tpu_torch.train"]
    mid_path = os.path.join(runs["c"], "model_midtrain.pt")
    with open(os.path.join(tmp, "preempted.log"), "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd + flava_argv(runs["c"], *every), env=env, stdout=log,
                                stderr=subprocess.STDOUT, cwd=root)
        try:
            while proc.poll() is None and not (os.path.exists(mid_path)
                                               or os.path.exists(mid_path + ".tmp")):
                check(time.perf_counter() - t0 < PREEMPT_TIMEOUT, "preemption: no midtrain file")
                time.sleep(0.005)
            signalled = proc.poll() is None
            if signalled:
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=PREEMPT_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall_c = time.perf_counter() - t0
    tail = open(os.path.join(tmp, "preempted.log")).read().replace("\r", "\n")[-3000:]
    check(rc == 0 and signalled and os.path.exists(mid_path),
          f"preemption: the SIGTERMed run exited {rc} (signalled {signalled}, midtrain "
          f"{os.path.exists(mid_path)}): {tail}")
    mid = load_weights(mid_path)[1]["mid"]
    stopped = (int(mid["epoch"]), int(mid["next_batch"]))
    rows = len(load_history(runs["c"])["epoch"]) if os.path.exists(
        os.path.join(runs["c"], "history.csv")) else 0
    t0 = time.perf_counter()
    resumed = subprocess.run(cmd + flava_argv(runs["c"], *every, "--resume"), env=env, cwd=root,
                             capture_output=True, text=True, timeout=PREEMPT_TIMEOUT)
    wall_resume = time.perf_counter() - t0
    check(resumed.returncode == 0,
          f"preemption: the resumed run exited {resumed.returncode}: {resumed.stderr[-3000:]}")
    check(not os.path.exists(mid_path), "preemption: the finished run left model_midtrain.pt")
    weights["c"] = load_weights(os.path.join(runs["c"], "model_last_epoch.pt"))[0]
    yard = final_gap(runs["a"], runs["b"], weights["a"], weights["b"])
    got = final_gap(runs["a"], runs["c"], weights["a"], weights["c"])
    print(f"preemption (flava train CLI, batch {TRAIN_BATCH}, {TRAIN_EPOCHS} epochs, "
          f"--checkpoint_every_steps {PREEMPT_EVERY}): SIGTERM once model_midtrain.pt was being "
          f"written; stopped at (epoch, next batch) {stopped} with {rows} history rows, exit "
          f"{rc}; resumed, exit {resumed.returncode}; final weights / history max |diff| against "
          f"the uninterrupted run A: resumed {got[0]:.3g} / {got[1]:.3g}, a second uninterrupted "
          f"run {yard[0]:.3g} / {yard[1]:.3g}; walls A {wall_a:.1f} s (profiled), B "
          f"{wall_b:.1f} s, preempted process {wall_c:.1f} s, resumed process "
          f"{wall_resume:.1f} s", flush=True)
    check(got[0] <= yard[0] and got[1] <= yard[1],
          f"preemption: the resumed run is further from A ({got}) than B is ({yard})")
    check(stopped[0] < TRAIN_EPOCHS or stopped[1] < SPLITS[0][1] // TRAIN_BATCH,
          f"preemption: stopped at {stopped}")

    # the profiled epoch of run A: the trace against the launch counters
    trace = os.path.join(prof_dir, "epoch_2.pt.trace.json.gz")
    check(os.path.exists(trace) and "before" in marks and "after" in marks,
          f"profile: no trace of epoch 2 under {prof_dir}")
    events, pid_names = traces.load_events(prof_dir)
    dev = traces.device_pids(pid_names, events)
    busy = traces.device_busy_ms(prof_dir)
    step = traces.step_program(traces.program_times(events, dev))
    want = expected_events(marks["before"], marks["after"])
    found = kernel_events(e for e in events if e["pid"] in dev)
    primed = primer_records(e["name"] for e in events
                            if e["pid"] in dev and e.get("cat") in traces.DEVICE_CATS)
    cats = {k: round(us / 1e3, 3) for k, (us, _) in traces.category_times(events, dev).items()}
    print(f"profile (--profile_dir, epoch 2 of run A): {os.path.getsize(trace)} bytes, "
          f"{len(events)} events; device busy {busy:.3f} ms; device ms by category {cats}; "
          f"train step {step}; hand-written kernel events {found}, launch counters' change "
          f"{want}; {primed} of the primer's {TR.PROFILE_PRIMER} records", flush=True)
    check(busy > 0 and step is not None, "profile: no device time or train_step range in it")
    check(found == want and want > 0,
          f"profile: {found} hand-written kernel events against {want} launches counted")
    check(primed > 0, "profile: the trace holds none of the primer's records")
    for name, want_lines in (("a", ("Epoch 1/2", "Epoch 2/2")),
                             ("c", ("Preempted at epoch", "Epoch 2/2"))):
        text = open(os.path.join(runs[name], "out.log")).read()
        check(all(w in text for w in want_lines) and "\r" not in text,
              f"out.log of run {name} lacks {want_lines} or holds repaints")
    return {"stopped": stopped, "gap": got, "yardstick": yard, "busy_ms": busy,
            "kernel_events": found, "primer_records": primed, "fwd": launches[0],
            "bwd": launches[1]}


# ---------------------------------------------------------------------------
# phase 3e: int8 serving, model-code-free artifacts, temperature fitting
# ---------------------------------------------------------------------------


def cli_serve(argv: list) -> dict:
    """Run the predict CLI's ``main`` until it would serve forever: -> its
    server (``srv``), micro-batcher (``mb``) and, for a checkpoint, the
    predictor it built (``pred``)."""
    from multimodal_uncertainty_tpu_torch import predict

    got = {}
    real_serve, real_forever = predict._serve, predict._serve_forever

    def serve(args, pred):
        got["pred"] = pred
        real_serve(args, pred)

    predict._serve, predict._serve_forever = serve, lambda srv, mb: got.update(srv=srv, mb=mb)
    try:
        predict.main(argv)
    finally:
        predict._serve, predict._serve_forever = real_serve, real_forever
    return got


def quant_family_specs(tmp: str) -> dict:
    """Phase 3e's families at full width from seeded random weights: the
    checkpoint, the predict CLI's flags for it, request bodies, and how to
    tell a request's sample inside a coalesced batch (its id)."""
    from multimodal_uncertainty_tpu_torch.training.checkpoint import save_weights
    from multimodal_uncertainty_tpu_torch.zoo import build_flava

    rng = np.random.default_rng(31)
    specs = {}
    for heads in (HEADS, K6_HEADS):
        ckpt = os.path.join(tmp, f"flava_{heads}.pt")
        save_weights(build_flava("MIMO-shuffle-instance", N_CLASSES, heads=heads, layers=LAYERS,
                                 device="cpu", generator=torch.Generator().manual_seed(heads)),
                     None, ckpt)
        lengths = [int(x) for x in rng.integers(5, 97, size=QUANT_REQUESTS - 1)] + [LONG_TEXT]
        samples = []
        for i, lt in enumerate(lengths):
            img = rng.normal(size=(IMG_TOKENS, D)).astype(np.float32)
            img[0, 0] = i
            samples.append((img, rng.normal(size=(lt, D)).astype(np.float32)))
        specs[f"flava {heads} heads"] = {
            "ckpt": ckpt, "dh": D // heads, "forwards": 3, "txt_len": 96,
            "layers": lambda p: len(p.model.mm_encoder.resblocks),
            "argv": ["--checkpoint_path", ckpt, "--n_classes", str(N_CLASSES), "--model_type",
                     "MIMO-shuffle-instance", "--multimodal_num_hidden_layers", str(LAYERS),
                     "--multimodal_num_attention_heads", str(heads), "--batch_size", "32",
                     "--uncertainty"],
            "bodies": [json.dumps({"img": a.tolist(), "txt": b.tolist()}).encode()
                       for a, b in samples],
            "samples": samples, "id": lambda s: int(s[0][0, 0]), "len": lambda s: len(s[1])}
    ckpt = os.path.join(tmp, "mmbt.pt")
    save_weights(mmbt_model(0, "cpu"), None, ckpt)
    lengths = [int(x) for x in rng.integers(MMBT_TEXT[0], MMBT_TEXT[1] + 1,
                                            size=QUANT_REQUESTS - 1)] + [MMBT_LONG_TEXT]
    samples = []
    for i, lt in enumerate(lengths):
        img = np.round(rng.normal(size=(MMBT_IMG, MMBT_IMG, 3)), 3).astype(np.float32)
        img[0, 0, 0] = i
        samples.append((rng.integers(0, MMBT_VOCAB, size=lt), np.zeros(lt, np.int64), img))
    specs["mmbt"] = {
        "ckpt": ckpt, "dh": MMBT_DH, "forwards": 1, "txt_len": MMBT_TEXT[1],
        "layers": lambda p: len(p.model.enc.encoder.layer),
        "argv": ["--framework", "mmbt", "--checkpoint_path", ckpt, "--n_classes", str(N_CLASSES)]
        + (["--tiny"] if MMBT_TINY else []),
        "bodies": [json.dumps({"token_ids": t.tolist(), "segment": s.tolist(),
                               "image": im.tolist()}).encode() for t, s, im in samples],
        "samples": samples, "id": lambda s: int(s[2][0, 0, 0]), "len": lambda s: len(s[0])}
    ckpt = os.path.join(tmp, "vilt.pt")
    save_weights(vilt_model(0, "cpu"), None, ckpt)
    samples = []
    for i, lt in enumerate(int(x) for x in rng.integers(VILT_MIN_TEXT, VILT_MAX_TEXT + 1,
                                                        size=QUANT_REQUESTS)):
        img = np.round(rng.normal(size=(VILT_IMG, VILT_IMG, 3)), 2).astype(np.float32)
        img[0, 0, 0] = i
        s = {"input_ids": np.asarray([101] + rng.integers(104, 30522, size=lt - 1).tolist()),
             "attention_mask": np.ones(lt, np.int64), "token_type_ids": np.zeros(lt, np.int64),
             "pixel_values": img}
        if i % 4 == 1:
            s["pixel_mask"] = rect_mask(256, 320)
        samples.append(s)
    specs["vilt"] = {
        "ckpt": ckpt, "dh": VILT_DH, "forwards": 1, "txt_len": VILT_MAX_TEXT,
        "layers": lambda p: len(p.model.vilt.block),
        "argv": ["--framework", "vilt", "--checkpoint_path", ckpt, "--n_classes", str(N_CLASSES)]
        + (["--tiny"] if VILT_TINY else []),
        "bodies": [json.dumps({k: v.tolist() for k, v in s.items()}).encode() for s in samples],
        "samples": samples, "id": lambda s: int(s["pixel_values"][0, 0, 0]),
        "len": lambda s: len(s["input_ids"])}
    return specs


def http_round(port: int, bodies: list, clients: int = 8) -> dict:
    """POST every body to the server on ``port`` from ``clients`` threads: ->
    {index: (status, answer)}."""
    answers = {}

    def client(idx):
        for i in idx:
            answers[i] = post(port, bodies[i])

    threads = [threading.Thread(target=client, args=(range(t, len(bodies), clients),))
               for t in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(len(answers) == len(bodies), f"{len(answers)} of {len(bodies)} requests answered")
    return answers


def probs_of(result) -> np.ndarray:
    return np.asarray(result[0] if isinstance(result, tuple) else result)


def quantized_serving(name: str, spec: dict) -> dict:
    """One family of phase 3e: the predict CLI served fp32, ``--quantize int8``
    and ``int8_weight`` from one checkpoint. Each quantized server answers the
    requests over HTTP (8 clients); its coalesced batches are replayed through
    the fp32 server's batcher. Gates: the answers within ``QUANT_TOL`` of the
    fp32 ones (max |dp|) with argmax agreement at least 2/3 (the JAX test's
    bounds); one int8 product a quantized Linear call under int8, none under
    int8_weight; the attention launches equal to the fp32 replay's (layers x
    forwards x batches, every fp32 launch at Dh 24-192 on the split-fp32
    route); one Linear's int8 product on its served activations equal on the
    card to the CPU's exact int32 product, its rescaled output within 1e-6
    relative."""
    from multimodal_uncertainty_tpu_torch.models.layers import Linear
    from multimodal_uncertainty_tpu_torch.ops import quant as Q

    t0 = time.perf_counter()
    fp32 = cli_serve(spec["argv"] + ["--serve", "0", "--device", DEVICE])
    fp32["srv"].close()
    out = {"launches": 0, "build_s": [time.perf_counter() - t0]}
    for mode in ("int8", "int8_weight"):
        t0 = time.perf_counter()
        got = cli_serve(spec["argv"] + ["--serve", "0", "--device", DEVICE, "--quantize", mode])
        out["build_s"].append(time.perf_counter() - t0)
        srv, mb, pred = got["srv"], got["mb"], got["pred"]
        batches, run_batch = [], mb.predict_batch

        def recording(samples, _run=run_batch, _seen=batches):
            _seen.append(list(samples))
            return _run(samples)

        mb.predict_batch = recording
        linears = [m for m in pred.model.modules() if isinstance(m, Linear)]
        calls, seen = [0], {}
        hooks = [m.register_forward_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
                 for m in linears]
        probe = linears[len(linears) // 2]

        def keep_first(module, args, _seen=seen):
            if "x" not in _seen:
                _seen["x"] = args[0].detach().clone()

        hooks.append(probe.register_forward_pre_hook(keep_first))
        try:
            reset_counters()
            Q.int8_mm_cuda.launches = 0
            t0 = time.perf_counter()
            answers = http_round(srv.port, spec["bodies"])
            wall = time.perf_counter() - t0
            launches, int8 = A.attention_fwd_cuda.launches, Q.int8_mm_cuda.launches
            check_fwd_routes(f"{name} --quantize {mode}")
        finally:
            for h in hooks:
                h.remove()
            srv.close()
            mb.close()
        check(int8 == (calls[0] if mode == "int8" else 0),
              f"{name} {mode}: {int8} int8 products for {calls[0]} quantized Linear calls")
        want = spec["layers"](pred) * spec["forwards"] * len(batches)
        check(launches == want and A.attention_fwd_cuda.launches_by_dh.get(spec["dh"], 0) == want,
              f"{name} {mode}: attention launches {A.attention_fwd_cuda.launches_by_dh}, not "
              f"{want} at Dh {spec['dh']}")
        reset_counters()
        reference = {}
        for bt in batches:
            for smp, res in zip(bt, fp32["mb"].predict_batch(bt)):
                reference[spec["id"](smp)] = res
        check(A.attention_fwd_cuda.launches == launches,
              f"{name} {mode}: {launches} attention launches, the fp32 replay "
              f"{A.attention_fwd_cuda.launches}")
        worst, agree = 0.0, []
        for i, (status, ans) in answers.items():
            check(status == 200, f"{name} {mode} request {i}: HTTP {status}")
            p, ref = np.asarray(ans["probs"]), probs_of(reference[i])
            check(p.shape == (N_CLASSES,) and bool(np.isfinite(p).all())
                  and abs(p.sum() - 1.0) < 1e-4, f"{name} {mode} request {i}: probs")
            worst = max(worst, float(np.abs(p - ref).max()))
            agree.append(int(p.argmax()) == int(ref.argmax()))
        check(worst < QUANT_TOL[mode] and np.mean(agree) >= 2 / 3,
              f"{name} {mode}: max |dp| {worst} (tol {QUANT_TOL[mode]}), argmax agreement "
              f"{np.mean(agree)}")
        exact = rel = None
        if mode == "int8":  # the probe Linear's product on its served activation
            x = seen["x"]
            xq, xs = Q.activation_int8(x)
            a = xq.reshape(-1, xq.shape[-1])
            exact = bool(torch.equal(Q.int8_mm(a, probe.weight_q.t()).cpu(),
                                     Q.int8_mm_plain(a.cpu(), probe.weight_q.cpu().t())))
            y = Q.int8_dot_q(x, probe.weight_q, probe.weight_scale).cpu()
            y_cpu = Q.int8_dot_q(x.cpu(), probe.weight_q.cpu(), probe.weight_scale.cpu())
            rel = float((y - y_cpu).abs().max() / y_cpu.abs().max().clamp(min=1e-30))
            check(exact and rel <= 1e-6, f"{name}: the int8 product on the card against the "
                  f"CPU's: equal {exact}, rescaled rel {rel}")
        print(f"phase 3e {name} --quantize {mode}: {len(answers)} requests in {wall:.3f} s over "
              f"{len(batches)} batches {[len(bt) for bt in batches]} (the CLI built the "
              f"predictor in {out['build_s'][-1]:.1f} s); attention launches "
              f"{launches} (fp32 replay the same); int8 products {int8} for {calls[0]} Linear "
              f"calls; vs fp32 max |dp| {worst:.4g}, argmax agreement {np.mean(agree):.3f}; "
              f"probe {tuple(x.shape) if mode == 'int8' else ''} exact {exact}, rel {rel}",
              flush=True)
        out[mode] = {"pred": pred, "wall": wall, "max_dp": worst, "agree": float(np.mean(agree)),
                     "int8": int8, "linear_calls": calls[0], "launches": launches}
        out["launches"] += launches
    fp32["mb"].close()
    out["fp32"] = fp32["pred"]
    return out


_ARTIFACT_SERVER = r"""
import json, sys
from multimodal_uncertainty_tpu_torch import predict
from multimodal_uncertainty_tpu_torch.ops import attention as A
from multimodal_uncertainty_tpu_torch.ops import quant as Q


def hold(srv, mb):
    print(json.dumps({"port": srv.port}), flush=True)
    sys.stdin.readline()
    srv.close()
    mb.close()
    print(json.dumps({"modules": sorted(m for m in sys.modules
                                        if m.startswith("multimodal_uncertainty_tpu")),
                      "attention_fwd": A.attention_fwd_cuda.launches,
                      "by_dh": A.attention_fwd_cuda.launches_by_dh,
                      "int8": Q.int8_mm_cuda.launches}), flush=True)


predict._serve_forever = hold
predict.main(sys.argv[1:])
"""


def artifacts_end_to_end(tmp: str, specs: dict, served: dict) -> dict:
    """Phase 3e's artifacts: each family exported on the card through the
    predict CLI (FLAVA at a symbolic batch; MMBT with its ablation keep mask),
    FLAVA again with symbolic lengths and from the CPU; each served over HTTP
    by ``predict --artifact DIR --serve 0`` in a subprocess of its own (all
    started together), one request a batch from one client. Gates: no module
    of ``models/``, ``zoo`` or ``serving`` in the subprocess; answers within
    1e-5 of the live fp32 predictor's on the same requests, one at a time,
    with and without ``--uncertainty``; the subprocess's attention launches
    equal to the live predictor's; a tampered ``program.pt2`` refused."""
    from multimodal_uncertainty_tpu_torch import export as E
    from multimodal_uncertainty_tpu_torch import predict
    from multimodal_uncertainty_tpu_torch.serving import (
        fusion_micro_batcher,
        mmbt_micro_batcher,
        vilt_micro_batcher,
    )

    flava = specs[f"flava {HEADS} heads"]
    t0 = time.perf_counter()
    arts = {"flava": (flava, ["--uncertainty"]), "flava lengths": (flava, []),
            "flava from cpu": (flava, []), "mmbt": (specs["mmbt"], ["--uncertainty"]),
            "vilt": (specs["vilt"], [])}
    dirs = {k: os.path.join(tmp, k.replace(" ", "_")) for k in arts}
    exported = {}
    for key, extra in (("flava", []), ("flava from cpu", ["--device", "cpu"]),
                       ("mmbt", ["--export_ablations", "--export_txt_len",
                                 str(specs["mmbt"]["txt_len"])]),
                       ("vilt", [])):
        t1 = time.perf_counter()
        predict.main(arts[key][0]["argv"] + ["--device", DEVICE] + extra + ["--export", dirs[key]])
        exported[key] = time.perf_counter() - t1
    t1 = time.perf_counter()
    E.export_fusion_predictor(served[f"flava {HEADS} heads"]["fp32"], dirs["flava lengths"],
                              img_len=IMG_PADDED, txt_len=96, symbolic_lengths=True)
    exported["flava lengths"] = time.perf_counter() - t1
    sizes = {k: os.path.getsize(os.path.join(d, E.PROGRAM_FILE)) / 2 ** 20 for k, d in dirs.items()}
    print(f"phase 3e artifacts written in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {exported[k]:.1f} s, {sizes[k]:.1f} MiB" for k in arts), flush=True)

    # a tampered program is refused before it is deserialised
    bad = os.path.join(tmp, "tampered")
    shutil.copytree(dirs["vilt"], bad)
    program = os.path.join(bad, E.PROGRAM_FILE)
    with open(program, "r+b") as f:
        f.seek(os.path.getsize(program) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        E.load_exported(bad, device=DEVICE)
        refused = False
    except ValueError as exc:
        refused = "integrity check failed" in str(exc)
    check(refused, "a tampered program.pt2 was not refused")
    shutil.rmtree(bad)

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-c", _ARTIFACT_SERVER, "--artifact", dirs[k],
                                  "--serve", "0", "--device", DEVICE, *arts[k][1]],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                                 cwd=root, env=env) for k in arts}
    batchers = {"flava": fusion_micro_batcher, "mmbt": mmbt_micro_batcher,
                "vilt": vilt_micro_batcher}
    out = {"launches": {}}
    try:
        for key, proc in procs.items():
            spec, extra = arts[key]
            family = key.split()[0]
            port = json.loads(proc.stdout.readline())["port"]
            ready = time.perf_counter() - t0
            uncertainty = "--uncertainty" in extra
            live = batchers[family](served[[k for k in specs if k.startswith(family)][0]]["fp32"],
                                    uncertainty=uncertainty)
            bodies, samples = spec["bodies"], spec["samples"]
            # the longest texts the artifact takes (its baked length refuses longer ones)
            fits = [i for i, s in enumerate(samples)
                    if key == "flava lengths" or spec["len"](s) <= spec["txt_len"]]
            keep = sorted(fits, key=lambda i: -spec["len"](samples[i]))[:ARTIFACT_REQUESTS]
            bodies, samples = [bodies[i] for i in keep], [samples[i] for i in keep]
            worst, t1 = 0.0, time.perf_counter()
            answers = [post(port, b) for b in bodies]
            wall = time.perf_counter() - t1
            reset_counters()
            for smp, (status, ans) in zip(samples, answers):
                check(status == 200, f"artifact {key}: HTTP {status}")
                (ref,) = live.predict_batch([smp])
                worst = max(worst, float(np.abs(np.asarray(ans["probs"]) - probs_of(ref)).max()),
                            *((abs(ans[k] - float(v)) for k, v in ref[1].items())
                              if uncertainty else ()))
            live_launches = A.attention_fwd_cuda.launches
            live.close()
            proc.stdin.write("report\n")
            proc.stdin.flush()
            report = json.loads(proc.stdout.readline())
            check(proc.wait(timeout=120) == 0, f"artifact {key}: the server exited with an error")
            model_code = [m for m in report["modules"] if any(
                m.startswith(f"multimodal_uncertainty_tpu_torch.{p}")
                for p in ("models", "zoo", "serving"))]
            check(not model_code, f"artifact {key}: the server imported {model_code}")
            check(report["attention_fwd"] == live_launches,
                  f"artifact {key}: {report['attention_fwd']} attention launches, the live "
                  f"predictor {live_launches}")
            check(worst <= 1e-5, f"artifact {key}: answers differ from the live predictor's by "
                  f"{worst}")
            print(f"phase 3e artifact {key}: serving {ready:.1f} s after the start; "
                  f"{len(bodies)} requests one at a time in {wall:.3f} s; "
                  f"attention launches {report['attention_fwd']} ({report['by_dh']}), live "
                  f"{live_launches}; vs live max abs diff {worst:.3g}; the server imported "
                  f"{len(report['modules'])} modules of the package, none of models / zoo / "
                  f"serving", flush=True)
            out["launches"][key] = (spec["dh"], report["attention_fwd"])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["dirs"] = dirs
    return out


def served_samples_per_s(fn, n: int, iters: int = 3) -> float:
    """Samples/s of ``fn()`` at batch ``n`` (host clock, each call ending in a
    copy to the host), after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return iters * n / (time.perf_counter() - t0)


def phase_3e_timings(specs: dict, served: dict, dirs: dict) -> dict:
    """Served samples/s at batch 32 of each family, fp32, int8, int8_weight and
    from its artifact (FLAVA at S = 224 + 96, MMBT at 5 + 160, ViLT at 40 +
    145), then the two bench tools at their defaults."""
    from multimodal_uncertainty_tpu_torch import export as E
    from multimodal_uncertainty_tpu_torch.tools import bench_export, bench_quant

    rng = np.random.default_rng(32)
    n = 32
    img = rng.normal(size=(n, IMG_TOKENS, D)).astype(np.float32)
    txt = rng.normal(size=(n, 96, D)).astype(np.float32)
    ids = rng.integers(0, MMBT_VOCAB, size=(n, MMBT_TEXT[1]))
    ones, zeros = np.ones((n, MMBT_TEXT[1]), np.int64), np.zeros((n, MMBT_TEXT[1]), np.int64)
    mimg = rng.normal(size=(n, MMBT_IMG, MMBT_IMG, 3)).astype(np.float32)
    vb = {"input_ids": rng.integers(104, 30522, size=(n, VILT_MAX_TEXT)),
          "attention_mask": np.ones((n, VILT_MAX_TEXT), np.int64),
          "token_type_ids": np.zeros((n, VILT_MAX_TEXT), np.int64),
          "pixel_values": rng.normal(size=(n, VILT_IMG, VILT_IMG, 3)).astype(np.float32)}
    live = {"flava": lambda p: p.predict(img, txt),
            "mmbt": lambda p: p.predict(ids, ones, zeros, mimg),
            "vilt": lambda p: p.predict(vb)}
    art_inputs = {
        "flava": (np.pad(img, ((0, 0), (0, IMG_PADDED - IMG_TOKENS), (0, 0))), txt,
                  np.arange(IMG_PADDED)[None].repeat(n, 0) < IMG_TOKENS, np.ones((n, 96), bool)),
        "mmbt": (ids, ones, zeros, mimg, np.ones((n, MMBT_IMG_TOKENS + MMBT_TEXT[1]), bool)),
        "vilt": (vb["input_ids"], vb["attention_mask"], vb["token_type_ids"], vb["pixel_values"],
                 np.ones((n, VILT_IMG, VILT_IMG), np.uint8))}
    rows = {}
    for family, key in (("flava", f"flava {HEADS} heads"), ("mmbt", "mmbt"), ("vilt", "vilt")):
        s = served[key]
        preds = {"fp32": s["fp32"], "int8": s["int8"]["pred"], "int8_weight": s["int8_weight"]["pred"]}
        row = {m: served_samples_per_s(lambda p=p: live[family](p), n) for m, p in preds.items()}
        loaded = E.load_exported(dirs[family], device=DEVICE)
        row["artifact"] = served_samples_per_s(lambda: loaded(*art_inputs[family]), n)
        del loaded
        rows[family] = row
        print(f"phase 3e served samples/s at batch 32 ({family}): " + json.dumps(row), flush=True)
    rows["bench_quant"] = bench_quant.main(["--iters", str(BENCH_3E_ITERS)])
    rows["bench_export"] = bench_export.main(["--iters", str(BENCH_3E_ITERS)])
    return rows


def op_dispatch_cost(iters: int = 500) -> dict:
    """The host cost of reaching the attention kernel through the operator
    ``torch.ops.mmu.attention_fwd`` against calling its body (``_fwd_route``)
    directly, at a shape whose launch is a few microseconds (B=1, S=8, 3 heads
    of 256): µs a call on the host clock, the card kept busy ahead of the
    calls (the launches queue behind a spin)."""
    rng = np.random.default_rng(33)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, D)).astype(np.float32)).to(DEVICE)
               for _ in range(3))
    mask = torch.ones((1, 8), dtype=torch.bool, device=DEVICE)
    out = {}
    for _ in range(2):  # op, direct, op, direct
        for name, fn in (("operator", A.attention_fwd_op), ("direct", A._fwd_route)):
            fn(q, k, v, mask, HEADS)
            torch.cuda.synchronize()
            torch.cuda._sleep(QUEUE_CYCLES)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(q, k, v, mask, HEADS)
            out.setdefault(name, []).append((time.perf_counter() - t0) / iters * 1e6)
            torch.cuda.synchronize()
    print(f"phase 3e operator dispatch: µs a call on the host (two readings each) "
          + json.dumps(out), flush=True)
    return out


def calibrate_dumps(fmnist: dict) -> dict:
    """Phase 3e's temperature fit: ``tools.calibrate`` on phase 6c's dumps of
    the 3-head FashionMNIST transformer (t10k per-head logits): a finite T > 0
    and an NLL after the fit no worse than before."""
    from multimodal_uncertainty_tpu_torch.tools import calibrate

    out_dir = fmnist["runs"]["transformer"]["run"] + "_evals"
    t0 = time.perf_counter()
    rep = calibrate.main(["--val_predictions",
                          os.path.join(out_dir, "model_best_val_predictions.npy"),
                          "--val_labels", os.path.join(out_dir, "model_best_val_labels.npy"),
                          "--reliability_csv", os.path.join(out_dir, "reliability.csv")])
    check(np.isfinite(rep["temperature"]) and rep["temperature"] > 0
          and rep["nll_after"] <= rep["nll_before"],
          f"calibration: T {rep['temperature']}, NLL {rep['nll_before']} -> {rep['nll_after']}")
    print(f"phase 3e calibration on the 6c dumps: T {rep['temperature']:.4f}, NLL "
          f"{rep['nll_before']:.5f} -> {rep['nll_after']:.5f}, ECE {rep['ece_before']:.5f} -> "
          f"{rep['ece_after']:.5f}, recommended {rep['recommended_temperature']:.4f} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return rep


def launches_3e(phase3e: dict, dh: int) -> int:
    """Phase 3e's attention launches at head dim ``dh``: int8 serving and the
    artifacts' servers."""
    return sum(n for part in phase3e["launches"].values() for d, n in part.values() if d == dh)


def phase_3e(t_start: float) -> dict:
    """Phase 3e: ``--quantize int8|int8_weight`` over HTTP for FLAVA fusion at
    3 and 8 heads, MMBT and ViLT-B/32; the artifacts of each family served
    from subprocesses; served samples/s; the bench tools; the operator's
    dispatch cost. The temperature fit runs after phase 6c."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        specs = quant_family_specs(tmp)
        served = {name: quantized_serving(name, spec) for name, spec in specs.items()}
        print(f"phase 3e int8 serving done at {time.perf_counter() - t_start:.1f} s", flush=True)
        arts = artifacts_end_to_end(tmp, specs, served)
        print(f"phase 3e artifacts done at {time.perf_counter() - t_start:.1f} s", flush=True)
        timings = phase_3e_timings(specs, served, arts["dirs"])
    launches = {"int8 serving": {k: (specs[k]["dh"], v["launches"]) for k, v in served.items()},
                "artifacts": arts["launches"]}
    summary = {k: {**{m: {x: y for x, y in s[m].items() if x != "pred"}
                      for m in ("int8", "int8_weight")}, "build_s": s["build_s"]}
               for k, s in served.items()}
    served.clear()  # the predictors' card memory
    gc.collect()
    torch.cuda.empty_cache()
    dispatch = op_dispatch_cost()
    seconds = time.perf_counter() - t0
    print(f"phase 3e took {seconds:.1f} s", flush=True)
    return {"launches": launches, "timings": timings, "dispatch": dispatch, "seconds": seconds,
            "served": summary}


def phase_4k(t_start: float) -> dict:
    """Phase 4k: ``--remat``, ``--diversity``, preemption, ``--profile_dir``
    and ``out.log``."""
    out = {"flava remat": flava_remat_steps(), "mmbt remat": mmbt_remat_micro_step()}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_shards(os.path.join(tmp, "data"), np.random.default_rng(1))
        print(f"phase 4k: shards written in {time.perf_counter() - t0:.1f} s", flush=True)
        out["diversity"] = flava_diversity_end_to_end(tmp)
        out["fmnist diversity"] = fmnist_train_end_to_end(
            tmp, "transformer guided", "--diversity", "guided", "--sample_size",
            str(FMNIST_PLAIN_STEPS * FMNIST_BATCH), heads=FMNIST_HEADS, check_plain=True)
        out["preemption"] = preemption_end_to_end(tmp)
    flava, mmbt = out["flava remat"], out["mmbt remat"]
    out["launches"] = {  # the attention launches of phase 4k's in-process paths, by kernel
        "fwd 256": (sum(flava[torch.float32][k]["launches"][0] for k in ("remat", "plain"))
                    + out["diversity"]["fwd"] + out["fmnist diversity"]["fwd"]
                    + out["preemption"]["fwd"]),
        "bwd 256": (sum(flava[torch.float32][k]["launches"][1] for k in ("remat", "plain"))
                    + out["diversity"]["bwd"] + out["fmnist diversity"]["bwd"]
                    + out["preemption"]["bwd"]),
        "fwd 256 bf16": sum(flava[torch.bfloat16][k]["launches"][0] for k in ("remat", "plain")),
        "bwd 256 bf16": sum(flava[torch.bfloat16][k]["launches"][1] for k in ("remat", "plain")),
        "fwd dropout": sum(mmbt[k]["launches"][0] for k in ("remat", "plain")),
        "bwd dropout": sum(mmbt[k]["launches"][1] for k in ("remat", "plain"))}
    out["at"] = time.perf_counter() - t_start
    return out


def fmnist_plain_gap() -> int:
    """``python3 chip_smoke.py --fmnist-plain-gap``: phase 4j's 3-head
    transformer epoch, then the whole of its epoch 1 rerun with the plain
    attention, printing the relative loss gap step by step (running maxima)
    and the parameters' gap after the epoch (phase 4j holds only the first
    ``FMNIST_PLAIN_STEPS``: over a whole epoch two fp32 trajectories part)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    resolve_device("cuda")
    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        fmnist_train_end_to_end(tmp, "transformer", heads=FMNIST_HEADS, check_plain=True,
                                plain_steps=None)
    return 0


def main() -> int:
    if "--fmnist-plain-gap" in sys.argv[1:]:
        return fmnist_plain_gap()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    resolve_device("cuda")  # TF32 off: the plain fp32 references stay fp32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()

    # phase 1: build
    secs = _build.build()
    print(f"build: {json.dumps(secs)} ({time.perf_counter() - t_start:.1f} s)", flush=True)
    for name in _build.SOURCES:
        for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "Performance Loss")):
                print(f"ptxas {name}: {line.strip()}")
    print(f"card: {smi}", flush=True)
    if "--phase4k" in sys.argv[1:]:
        phase4k = phase_4k(t_start)
        print(f"phase 4k alone done at {phase4k['at']:.1f} s: launches "
              + json.dumps(phase4k["launches"]), flush=True)
        return 0
    if "--phase3e" in sys.argv[1:]:
        phase3e = phase_3e(t_start)
        print(f"phase 3e alone done at {time.perf_counter() - t_start:.1f} s: launches "
              + json.dumps(phase3e["launches"]), flush=True)
        return 0

    # phase 2: kernels vs plain
    rng = np.random.default_rng(0)
    # the forward at Dh 32 and 64 (fp32: csrc/attention_fwd_tc32.cu, split fp32); Dh 128 (the
    # same source) is held to the same gates but runs no model path
    errs = {torch.float32: [], torch.bfloat16: []}
    errs256 = {torch.float32: [], torch.bfloat16: []}  # Dh=256: csrc/attention_fwd_256.cu
    bwd_errs = {torch.float32: [], torch.bfloat16: []}
    bwd256_errs = {torch.float32: [], torch.bfloat16: []}  # Dh=256: csrc/attention_bwd_256.cu
    hl_bwd_errs = {torch.float32: [], torch.bfloat16: []}  # K2 bwd
    drop_errs = {torch.float32: [], torch.bfloat16: []}  # K5 (forward, backward)
    drop64_errs = []  # K5 bf16 at Dh 64: its backward on the tensor cores
    for dtype in (torch.float32, torch.bfloat16):
        for s in (165, 517):
            hl_bwd_errs[dtype].append(compare_heads_last_backward(32, s, 12, 64, dtype, rng))
            for rate in (0.1, 0.5):
                drop_errs[dtype].append(compare_dropout(32, s, 12, 64, dtype, rate, rng))
                if dtype == torch.bfloat16:
                    drop64_errs.append(drop_errs[dtype][-1])
        hl_bwd_errs[dtype].append(compare_heads_last_backward(32, 165, 2, 32, dtype, rng))
        drop_errs[dtype].append(compare_dropout(32, 165, 2, 32, dtype, 0.1, rng))
        if dtype == torch.bfloat16:  # K5 in bf16 on the tensor cores at S = 1, 320 and 736 too,
            for s in (1, 320, 736):  # a random key mask, sample 1 fully masked
                drop_errs[dtype].append(compare_dropout(32, s, 12, 64, dtype, 0.1, rng,
                                                        mask=ragged_mask(32, s, rng)))
                drop64_errs.append(drop_errs[dtype][-1])
        for s in (320, 736):
            errs256[dtype].append(compare_kernel(32, s, HEADS, D // HEADS, dtype, rng))
            bwd256_errs[dtype].append(compare_backward(32, s, HEADS, D // HEADS, dtype, rng))
        for n_head, dh in ((12, 64), (6, 128)):
            err = compare_kernel(32, 320, n_head, dh, dtype, rng)
            if dh == 64:
                errs[dtype].append(err)
            bwd_errs[dtype].append(compare_backward(32, 320, n_head, dh, dtype, rng))
        for s in (165, 517):
            errs[dtype].append(compare_heads_last(32, s, 12, 64, dtype, rng))
        errs[dtype].append(compare_heads_last(32, 165, 2, 32, dtype, rng))
    errs256[torch.float32].append(compare_kernel(4, 197, HEADS, D // HEADS, torch.float32, rng))
    bwd256_errs[torch.float32].append(
        compare_backward(4, 197, HEADS, D // HEADS, torch.float32, rng))
    # K8 at ViLT's shapes, and through a fast_dw Linear
    dw_errs = {dtype: [compare_dw(*shape, dtype) for shape in DW_SHAPES]
               for dtype in (torch.float32, torch.bfloat16)}
    dw_errs[torch.float32].append(compare_dw_linear())
    # the bf16 routes on the tensor cores at their model shapes, beside their library calls
    tc_rows = {"dw": time_dw(*DW_SHAPES[2], torch.bfloat16),
               "attention_fwd heads-last": time_heads_last(32, 165, torch.bfloat16),
               "attention_bwd heads-last": time_mmbt_backward(32, 165, torch.bfloat16)["bwd"]}
    for name, r in tc_rows.items():
        print(f"bf16 {name} on the tensor cores: {r['ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms", flush=True)
    # the instances of FLAVA fusion's other head counts (K6's head dims, 384 / 768, and 32 /
    # 128), at its serving shape, and Dh 96, 384 and 768 at S=736: {(dh, S): (forward,
    # backward) errors}
    new_errs = {torch.float32: {}, torch.bfloat16: {}}
    for dtype in (torch.float32, torch.bfloat16):
        for dh, s in ([(dh, 320) for dh in K6_HEAD_DIMS + WIDE_HEAD_DIMS + FLAVA_K1_DIMS]
                      + [(96, 736), (384, 736), (768, 736)]):
            new_errs[dtype][(dh, s)] = (compare_kernel(32, s, D // dh, dh, dtype, rng),
                                        compare_backward(32, s, D // dh, dh, dtype, rng))
    # the kernels on register micro-tiles and clusters at a ragged S: {dh: (fwd, bwd) errors},
    # and the dropout backward there (sample 1 fully masked)
    ragged_errs = {dtype: {dh: compare_ragged(dh, dtype, rng) for dh in CLUSTER_HEAD_DIMS}
                   for dtype in (torch.float32, torch.bfloat16)}
    # the bf16 forward and backward on the tensor cores at Dh 96 and 256
    # (csrc/attention_{fwd,bwd}_tc_k6.cu, _256.cu) at short S too (320 and 736 above, 301 in
    # compare_ragged), and the forward at Dh 256 at S = 736 with a fully masked sample: the
    # packed projection read in place (the forward also on contiguous q, k, v), and separate
    # heads-last q, k, v
    tc_fwd_errs = {dh: [compare_kernel(RAGGED_B, s, D // dh, dh, torch.bfloat16, rng,
                                       mask=ragged_mask(RAGGED_B, s, rng))
                        for s in TC_SHORT_S + ((736,) if dh == 256 else ())]
                   + [compare_heads_last(32, 165, D // dh, dh, torch.bfloat16, rng)]
                   for dh in A.TC_FWD_DIMS}
    tc_bwd_errs = {dh: [compare_backward(32, s, D // dh, dh, torch.bfloat16, rng)
                        for s in TC_SHORT_S]
                   + [compare_heads_last_backward(32, 165, D // dh, dh, torch.bfloat16, rng)]
                   for dh in A.TC_BWD_DIMS}
    print("bf16 tensor-core kernels against the plain versions, max |error| (forward at S "
          f"{TC_SHORT_S} and heads-last 165; backward likewise): " + json.dumps(
              {f"Dh={dh}": [max(tc_fwd_errs[dh])] + ([max(tc_bwd_errs[dh])] if dh in tc_bwd_errs
                                                      else []) for dh in A.TC_FWD_DIMS}),
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        for n_head, dh in RAGGED_DROPOUT:
            for rate in (0.1, 0.5):
                mask = torch.from_numpy(rng.random((RAGGED_B, RAGGED_S)) > 0.3).to(DEVICE)
                mask[1] = False
                drop_errs[dtype].append(compare_dropout(RAGGED_B, RAGGED_S, n_head, dh, dtype,
                                                        rate, rng, mask=mask))
                if dtype == torch.bfloat16 and dh == 64:
                    drop64_errs.append(drop_errs[dtype][-1])
        bwd256_errs[dtype].append(ragged_errs[dtype][256][1])
        if dtype == torch.bfloat16:
            bwd256_errs[dtype] += tc_bwd_errs[256]
            errs256[dtype] += tc_fwd_errs[256]
        errs256[dtype].append(ragged_errs[dtype][256][0])
        for dh in (32, 64, 128):
            if dh != 128:
                errs[dtype].append(ragged_errs[dtype][dh][0])
            bwd_errs[dtype].append(ragged_errs[dtype][dh][1])
        for dh in K6_HEAD_DIMS + WIDE_HEAD_DIMS:
            new_errs[dtype][(dh, RAGGED_S)] = ragged_errs[dtype][dh]
    # the FashionMNIST transformer's S = 4, fp32, at every head dim of D = 768: {dh: (fwd, bwd)}
    short_errs = {dh: compare_short(dh, rng) for dh in CLUSTER_HEAD_DIMS}
    print("fp32 at S=4 (no key mask, B " + ", ".join(map(str, SHORT_BATCHES)) + "; B=3 ragged) "
          "against the plain versions, max |error| (forward, backward): "
          + json.dumps({f"Dh={dh}": e for dh, e in short_errs.items()}), flush=True)
    errs256[torch.float32].append(short_errs[256][0])
    bwd256_errs[torch.float32].append(short_errs[256][1])
    for dh in (32, 64, 128):
        if dh != 128:
            errs[torch.float32].append(short_errs[dh][0])
        bwd_errs[torch.float32].append(short_errs[dh][1])
    for dh in K6_HEAD_DIMS + WIDE_HEAD_DIMS:
        new_errs[torch.float32][(dh, SHORT_S)] = short_errs[dh]
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # phase 3: serving; phase 4: training
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, _ = serve_end_to_end(tmp)
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        k6_serve_launches, k6_pred = serve_end_to_end(tmp, heads=K6_HEADS, throughput=())
    print(f"phase 3d done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mmbt_launches, mmbt_pred = serve_mmbt_end_to_end(tmp)
    print(f"phase 3b done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        vilt_launches, vilt_pred = serve_vilt_end_to_end(tmp)
    print(f"phase 3c done at {time.perf_counter() - t_start:.1f} s", flush=True)
    phase3e = phase_3e(t_start)
    print(f"phase 3e done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trained = train_end_to_end(tmp)
        print(f"phase 4 done at {time.perf_counter() - t_start:.1f} s", flush=True)
        k6_trained = train_end_to_end(tmp, heads=K6_HEADS, run_name=f"run_{K6_HEADS}_heads")
        print(f"phase 4d done at {time.perf_counter() - t_start:.1f} s", flush=True)
        k6_sweep = sweep_end_to_end(tmp, k6_trained["run"], K6_HEADS, SWEEP_REPEATS)
        k1_sweep = sweep_end_to_end(tmp, trained["run"], HEADS, SWEEP_K1_REPEATS)
        print(f"phase 6 done at {time.perf_counter() - t_start:.1f} s", flush=True)
        bf16_trained = train_bf16_end_to_end(tmp)
        print(f"phase 4f done at {time.perf_counter() - t_start:.1f} s", flush=True)
        movers = flava_batch_movers(tmp)
        print(f"phase 4i done at {time.perf_counter() - t_start:.1f} s", flush=True)
    stepped = head_count_steps()
    print(f"phase 4e done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mmbt_trained = train_mmbt_end_to_end(tmp)
        print(f"phase 4b done at {time.perf_counter() - t_start:.1f} s", flush=True)
        pretrained = train_pretrained_end_to_end(tmp)
        print(f"phase 4h done at {time.perf_counter() - t_start:.1f} s", flush=True)
        mmbt_sweep = mmbt_sweep_end_to_end(tmp)
        print(f"phase 6b done at {time.perf_counter() - t_start:.1f} s", flush=True)
        for name in os.listdir(tmp):  # free the disk blocks of what 4g does not read (its tree)
            if name != "data":
                shutil.rmtree(os.path.join(tmp, name))
        mmbt_bf16 = train_mmbt_bf16_end_to_end(tmp)
    print(f"phase 4g done at {time.perf_counter() - t_start:.1f} s", flush=True)
    fast_dw = fast_dw_steps()
    print(f"phase 4/4b --fast_dw steps done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        vilt_trained = train_vilt_end_to_end(tmp)
    print(f"phase 4c done at {time.perf_counter() - t_start:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fmnist = fmnist_end_to_end(tmp, t_start)
        calibration = calibrate_dumps(fmnist)
    phase4k = phase_4k(t_start)
    print(f"phase 4k done at {phase4k['at']:.1f} s", flush=True)


    # phase 5: times
    rows = [time_attention(32, s, dtype, rng)
            for dtype in (torch.float32, torch.bfloat16) for s in (320, 736)]
    # the new instances in fp32 at FLAVA's serving (forward) and training (backward) shapes
    new_rows = {dh: (time_attention(32, 320, torch.float32, rng, heads=D // dh),
                     time_backward(TRAIN_BATCH, 320, torch.float32, heads=D // dh))
                for dh in K6_HEAD_DIMS + WIDE_HEAD_DIMS}
    # the kernels on clusters and register micro-tiles in bf16 too (fp32 FMAs either way): the
    # forward at 2 and 1 heads, the backward at 2 and 1; and both directions at 3 heads, in bf16
    # on the tensor cores (csrc/attention_{fwd,bwd}_tc_256.cu)
    cluster_bf16 = {dh: (time_attention(32, 320, torch.bfloat16, rng, heads=D // dh),
                         time_backward(TRAIN_BATCH, 320, torch.bfloat16, heads=D // dh))
                    for dh in (256,) + WIDE_HEAD_DIMS}
    k6_pred_rate = predictor_throughput(k6_pred, 32, 77, rng)
    del k6_pred
    hl_rows = {(dtype, s): time_heads_last(32, s, dtype)
               for dtype in (torch.float32, torch.bfloat16) for s in (165, 517)}
    for n, text in MMBT_THROUGHPUT:
        mmbt_throughput(mmbt_pred, n, text)
    del mmbt_pred
    dw_rows = {(shape, dtype): time_dw(*shape, dtype)
               for dtype in (torch.float32, torch.bfloat16) for shape in DW_SHAPES[:5]}
    dw_rows.update({(shape, torch.float32): time_dw(*shape, torch.float32)
                    for shape in FLAVA_DW_SHAPES})
    vilt_throughput(vilt_pred, VILT_TRAIN_BATCH)
    del vilt_pred
    vilt_train_step_throughput()
    mmbt_rows = {s: {**time_mmbt_backward(32, s, torch.float32),
                     **time_mmbt_backward(32, s, torch.float32, rate=MMBT_DROPOUT)}
                 for s in (165, 517)}
    bwd_rows = [time_backward(TRAIN_BATCH, s, torch.float32) for s in (320, 736)]
    bwd_rows += [time_backward(32, s, torch.bfloat16) for s in (320, 736)]
    # attention_bwd.cu's main path after Dh=256 left it: ViLT's 12 heads of 64 (B=32, S=185);
    # and K1's forward there (the split-fp32 kernel, fp32)
    vilt_bwd_row = time_backward(VILT_TRAIN_BATCH, VILT_MAX_TEXT + 145, torch.float32, heads=12)
    time_attention(VILT_TRAIN_BATCH, VILT_MAX_TEXT + 145, torch.float32, rng, heads=12,
                   mask_fn=default_mask)
    setup = train_setup(5)
    flava_steps = {text: train_step_throughput(setup, text) for text in (96, LONG_TEXT)}
    del setup
    k6_step = train_step_throughput(train_setup(5, heads=K6_HEADS), 96)
    # the FashionMNIST round: its attention at S = 4 (3 heads, Dh 256; the train batch and the
    # sweep's rows), and its two train steps profiled
    short_rows = {b: (time_attention(b, SHORT_S, torch.float32, rng, mask_fn=None),
                      time_backward(b, SHORT_S, torch.float32)) for b in SHORT_BATCHES}
    short_k6_rows = (time_attention(FMNIST_BATCH, SHORT_S, torch.float32, rng,
                                    heads=FMNIST_K6_HEADS, mask_fn=None),
                     time_backward(FMNIST_BATCH, SHORT_S, torch.float32, heads=FMNIST_K6_HEADS))
    fmnist_steps = {"resnet": fmnist_step_profile(), "transformer": fmnist_step_profile(HEADS)}
    # --bf16 (phases 4f / 4g): the train steps beside the fp32 ones above, and each bf16 kernel
    # of those paths at its main-path shape
    setup = train_setup(5, dtype=torch.bfloat16)
    flava_bf16_steps_t = {text: train_step_throughput(setup, text) for text in (96, LONG_TEXT)}
    del setup
    # the same bf16 step with --fast_dw: the dW kernels' share of its device time
    setup = train_setup(5, fast_dw=True, dtype=torch.bfloat16)
    flava_bf16_fast_dw = train_step_throughput(setup, 96)
    del setup
    print(f"--bf16 --fast_dw flava train step (batch {TRAIN_BATCH}, S={flava_bf16_fast_dw['S']}): "
          f"{flava_bf16_fast_dw['ms']:.3f} ms; dw device ms (csrc/dw.cu) "
          f"{flava_bf16_fast_dw['by_kind'].get('dw', 0.0):.3f} of "
          f"{flava_bf16_fast_dw['busy_ms']:.3f} busy "
          f"({'complete' if flava_bf16_fast_dw['complete'] else 'incomplete'} profile)",
          flush=True)
    print(f"--bf16 flava train step (batch {TRAIN_BATCH}, {HEADS} heads), attention forward "
          "device ms (csrc/attention_fwd_tc_256.cu): " + ", ".join(
              f"S={r['S']} {r['by_kind'].get('attention_fwd', 0.0):.3f} of {r['busy_ms']:.3f} "
              f"busy ({'complete' if r['complete'] else 'incomplete'} profile)"
              for r in flava_bf16_steps_t.values()), flush=True)
    mmbt_steps = {text: {dtype: mmbt_train_step_throughput(text, dtype=dtype)
                         for dtype in (None, torch.bfloat16)} for _, text in MMBT_THROUGHPUT}
    # K5 on its main path: the --bf16 micro-step with attention-probs dropout at S = 165, its
    # tensor-core dropout forward and backward's share of the device time
    drop_tc = (A.attention_fwd_dropout_cuda.launches_tc, A.attention_bwd_dropout_cuda.launches_tc)
    mmbt_drop_step = mmbt_train_step_throughput(MMBT_THROUGHPUT[0][1], dtype=torch.bfloat16,
                                                rate=MMBT_DROPOUT)
    check(A.attention_fwd_dropout_cuda.launches_tc > drop_tc[0]
          and A.attention_bwd_dropout_cuda.launches_tc > drop_tc[1],
          "the --bf16 MMBT micro-step with dropout ran no tensor-core dropout forward or backward")
    print(f"--bf16 mmbt train micro-step with attention-probs dropout {MMBT_DROPOUT} (batch "
          f"{MMBT_TRAIN_BATCH}, S={mmbt_drop_step['S']}): {mmbt_drop_step['ms']:.3f} ms; K5 device "
          f"ms: attention forward (csrc/attention_fwd_tc.cu) "
          f"{mmbt_drop_step['by_kind'].get('attention_fwd', 0.0):.3f}, "
          f"attention backward (csrc/attention_bwd_tc.cu) "
          f"{mmbt_drop_step['by_kind'].get('attention_bwd', 0.0):.3f} of "
          f"{mmbt_drop_step['busy_ms']:.3f} busy "
          f"({'complete' if mmbt_drop_step['complete'] else 'incomplete'} profile)", flush=True)
    bf16_rows = {
        "attention_fwd 256": time_attention(TRAIN_BATCH, 320, torch.bfloat16, rng),
        "attention_bwd 256": cluster_bf16[256][1],
        "attention_fwd k6": time_attention(32, 320, torch.bfloat16, rng, heads=K6_HEADS),
        "attention_bwd k6": time_backward(32, 320, torch.bfloat16, heads=K6_HEADS),
        **{f"attention_fwd {dh}": time_attention(32, 320, torch.bfloat16, rng, heads=D // dh)
           for dh in (24, 48, 192) + FLAVA_K1_DIMS},
        **{f"attention_bwd {dh}": time_backward(32, 320, torch.bfloat16, heads=D // dh)
           for dh in (24, 48, 192) + FLAVA_K1_DIMS},
        **{f"attention_fwd {dh}": cluster_bf16[dh][0] for dh in WIDE_HEAD_DIMS},
        **{f"attention_bwd {dh}": cluster_bf16[dh][1] for dh in WIDE_HEAD_DIMS},
        "attention_fwd heads-last": hl_rows[(torch.bfloat16, 165)],
        "attention_bwd heads-last": tc_rows["attention_bwd heads-last"],
        **{f"attention_{k}": r for k, r in time_mmbt_backward(32, 165, torch.bfloat16,
                                                              rate=MMBT_DROPOUT).items()},
    }
    # K8 in bf16 at every shape of the --bf16 --fast_dw paths: the stream-K kernel and, at K =
    # 32 and 96, the small-K one
    dw_bf16_rows = {shape: time_dw(*shape, torch.bfloat16) for shape in BF16_DW_SHAPES}
    bf16_rows["dw"] = dw_bf16_rows[(10240, D, 4 * D)]  # FLAVA's fc1
    bf16_rows["dw small K"] = dw_bf16_rows[(32, D, D)]  # MMBT's pooler
    print(f"phase 5 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    # phase 7: K4 (attention_flash at S=16384) and the bench_flash tool, K7, K8b and bench_dw
    flash_errs = {dtype: compare_flash(dtype) for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    flash_rows, flash_launches = flash_bench()
    flash_times = {dtype: time_flash(dtype) for dtype in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    ln_errs = {dtype: [compare_layer_norm(shape, eps, mean, dtype)
                       for shape, eps, mean in LN_CASES if dtype == torch.bfloat16 or mean == 0]
               for dtype in (torch.float32, torch.bfloat16)}
    ln_launches = layer_norm_predictor()
    ln_times = {(rows, dtype): time_layer_norm(rows, dtype)
                for rows in (LN_PATH_ROWS, LN_TRAIN_ROWS)
                for dtype in (torch.float32, torch.bfloat16)}
    k8b_err = compare_dw(*K8B_SHAPE, torch.bfloat16)
    dw_bench_rows, k8b_launches = dw_bench()
    k8b_row = time_dw(*K8B_SHAPE, torch.bfloat16)
    print(f"phase 7 done at {time.perf_counter() - t_start:.1f} s", flush=True)

    fwd_row = rows[0]  # fp32 at B=32, S=224+96: the serving path's common shape (Dh=256)
    hl_fwd_row = hl_rows[(torch.float32, 165)]  # K2 fwd at MMBT's common shape (Dh=64)
    bwd_row = bwd_rows[0]  # fp32 at B=128, S=224+96: the training path's common shape
    mmbt_row = mmbt_rows[165]  # fp32 at B=32, S=5+160: MMBT's common shape
    dw_row = dw_rows[(DW_SHAPES[2], torch.float32)]  # fp32 fc1 at K=5920: ViLT's largest dW
    dw_small_row = dw_rows[(DW_SHAPES[4], torch.float32)]  # fp32 at K=32: the pooler's, SIMT
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k6_fwd_row, k6_bwd_row = new_rows[96]  # 8 heads: the K6 path's main shapes
    wide_fwd_row, wide_bwd_row = new_rows[768]  # 1 head
    k6_dims = [dh for dh in K6_HEAD_DIMS if dh != 96]

    def new_err(dims, which):
        return max(e[which] for (dh, _), e in new_errs[torch.float32].items() if dh in dims)

    step_launches = {dims: sum(r["fwd"] for r in stepped.values() if r["dh"] in dims)
                     for dims in (K6_HEAD_DIMS, WIDE_HEAD_DIMS)}
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd_tc32.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:777 (_sdpa_packed_fwd_impl), "
                    ":1071 (_sdpa_flash_fwd_impl), :419 (_sdpa_hl_fwd_impl)",
        "launches": (mmbt_launches + vilt_launches + mmbt_trained["fwd"]
                     + mmbt_trained["fwd_eval_dropout_run"] + vilt_trained["fwd"]
                     + pretrained["fwd"] + pretrained["vilt_fwd"] + mmbt_sweep["fwd"]
                     + launches_3e(phase3e, MMBT_DH)),
        "max_abs_err": max(errs[torch.float32]),
        **{k: hl_fwd_row[k] for k in timed},
    }, {
        "name": "attention_fwd 256",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd_256.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:777 (_sdpa_packed_fwd_impl), "
                    ":1071 (_sdpa_flash_fwd_impl) at Dh 256",
        "launches": (serve_launches + trained["fwd"] + k1_sweep["fwd"]
                     + fmnist["runs"]["transformer"]["fwd"]
                     + fmnist["evals"]["transformer"]["fwd"] + phase4k["launches"]["fwd 256"]
                     + launches_3e(phase3e, D // HEADS)),
        "max_abs_err": max(errs256[torch.float32]),
        **{k: fwd_row[k] for k in timed},
    }, {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:813 (_sdpa_packed_bwd_impl), "
                    ":1219 (_sdpa_flash_bwd_impl)",
        "launches": vilt_trained["bwd"] + pretrained["vilt_bwd"],
        "max_abs_err": max(bwd_errs[torch.float32]),
        **{k: vilt_bwd_row[k] for k in timed},
    }, {
        "name": "attention_bwd 256",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd_256.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:813 (_sdpa_packed_bwd_impl), "
                    ":1219 (_sdpa_flash_bwd_impl) at Dh 256",
        "launches": (trained["bwd"] + fmnist["runs"]["transformer"]["bwd"]
                     + phase4k["launches"]["bwd 256"]),
        "max_abs_err": max(bwd256_errs[torch.float32]),
        **{k: bwd_row[k] for k in timed},
    }, {
        "name": "attention_bwd heads-last",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:504 (_sdpa_hl_bwd_impl)",
        "launches": mmbt_trained["bwd"] + pretrained["bwd"],
        "max_abs_err": max(hl_bwd_errs[torch.float32]),
        **{k: mmbt_row["bwd"][k] for k in timed},
    }, {
        "name": "attention_fwd_dropout",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd_tc32.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:677 (_sdpa_hl_drop_fwd_impl)",
        "launches": mmbt_trained["fwd_dropout"] + phase4k["launches"]["fwd dropout"],
        "max_abs_err": max(f for f, _ in drop_errs[torch.float32]),
        **{k: mmbt_row["fwd_dropout"][k] for k in timed},
    }, {
        "name": "attention_bwd_dropout",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:717 (_sdpa_pallas_hl_drop_bwd)",
        "launches": mmbt_trained["bwd_dropout"] + phase4k["launches"]["bwd dropout"],
        "max_abs_err": max(b_ for _, b_ in drop_errs[torch.float32]),
        **{k: mmbt_row["bwd_dropout"][k] for k in timed},
    }, {
        "name": "dw",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/dw.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/dw.py:95 (_dw_pallas_2d)",
        "launches": (vilt_trained["dw_routes"]["tc32"] + fast_dw["routes"]["tc32"]
                     + pretrained["vilt_dw_routes"]["tc32"]),
        "max_abs_err": max(dw_errs[torch.float32] + fast_dw["dw_errs"]
                           + vilt_trained["dw_errs"] + pretrained["dw_errs"]),
        **{k: dw_row[k] for k in timed},
    }, {
        "name": "dw small K",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/dw.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/dw.py:95 (_dw_pallas_2d) at K <= 128",
        "launches": (vilt_trained["dw_routes"]["simt"] + fast_dw["routes"]["simt"]
                     + pretrained["vilt_dw_routes"]["simt"]),
        "max_abs_err": max(dw_errs[torch.float32][i] for i, (k, _, _) in enumerate(DW_SHAPES)
                           if k <= DW.SIMT_MAX_K),
        **{k: dw_small_row[k] for k in timed},
    }, {
        "name": "attention_fwd k6",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd_tc32_k6.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:160 (_sdpa_pallas_fwd_impl)",
        "launches": (k6_serve_launches + k6_trained["fwd"] + k6_sweep["fwd"]
                     + step_launches[K6_HEAD_DIMS] + fmnist["runs"]["transformer k6"]["fwd"]
                     + launches_3e(phase3e, D // K6_HEADS)),
        "max_abs_err": new_err(K6_HEAD_DIMS, 0),
        **{k: k6_fwd_row[k] for k in timed},
    }, {
        "name": "attention_bwd k6",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd_k6.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:253 (_sdpa_bwd_impl)",
        "launches": (k6_trained["bwd"] + step_launches[K6_HEAD_DIMS]
                     + fmnist["runs"]["transformer k6"]["bwd"]),
        "max_abs_err": new_err(K6_HEAD_DIMS, 1),
        **{k: k6_bwd_row[k] for k in timed},
    }, {
        "name": "attention_fwd wide",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd_wide.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:777 (_sdpa_packed_fwd_impl), "
                    ":1071 (_sdpa_flash_fwd_impl) at Dh 384 and 768",
        "launches": step_launches[WIDE_HEAD_DIMS],
        "max_abs_err": new_err(WIDE_HEAD_DIMS, 0),
        **{k: wide_fwd_row[k] for k in timed},
    }, {
        "name": "attention_bwd wide",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd_wide.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:813 (_sdpa_packed_bwd_impl), "
                    ":1219 (_sdpa_flash_bwd_impl) at Dh 384 and 768",
        "launches": step_launches[WIDE_HEAD_DIMS],
        "max_abs_err": new_err(WIDE_HEAD_DIMS, 1),
        **{k: wide_bwd_row[k] for k in timed},
    }, {
        "name": "attention_flash fwd",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_fwd_tc.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:1488 (_sdpa_flash_fwd_stream_impl)",
        "launches": flash_launches["attention_fwd"],
        "max_abs_err": max(flash_errs[torch.bfloat16][n] for n in ("out", "lse")),
        **{k: flash_times[torch.bfloat16][0][k] for k in timed},
    }, {
        "name": "attention_flash bwd",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/attention_bwd_tc.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/attention.py:1521 (_sdpa_flash_bwd_stream_impl)",
        "launches": flash_launches["attention_bwd"],
        "max_abs_err": max(flash_errs[torch.bfloat16][n] for n in ("dq", "dk", "dv")),
        **{k: flash_times[torch.bfloat16][1][k] for k in timed},
    }, {
        "name": "layer_norm",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/layer_norm.cu",
        "replaces": "multimodal_uncertainty_tpu/ops/norms.py:41 (layer_norm_pallas)",
        "launches": ln_launches,
        "max_abs_err": max(ln_errs[torch.float32]),
        **{k: ln_times[(LN_PATH_ROWS, torch.float32)][k] for k in timed},
    }, {
        "name": "dw bench_dw",
        "route": "cuda",
        "source": "multimodal_uncertainty_tpu_torch/csrc/dw.cu",
        "replaces": "tools/bench_dw.py:99 (make_dw_pallas)",
        "launches": k8b_launches,
        "max_abs_err": k8b_err,
        **{k: k8b_row[k] for k in timed},
    }]
    # the bf16 instances on the --bf16 paths (phases 4f / 4g), each held to its plain version in
    # phase 2 (bf16 gates) and timed in phase 5 at its main-path shape
    kernels += [{"name": f"{name} bf16", "route": "cuda",
                 "source": f"multimodal_uncertainty_tpu_torch/csrc/{source}",
                 "replaces": f"multimodal_uncertainty_tpu/ops/{replaces}", "launches": launches,
                 "max_abs_err": err, **{k: bf16_rows[name][k] for k in timed}}
                for name, source, replaces, launches, err in (
        ("attention_fwd 256", "attention_fwd_tc_256.cu",
         "attention.py:777 (_sdpa_packed_fwd_impl), :1071 (_sdpa_flash_fwd_impl) at Dh 256",
         bf16_trained["fwd"] + movers["fwd"] + phase4k["launches"]["fwd 256 bf16"],
         max(errs256[torch.bfloat16])),
        ("attention_bwd 256", "attention_bwd_tc_256.cu",
         "attention.py:813 (_sdpa_packed_bwd_impl), :1219 (_sdpa_flash_bwd_impl) at Dh 256",
         bf16_trained["bwd"] + movers["bwd"] + phase4k["launches"]["bwd 256 bf16"],
         max(bwd256_errs[torch.bfloat16])),
        ("attention_fwd k6", "attention_fwd_tc_k6.cu", "attention.py:160 (_sdpa_pallas_fwd_impl)",
         bf16_trained[f"fwd {K6_HEADS} heads"],
         max([e[0] for (dh, _), e in new_errs[torch.bfloat16].items() if dh == 96]
             + tc_fwd_errs[96])),
        ("attention_bwd k6", "attention_bwd_tc_k6.cu", "attention.py:253 (_sdpa_bwd_impl)",
         bf16_trained[f"bwd {K6_HEADS} heads"],
         max([e[1] for (dh, _), e in new_errs[torch.bfloat16].items() if dh == 96]
             + tc_bwd_errs[96])),
        *((f"attention_{direction} {k6_dh}", f"attention_{direction}_tc_{k6_dh}.cu",
           f"attention.py:{line} ({fn}) at Dh {k6_dh}",
           bf16_trained[f"{direction} {D // k6_dh} heads"],
           max([e[which] for (dh, _), e in new_errs[torch.bfloat16].items() if dh == k6_dh]
               + (tc_fwd_errs if direction == "fwd" else tc_bwd_errs)[k6_dh]))
          for direction, line, fn, which in (("fwd", 160, "_sdpa_pallas_fwd_impl", 0),
                                             ("bwd", 253, "_sdpa_bwd_impl", 1))
          for k6_dh in (24, 48, 192)),
        ("attention_fwd heads-last", "attention_fwd_tc.cu", "attention.py:419 (_sdpa_hl_fwd_impl)",
         mmbt_bf16["counts"][0] + mmbt_bf16["counts dropout"][0], max(errs[torch.bfloat16])),
        ("attention_bwd heads-last", "attention_bwd_tc.cu", "attention.py:504 (_sdpa_hl_bwd_impl)",
         mmbt_bf16["counts"][1], max(hl_bwd_errs[torch.bfloat16])),
        ("attention_fwd_dropout", "attention_fwd_tc.cu",
         "attention.py:677 (_sdpa_hl_drop_fwd_impl)", mmbt_bf16["counts dropout"][2],
         max(f for f, _ in drop64_errs)),
        ("attention_bwd_dropout", "attention_bwd_tc.cu",
         "attention.py:717 (_sdpa_pallas_hl_drop_bwd)", mmbt_bf16["counts dropout"][3],
         max(b_ for _, b_ in drop64_errs)),
        *((f"attention_fwd {wide_dh}", f"attention_fwd_tc_{wide_dh}.cu",
           "attention.py:777 (_sdpa_packed_fwd_impl), :1071 (_sdpa_flash_fwd_impl) at Dh "
           f"{wide_dh}",
           bf16_trained[f"fwd {D // wide_dh} heads"],
           max([e[0] for (dh, _), e in new_errs[torch.bfloat16].items() if dh == wide_dh]
               + tc_fwd_errs[wide_dh]))
          for wide_dh in WIDE_HEAD_DIMS + FLAVA_K1_DIMS),
        *((f"attention_bwd {wide_dh}", f"attention_bwd_tc_{wide_dh}.cu",
           "attention.py:813 (_sdpa_packed_bwd_impl), :1219 (_sdpa_flash_bwd_impl) at Dh "
           f"{wide_dh}",
           bf16_trained[f"bwd {D // wide_dh} heads"],
           max([e[1] for (dh, _), e in new_errs[torch.bfloat16].items() if dh == wide_dh]
               + tc_bwd_errs[wide_dh]))
          for wide_dh in WIDE_HEAD_DIMS + FLAVA_K1_DIMS),
        ("dw", "dw.cu", "dw.py:95 (_dw_pallas_2d)", bf16_trained["dw"] + mmbt_bf16["dw"],
         max(e for (k, _, _, dt), e in DW_CHECKED.items()
             if dt == torch.bfloat16 and DW.dw_route(k, dt) == "tc")),
        ("dw small K", "dw.cu", f"dw.py:95 (_dw_pallas_2d) at K <= {DW.MMA_MAX_K}",
         bf16_trained["dw_small"] + mmbt_bf16["dw_small"],
         max(e for (k, _, _, dt), e in DW_CHECKED.items()
             if dt == torch.bfloat16 and DW.dw_route(k, dt) == "mma")))]
    print("bench_flash: " + json.dumps(flash_rows), flush=True)
    print("bench_dw: " + json.dumps(dw_bench_rows), flush=True)
    print(f"flava at {K6_HEADS} heads: predictor {k6_pred_rate:.1f} samples/s (batch 32, S=320), "
          f"train step {k6_step['ms']:.3f} ms (batch {TRAIN_BATCH}, S=320), sweep "
          f"{k6_sweep['variant_samples_per_s']:.1f} variant-samples/s; the head dims {k6_dims} "
          f"ran in phase 4e", flush=True)
    print("the kernels at the wide head dims (bf16 at Dh=256 on the tensor cores): " + json.dumps({
        **{f"attention_fwd Dh={dh} {dt}": {k: r[k] for k in timed}
           for dh in (256,) + WIDE_HEAD_DIMS
           for dt, r in (("float32", fwd_row if dh == 256 else new_rows[dh][0]),
                         ("bfloat16", cluster_bf16[dh][0]))},
        **{f"attention_bwd Dh={dh} {dt}": {k: r[k] for k in timed}
           for dh in (256,) + WIDE_HEAD_DIMS
           for dt, r in (("float32", bwd_row if dh == 256 else new_rows[dh][1]),
                         ("bfloat16", cluster_bf16[dh][1]))}}), flush=True)
    print(f"flava at {HEADS} heads: train step " + ", ".join(
        f"{r['ms']:.3f} ms at S={r['S']}" for r in flava_steps.values())
        + f" (batch {TRAIN_BATCH})", flush=True)
    print("--bf16 against fp32, train steps (batch 128; MMBT micro-step batch 32): " + json.dumps({
        **{f"flava S={flava_steps[t]['S']}": {
            "fp32 ms": flava_steps[t]["ms"], "bf16 ms": flava_bf16_steps_t[t]["ms"],
            "fp32 samples/s": flava_steps[t]["samples_per_s"],
            "bf16 samples/s": flava_bf16_steps_t[t]["samples_per_s"],
            "bf16 device ms by kind": flava_bf16_steps_t[t]["by_kind"],
            "bf16 profile complete": flava_bf16_steps_t[t]["complete"]} for t in flava_steps},
        **{f"mmbt S={r[None]['S']}": {
            "fp32 ms": r[None]["ms"], "bf16 ms": r[torch.bfloat16]["ms"],
            "fp32 samples/s": r[None]["samples_per_s"],
            "bf16 samples/s": r[torch.bfloat16]["samples_per_s"],
            "fp32 device ms by kind": r[None]["by_kind"],
            "bf16 device ms by kind": r[torch.bfloat16]["by_kind"],
            "bf16 profile complete": r[torch.bfloat16]["complete"]} for r in mmbt_steps.values()}}),
        flush=True)
    print(f"--bf16 checks: flava first-step loss {bf16_trained['loss_rel_fp32']:.3g} off fp32, "
          f"mmbt {mmbt_bf16['loss_rel_fp32']:.3g}; worst gradient |diff| / max|grad| against the "
          f"plain attention: flava " + ", ".join(
              f"{bf16_trained[f'grad_ratio {h} heads']:.3g} ({h} heads)" for h in BF16_STEP_HEADS)
          + ", mmbt "
          f"{mmbt_bf16['grad_ratio']:.3g}", flush=True)
    print(f"mmbt sweep (phase 6b): {mmbt_sweep['variant_samples_per_s']:.1f} variant-samples/s "
          f"in the CLI, {mmbt_sweep['warm_variant_samples_per_s']:.1f} warm; "
          "busy share of the epoch loop / the whole train CLI run: mmbt from pretrained weights "
          "(phase 4h) " + ", ".join(f"{k} {'-' if a is None else f'{100 * a:.1f}'} / {100 * b:.1f} %"
                                    for k, (a, b) in pretrained["busy"].items())
          + "; flava --bf16 (phase 4i) " + ", ".join(
              f"{k} {'-' if a is None else f'{100 * a:.1f}'} / {100 * b:.1f} %"
              for k, (a, b) in movers["busy"].items()),
          flush=True)
    print("fmnist (phases 4j, 6c): " + json.dumps({
        **{f"train {k}": {"epoch wall s": r["epoch_s"], "train part s": r["train_s"],
                          "train samples/s": r["samples_per_s"], "val_acc": r["val_acc"],
                          **({"loss rel vs plain": r["loss_rel"]} if "loss_rel" in r else {})}
           for k, r in fmnist["runs"].items()},
        **{f"evals {k}": {"sweep variant-samples/s": r["variant_samples_per_s"],
                          "sweep vs plain": r["max_abs_diff"]} for k, r in fmnist["evals"].items()},
        **{f"step {k}": {"ms": r["ms"], "samples/s": r["samples_per_s"], "busy ms": r["busy_ms"],
                         "device ms by kind": r["by_kind"], "profile complete": r["complete"]}
           for k, r in fmnist_steps.items()},
        "attention at S=4 (Dh 256)": {f"B={b} {d}": {k: r[k] for k in timed}
                                      for b, rows in short_rows.items()
                                      for d, r in zip(("fwd", "bwd"), rows)},
        f"attention at S=4 (Dh {D // FMNIST_K6_HEADS})": {
            f"B={FMNIST_BATCH} {d}": {k: r[k] for k in timed}
            for d, r in zip(("fwd", "bwd"), short_k6_rows)},
        "phases 4j, 6c done at s": fmnist["at"]}), flush=True)
    print("phase 3e: " + json.dumps({
        "seconds": phase3e["seconds"], "int8 serving": phase3e["served"],
        "served samples/s at batch 32": {k: v for k, v in phase3e["timings"].items()
                                         if not k.startswith("bench")},
        "bench_quant": phase3e["timings"]["bench_quant"],
        "bench_export": phase3e["timings"]["bench_export"],
        "operator dispatch us a call": phase3e["dispatch"],
        "calibration (6c dumps)": {k: calibration[k] for k in (
            "temperature", "recommended_temperature", "nll_before", "nll_after", "ece_before",
            "ece_after")}}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print("launches by path: " + json.dumps({
        **{f"{k} --quantize int8, int8_weight (Dh={dh})": {"attention_fwd": n}
           for k, (dh, n) in phase3e["launches"]["int8 serving"].items()},
        **{f"artifact {k}, served from a subprocess (Dh={dh})": {"attention_fwd": n}
           for k, (dh, n) in phase3e["launches"]["artifacts"].items()},
        "flava serving": {"attention_fwd": serve_launches},
        "mmbt serving": {"attention_fwd": mmbt_launches},
        "vilt serving": {"attention_fwd": vilt_launches},
        "flava training": {"attention_fwd": trained["fwd"], "attention_bwd": trained["bwd"]},
        "mmbt training": {"attention_fwd": mmbt_trained["fwd"],
                          "attention_bwd": mmbt_trained["bwd"]},
        "mmbt training, dropout": {"attention_fwd": mmbt_trained["fwd_eval_dropout_run"],
                                   "attention_fwd_dropout": mmbt_trained["fwd_dropout"],
                                   "attention_bwd_dropout": mmbt_trained["bwd_dropout"],
                                   "attention_bwd": 0},
        "vilt training --fast_dw": {"attention_fwd": vilt_trained["fwd"],
                                    "attention_bwd": vilt_trained["bwd"], "dw": vilt_trained["dw"],
                                    "dw by kernel": vilt_trained["dw_routes"]},
        "flava training --bf16, prefetcher and plain batch mover": {
            "attention_fwd": movers["fwd"], "attention_bwd": movers["bwd"]},
        "mmbt training from pretrained weights, prefetcher and plain batch mover": {
            "attention_fwd": pretrained["fwd"], "attention_bwd": pretrained["bwd"]},
        "vilt training from pretrained weights --fast_dw": {
            "attention_fwd": pretrained["vilt_fwd"], "attention_bwd": pretrained["vilt_bwd"],
            "dw by kernel": pretrained["vilt_dw_routes"]},
        "mmbt sweep (V = 43)": {"attention_fwd (Dh=64)": mmbt_sweep["fwd"]},
        "flava and mmbt --fast_dw steps, dw by kernel": fast_dw["routes"],
        "flava train step --fast_dw": {"dw": fast_dw["flava"]},
        "mmbt micro-step --fast_dw": {"dw": fast_dw["mmbt"]},
        "mmbt micro-step --fast_dw, encoders frozen": {"dw": fast_dw["mmbt frozen"]},
        f"flava serving, {K6_HEADS} heads": {"attention_fwd k6 (Dh=96)": k6_serve_launches},
        f"flava training, {K6_HEADS} heads": {"attention_fwd k6 (Dh=96)": k6_trained["fwd"],
                                             "attention_bwd k6 (Dh=96)": k6_trained["bwd"]},
        f"flava sweep, {K6_HEADS} heads": {"attention_fwd k6 (Dh=96)": k6_sweep["fwd"]},
        f"flava sweep, {HEADS} heads": {"attention_fwd (Dh=256)": k1_sweep["fwd"]},
        **{f"flava train step, {h} heads": {f"attention_fwd, attention_bwd (Dh={r['dh']})":
                                            [r["fwd"], r["bwd"]]} for h, r in stepped.items()},
        "attention_flash (bench_flash, S 512-16384)": {
            f"attention_fwd (Dh={K4_DH})": flash_launches["attention_fwd"],
            f"attention_bwd (Dh={K4_DH})": flash_launches["attention_bwd"],
            "at S=16384": {label: flash_rows[-1][label]["launches"]
                           for label in ("flash_fwd", "flash_train")}},
        "flava training --bf16": bf16_trained["routes"],
        "flava train step --bf16 --fast_dw": {**bf16_trained[f"routes {HEADS} heads"],
                                              "dw (dw_kernel_tc)": bf16_trained["dw"],
                                              "dw (dw_kernel_mma)": bf16_trained["dw_small"]},
        **{f"flava train step --bf16, {h} heads": bf16_trained[f"routes {h} heads"]
           for h in BF16_STEP_HEADS if h != HEADS},
        "mmbt training --bf16": mmbt_bf16["routes"],
        "mmbt training --bf16, dropout": mmbt_bf16["routes dropout"],
        "mmbt micro-step --bf16 --fast_dw": {**mmbt_bf16["step routes"],
                                             "dw (dw_kernel_tc)": mmbt_bf16["dw"],
                                             "dw (dw_kernel_mma)": mmbt_bf16["dw_small"]},
        "flava predictor, LayerNormFP32 impl=kernel": {"layer_norm": ln_launches},
        **{f"fmnist training, {k}": {"attention_fwd": r["fwd"], "attention_bwd": r["bwd"]}
           for k, r in fmnist["runs"].items()},
        **{f"fmnist sweep and dump, {k}": {"attention_fwd": r["fwd"]}
           for k, r in fmnist["evals"].items()},
        "bench_dw": {"dw": k8b_launches},
        **{f"flava train step {str(dt)[6:]} --remat (Dh=256)": {
            "attention_fwd, attention_bwd": list(r["remat"]["launches"]),
            "without remat": list(r["plain"]["launches"])}
           for dt, r in phase4k["flava remat"].items()},
        "mmbt micro-step --remat, dropout": {
            "attention_fwd_dropout, attention_bwd_dropout": list(
                phase4k["mmbt remat"]["remat"]["launches"][:2]),
            "without remat": list(phase4k["mmbt remat"]["plain"]["launches"][:2])},
        "flava training --diversity guided, random": {"attention_fwd": phase4k["diversity"]["fwd"],
                                                      "attention_bwd": phase4k["diversity"]["bwd"]},
        "fmnist training --diversity guided, 3 heads": {
            "attention_fwd": phase4k["fmnist diversity"]["fwd"],
            "attention_bwd": phase4k["fmnist diversity"]["bwd"]},
        "flava training, preemption runs A and B (in-process)": {
            "attention_fwd": phase4k["preemption"]["fwd"],
            "attention_bwd": phase4k["preemption"]["bwd"]}}))
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not idle, f"kernels the main path never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
