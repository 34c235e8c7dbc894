#!/usr/bin/env python3
"""Drive the PyTorch port (``tpu_slu_torch``) once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. environment: torch, the card, its power limit and nvcc; torch's TF32
   flags are left at their defaults, as a user has them;
2. build: compiles ``tpu_slu_torch/csrc/*.cu`` with nvcc, and beside it
   developer copies of one source each (``VARIANTS``): K1, K2 and K4f on
   the cluster size the two-direction rule does not pick, K3's, K4b's and
   K5b's chain on the size its rule does not pick, and K7 with clocks by
   phase;
3. K1 (the shared-stream bi-GRU kernel) against its plain PyTorch version
   on the card, over parts, pools, odd and even T, B and H = 128; the front
   end's convs and their gradients on the card against an f64 conv on the
   CPU (f32, not TF32);
4. golden decode: the committed toy checkpoint ``tests/assets/golden`` decodes
   its six wavs exactly on the card through the composed front end and K1
   (five K1 launches a call) and through K8 and K6 (one K8 and five K6);
5. flagship slice: ``decode_intents`` at the width of
   ``experiments/no_unfreezing.cfg`` with seeded random weights at B = 1 and
   16 on the default routes (five K1 and, with the fused front end, one K8
   launch a call: K8's count in the kernels line), logits held against the
   same model on the CPU, then warm timings of
   ``predict_intents`` (and its ``[profile]`` at B = 16) and of K1 alone
   against its plain version, with its us a step and cluster size;
   ``[k1-batch]`` K1's five layers on clusters of 2 and of 4 CTAs in turns
   at B = 1, 16 and 64 (the rule's size in the port's library, the other
   in the ``k1_other_c`` variant), each held against the plain version first;
6. flagship train step at the width of ``experiments/no_pretraining.cfg``:
   K2 (train forward) and K3 (backward) against their plain versions at the
   flagship layer shapes; the pooled eval path's gradients against autograd
   of the plain version; one whole train step on the card against the CPU
   plain path (the front end's gradients, the sinc filters' and the
   convs', against an f64 CPU step that replays the card's front-end
   branches, leaky ReLU signs and max-pool argmaxes, each side's error
   printed);
   ``Trainer(model, config).train(dataset)`` over seeded
   synthetic batches of B = 64 with 4 K2, 1 K1 and 5 K3 launches per step,
   then ``Trainer.test``; warm timings of the train step and of K2 (its us
   a step) and K3 against their plain versions, ``[k2-batch]`` K2's four
   layers on clusters of 2 and of 4 CTAs in turns at B = 16 and 64 (the
   other size in the ``k2_other_c`` variant), ``[k3-batch]`` K3's five
   layers the same way at B = 16 and 64 (its chain, the backward cluster
   recurrence, on the other size in the ``k3_other_c`` variant), K3's five
   layers by phase (the gate pass, the chain, the GEMM core's launches, dW's
   reduce pass; profiler) and the core's TFLOP/s on the products counted
   from the shapes;
7. length-exact decode and serving at the width of ``no_unfreezing.cfg``:
   K4f (the length-masked bi-GRU) against its plain version at the five
   layer shapes, B = 8, seeded mixed lengths with exact zeros past each; a
   ``predict_intents(lengths=)`` of an (8, 4 s) padded batch against each
   example's exact-shape decode (the K1 path), 5 K4f and 0 K1 launches on
   the shape's first call (its CUDA graph's eager warm pass); an
   ``IntentServer(max_batch=8)`` answering 32 seeded requests of 1.0-4.0 s
   from 8 threads, each answer equal to its exact-shape decode, each device
   call a graph's replay, 5 K4f launches a capture; ``make_http_server`` on the golden
   checkpoint decoding every golden wav; warm timings of K4f (its us a
   step), ``[k4f-batch]`` its five layers with mixed lengths on clusters of
   2 and of 4 CTAs in turns at B = 1, 8 and 64 (``k4f_other_c``), of the
   exact decode against the exact-shape B = 8 decode, and the served latency;
8. seq2seq decode and serving at the width of ``all_real_seq2seq.cfg``:
   ``[k7]`` K7 (the fused beam search) against its plain version at the
   flagship decoder (B = 1, 16, 17, 64, 133 and 8 with mixed valid frames,
   so that several cluster sizes and a second wave are reached; 30 s, 188
   frames, at B = 1 and 4, and an odd T of 171; W = 9, 16 and 20; W = 25,
   the widest smem plan, at B = 33 and 133, on small clusters; W = 32,
   at 4 s and 30 s, on the global plan: the plan in device memory, counted
   on ``beam_decode.launches_global``), the golden
   decoder, an odd small one and W = 1, tokens equal (a row that differs
   must part at a tie within the f32 drift of its summed steps,
   ``tie_tolerance``) and scores within rtol 1e-5 atol 1e-4; ``[golden-s2s]`` the six golden
   seq2seq wavs exact on the card with one K7 launch a decode and no plain
   search, also through an ``IntentServer`` and over HTTP; ``[s2s]`` the
   flagship seq2seq decode at B = 1 and 16 and on 30 s of audio against the CPU plain path (beam-0 tokens equal, scores
   within 1e-3 relative), and a length-exact (8, 4 s) decode whose rows
   equal their exact-shape decodes; ``[time]`` K7 against its plain
   version and bound at B = 1 and 16 on 4 s and 30 s, with its cluster size
   and plan, and its step split by phase from a traced build of the kernel
   (the ``k7_trace`` variant), and at W = 16, 20 (smem plan) and 32 (global
   plan), the warm decode, its device time by kernel; ``[serve]`` the seq2seq ``IntentServer`` with the traffic
   of phase 7, each device call a graph's replay, one K7 and five K4f
   launches a capture, p50/p90;
9. seq2seq train step at the width of ``all_real_seq2seq.cfg``: ``[k4b]``
   K4b (the length-masked bi-GRU backward) against its plain version at the
   seq2seq encoder layer (B = 64, T = 25, D = 256, every row T), at B = 8
   and B = 133 (batch tiles of 8 rows) with mixed lengths (0 and 1 among
   them) and at an odd small shape, dX and the eight weight and bias
   gradients within ``GRAD_TOL``, dX exactly 0 past each length; ``[s2s-grad]`` one train step (B = 16, U = 32,
   dropout on) on the card against the same step on the CPU, within phase
   6's limits (the front end's parameters against an f64 CPU step, the key bias
   against its weight's scale); ``[s2s-trainer]`` ``Trainer.train`` at B =
   64 over seeded one-hot batches, 4 K2, 4 K3, 1 K4f, 1 K4b and no K1
   launches a step, then ``Trainer.test`` with the decode's exact match, one
   K7 launch a batch and no plain search; ``[time]`` K4b against its plain
   version, bound and cuDNN, and by phase (``K4B_PHASES``: the h_prev
   gather, the gate pass, the chain, the GEMM core's launches, dW's reduce
   pass; profiler); ``[k4b-batch]`` K4b at B = 8 (mixed lengths) and 64 on
   clusters of 2 and of 4 CTAs in turns (``bwd_other_c``); the warm train
   step; ``[profile]`` its device time by kernel;
10. unidirectional GRU layers: the flagship with ``UNIDIRECTIONAL``
   overrides (every GRU layer one direction of H = 128): ``[k5f]``/``[k5b]``
   K5f and K5b against their plain versions at the five layer shapes, B =
   16 and 64, B = 8 with mixed lengths (0 and 1 among them, zeros past
   each), an odd small shape; ``[uni]`` ``decode_intents`` at B = 1 and 16
   against the CPU (5 K5f launches a call, no K1 or K4f) and a length-exact
   (8, 4 s) decode against each row's exact-shape decode; ``[serve]`` an
   ``IntentServer`` answering phase 7's traffic; ``[uni-step]`` one train
   step card vs CPU as phase 6's; ``[uni-trainer]`` ``Trainer.train`` at B =
   64 with 5 K5f and 5 K5b launches a step and no other GRU kernel;
   ``[time]`` K5f (B = 16; B = 8 masked) and K5b (B = 64) per layer against
   plain, bound and a unidirectional cuDNN ``nn.GRU``, K5f's us a step, K5b
   by phase (``K5B_PHASES``) and ``[k5b-batch]`` on clusters of 2 and of 4
   at B = 64;
   ``[k5f-batch]`` K5f's five layers back to back at B = 16, masked B = 8
   and B = 64, each at the cluster size it takes there; the warm decode and
   train step; ``[profile]`` the train
   step's device time by kernel;
11. the exact-shape eval path's two routes: ``[k8]`` K8 (the fused sinc
   front end) against its plain version (the cuDNN conv, |.|, ceil max
   pool, act) at the flagship front end (B = 1, 16, 128 on 4 s, 16 on
   3.3 s, ReLU, 300 on 1 s, phase 12's test pass, 64 on 2.25 s, and phase
   13's data-parallel test, 8 on 4 s) and
   the JAX tests' small shapes, within
   ``CONV_RTOL`` of the largest output; ``[time]`` K8's launch plan, K8,
   plain, one cuDNN conv alone and the bound at B = 1, 16, 128, with the
   share of the bound reached, by graph replays of one call (the kernels
   line's numbers) and of 10 calls (amortized, also in the line);
   ``[ab-frontend]`` the A/B of the two front-end routes (alone, by device
   time and by the host's time to enqueue it, then the warm decode) in
   turns P, C, C, P that sets the
   default; ``[k6]`` K6 (K1's row-stacked layout) against its plain version
   and K1 at the five layer shapes, B = 1 and 16, pool 1/2 avg/max, with its
   cluster size and
   ``[ab-layout]`` K1 against K6 in turns, then the warm decode; ``[time]``
   K6, plain, cuDNN ``nn.GRU`` and bound; ``[routes]`` the flagship decode
   at B = 1 and 16 through K8 and K6 (1 K8 and 5 K6 launches a call, no
   K1), logits within ``LOGIT_ATOL`` of the CPU's;
12. ASR pre-training at the width of ``no_unfreezing.cfg``
   (``pretraining_type`` 2, 42 phonemes, 10,000 words, seeded random
   weights): ``[asr]`` K1, K2 and K3 against their plain versions at the
   main path's own shapes (B = 64, the four encoder layers at 2.25 s,
   ``asr_shapes``) with phases 3 and 6's holds, then one train step
   (dropout on) on 2.25 s at B = 16 and at B = 64 on the card against the
   CPU plain path, the loss within ``STEP_LOSS_ATOL``, every gradient
   within ``GRAD_TOL`` of its largest element (the front end's against an
   f64 step on the card's front-end branches); ``[asr-trainer]`` ``Trainer(PretrainedModel).train`` over seeded batches
   of B = 64 (``asr_batches``: -1 labels, two weight-0 rows a batch) with 4
   K2 and 4 K3 launches a step and no other GRU kernel, then
   ``Trainer.test`` with 1 K8 and 4 K1 a batch (the kernels line's
   ``launches_asr_train``/``launches_asr_test``), and ``[asr-test]`` its
   first batch's four values and posteriors against a CPU copy's plain
   path (``asr_eval_vs_cpu``: logits within ``LOGIT_ATOL``); ``[asr-serve]``
   ``save_checkpoint``, a ``Model(config)`` whose encoder loads
   ``pretraining/model_state.npz`` bit-equal to the trained one, one SLU
   epoch, ``save_checkpoint`` and ``load_trained_model``, whose decode at
   B = 16 equals the in-memory model's; ``[time]`` the warm ASR step at B =
   64 (median, min and max of 10) and its ``[profile]``; ``[asr-cli]`` ``python -m tpu_slu_torch.cli``
   in subprocesses on the card, ``--pretrain``, ``--train``, ``--train
   --restart``, ``--decode``, with the flagship cfg cut to ``CLI_CUTS`` on
   the tiny tree of ``write_cli_tree``, each file written and read back;
13. data-parallel training and evaluation (``tpu_slu_torch.parallel``) and
   the first-epoch trace: ``[dp-kernels]`` K1, K2 and K3 against their
   plain versions at the batches a rank gives them here (B = 8 and 32) at
   the flagship's five layer shapes on 4 s and the ASR encoder's four on
   2.25 s (``hold_gru_layer``, phases 3 and 6's limits); ``[dp-world1]``
   three ``Trainer`` steps of the ``no_unfreezing.cfg`` fixed-slot model at
   B = 64 on 4 s under an NCCL group of one rank (``init_from_env``) equal
   three steps of a Trainer made without a group, bit for bit (parameters
   and Adam state; cuDNN deterministic for both), at 1 K1, 4 K2 and 5 K3
   launches a step, the two steps' kernels by the profiler and their
   difference, and both warm steps in turns P, C, C, P; ``[dp-2rank]`` two ranks (``python3 chip_smoke.py
   --dp-rank``) on the one card over gloo on CUDA tensors (NCCL refuses two
   ranks on one GPU), 32 rows each of a 64-row batch with a weight-0 row,
   one step of the fixed-slot model on 4 s and of the ASR model
   (``pretraining_type`` 2, 2.25 s, the ranks' valid frames unequal): the
   ranks' gradients and parameters bit-equal, and against the one-process
   B = 64 step every gradient within ``STEP_GRAD_TOL`` of its largest
   element and the parameters within ``STEP_PARAM_ATOL`` where the first
   Adam step's sign is settled; ``[dp-test]`` a 2-rank ``Trainer.test`` of
   the ``all_real_seq2seq.cfg`` model at ``decode_acc_from_epoch`` 0 on 32
   utterances of 1.0-4.0 s against the one-process test: the loss within
   1e-5 relative, every decoded string equal, each batch's decode a CUDA
   graph's replay, one K7 launch a capture (its eager warm pass) on each
   rank; ``[profile-dir]`` epoch 0 of ``Trainer.train`` with
   ``profile_dir`` set: its trace's CUDA kernel events name K1, K2 and K3
   as often as their launch counters count, and epoch 1 writes no trace;
14. ``compute_dtype=bfloat16`` (``[bf16]``): first ``[bf16-core]``, the
   bf16 GEMM core on the tensor cores (``gemm_kernel_tc``: bf16 ``mma.sync``,
   f32 accumulation) in each mode at the flagship's shapes, K3's gi and gh
   (both directions) and dX at its five layers (B = 64) and K6's row-stacked
   gi at its five (B = 16), each product within (K + 2) 2^-23 sum|a||b| of
   the f64 product of its bf16 operands (dX also within a bf16 spacing of
   each rounding, 99% of it equal to the plain version's), a second call
   equal bit for bit; timed beside its plain version, one ``torch.mm`` a
   product on the same bf16 operands and the bound (the kernels line's
   ``bigru_gemm_bf16``, whose launches are the fixed-slot trainer's below;
   the ASR, seq2seq, unidirectional and row-stacked trainers' beside them);
   and the f32 core (``gemm_kernel``) by mode, gi/gh, dX and dW, on f32
   copies of the same operands beside one f32 ``torch.mm`` a product.
   Then K1, K2 and K3's bf16
   instantiations against their plain versions on the card (K1 at the five
   flagship layers, B = 16, 4 s; K2 at the four encoder layers and K3 at
   the five, B = 64, 4 s; all three at the ASR encoder's four, B = 64,
   2.25 s), each output and gradient within ``BF16_RATIO`` of the plain
   version's bf16-vs-f32 gap (relative Frobenius distance) and
   ``BF16_ULPS`` of its largest element; one bf16 train step of the
   fixed-slot and of the ASR model (B = 16) against the CPU's, the loss
   within ``BF16_LOSS_RTOL``, the ASR gradient within ``BF16_FLOOR`` times
   the noise floor of bf16 (two CPU bf16 steps on inputs a few f32 ulps
   apart), the fixed-slot one within ``BF16_STEP_FAR`` (its max over time
   jumps; ``bf16_step_vs_cpu`` says why); ``[bf16-trainer]`` ``Trainer.train`` and
   ``Trainer.test`` at ``compute_dtype=bfloat16``, fixed-slot (B = 64: 1
   K1, 4 K2, 5 K3 a step, all bf16; the test pass 5 bf16 K1 a batch) and
   ASR (4 K2, 4 K3 a step); ``[time]`` both warm steps at bf16 beside f32
   in turns, with their busy time, idle share and launches, the bf16
   step's trace naming the bf16 K1, K2 and K3 as often as their counters
   count, and K1 (five layers, B = 16), K2 (four, B = 64) and K3 (five,
   B = 64) at bf16 beside f32 in turns, with the bf16 plain version, cuDNN's
   bf16 ``nn.GRU`` and the bf16 bound (``bound_bf16``: the products at the
   bf16 tensor-core peak, the gate math at the f32 one, the streams at 2
   bytes a value); the kernels line gains the three bf16 entries. Each
   bf16 trainer launches the bf16 core once for each bf16 GRU kernel's
   projections and once more for each backward's dX, 15 a step (ASR 12),
   counted where the library launches it (``ops/bigru_gemm.py``
   ``tc_launches``), and each bf16 step's trace names it so often by mode
   and holds no FMA product but dW's. Its
   second half (``phase_bf16_more``) does the same for K6, K4f, K4b, K5f
   and K5b: ``[bf16-k6]`` K6 at the five flagship layers (B = 16) and the
   train intent layer (B = 64), ``[bf16-k4f]`` K4f at the served (8, 4 s)
   shape with mixed lengths and the seq2seq encoder layer (B = 64, T = 25,
   D = 256), ``[bf16-k4b]`` K4b at that layer, ``[bf16-k5f]`` and
   ``[bf16-k5b]`` at the unidirectional flagship's five layers (B = 64),
   each within ``BF16_RATIO`` of its plain version's gap; one bf16 step of
   the seq2seq model (B = 64, U = 32) and of the unidirectional one (B = 64)
   against the CPU within ``BF16_FLOOR`` times the noise floor (the
   unidirectional one, a fixed-slot loss, within ``BF16_STEP_FAR``) and of
   the fixed-slot model on the row-stacked layout (B = 16, within
   ``BF16_STEP_FAR``); ``[bf16-trainer]`` the three models' ``Trainer.train``
   and ``Trainer.test`` at bf16, B = 64 (seq2seq: 4 K2, 4 K3, 1 K4f, 1 K4b a
   step, 4 K1 and 1 K4f a test batch; unidirectional: 5 K5f, 5 K5b a step, 5
   K5f a test batch; row-stacked: 1 K6, 4 K2, 5 K3 a step, 5 K6 a test
   batch; all bf16); ``[time]`` each warm step beside its f32 twin in turns
   (busy, idle share, launches; the bf16 trace's recurrences all bf16, as
   many as counted) and each kernel at bf16 beside f32, its plain version,
   cuDNN's bf16 ``nn.GRU`` and its bf16 bound; the kernels line gains their
   five bf16 entries, and the f32 entries of K6, K4f, K4b, K5f and K5b their
   bf16 errors;
15. model parallelism (``tpu_slu_torch.parallel`` ``mesh`` and ``vocab``,
   ``model_parallel`` 2): ``[mp-kernels]`` K1, K2 and K3 against their
   plain versions at the batches a rank gives them (B = 64 and 32) at the
   ASR encoder's four layer shapes on 2.25 s; ``[mp-1x2]`` and ``[mp-2x2]``
   2 and 4 ranks (``python3 chip_smoke.py --mp-rank``) on the one card over
   gloo on CUDA tensors, a (1, 2) and a (2, 2) grid, the ASR model of
   ``no_unfreezing.cfg`` (``pretraining_type`` 2, 42 phonemes and 10,000
   words, both heads column-sharded), one step on a data index's share of
   a 64-row batch on 2.25 s: the ranks' gradients and parameters (heads
   gathered) bit-equal, and against the one-process B = 64 step every
   gradient within ``STEP_GRAD_TOL`` of its largest element and the
   parameters within ``STEP_PARAM_ATOL`` where the first Adam step's sign
   is settled, at 4 K2 and 4 K3 launches a rank's step; ``[mp-test]`` each
   grid's ``Trainer.test`` on two 64-row batches within ``MP_TEST_RTOL`` of
   one process's, at 4 K1 and 1 K8 a rank's batch (the kernels line's
   ``launches_mp_step``/``launches_mp_test``); ``[time]`` each rank's warm
   step beside the one-process step in turns P, C, C, P.

Beside each kernel's time the script prints its plain version's, a cuDNN
``torch.nn.GRU`` call's where one computes the same function (timed as a
yardstick only: forward at the unpooled shapes for K1, on packed rows for
K4f, the backward for K3, K4b and K5b, one direction's forward for K5f;
for K2 the nearest call, the unpooled forward without its dropout and
h_prev; none for K7; one cuDNN conv for K8, without the |.|, pool and act
it fuses),
and its bound: the larger of the f32 operations over 67 TFLOP/s and the
bytes over 3.35 TB/s (each input read once, each output written once),
ignoring the serial chain. At the end it checks that no module of JAX or
of the JAX package was loaded.

The last lines are the card's name and power limit, one JSON object on the
kernels, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = RTOL = 1e-4  # K1 vs plain, f32: the sums run in another order
LOGIT_ATOL = 1e-3  # whole slice, card vs CPU: errors compound over 5 GRU layers
CONV_RTOL = 1e-5  # f32 conv vs f64, of the largest output; TF32 (10-bit mantissa) is ~1e-3 off
GOLDEN = os.path.join(HERE, "tests", "assets", "golden")
K1_SOURCE = "tpu_slu_torch/csrc/bigru_shared_fwd.cu"
K1_REPLACES = "tpu_slu/ops/pallas_gru.py:771"
K2_SOURCE = "tpu_slu_torch/csrc/bigru_trainpool_fwd.cu"
K2_REPLACES = "tpu_slu/ops/pallas_gru.py:1146"
K3_SOURCE = "tpu_slu_torch/csrc/bigru_shared_bwd.cu"
K3_REPLACES = "tpu_slu/ops/pallas_gru.py:1293"
# K3's kernels by phase: the gate pass, the dh chain (the backward cluster recurrence of
# gru_cluster_bwd.cuh, K4b's and K5b's, with its SPLIT flag), the GEMM core in its three layouts (gi
# and gh; dX; dW and db), dW's reduce pass
K3_PHASES = {"gates": "bwd_gates_kernel", "chain": "gru_cluster_bwd_kernel", "core gi/gh": "gemm_kernel<0, 0",
             "core dX": "gemm_kernel<0, 1", "core dW": "gemm_kernel<1, 1", "reduce": "dw_reduce_kernel"}
# K3 vs plain, of each tensor's largest element: f32 sums over up to 25,600 rows, another order
GRAD_TOL = 1e-4
STEP_LOSS_ATOL = 1e-4  # one train step, card vs CPU: loss
STEP_GRAD_TOL = 1e-3  # ... each gradient, of its tensor's largest element (errors compound over 5 layers)
STEP_PARAM_ATOL = 1e-5  # ... parameters after masked Adam from equal gradients
# the flagship's bi-GRU layers: name, part width, parts, T at 4 s of audio
ENC_SHAPES = [("phone_rnn0", 60, 1, 400), ("phone_rnn1", 128, 2, 200),
              ("word_rnn0", 128, 2, 100), ("word_rnn1", 128, 2, 50)]
INTENT_SHAPE = ("intent_rnn0", 256, 1, 25)
# the five bi-GRU layers of a flagship decode at 4 s: name, part width, parts, T, pool
FLAGSHIP_LAYERS = [(*s, 2) for s in ENC_SHAPES] + [(*INTENT_SHAPE, 1)]
K1_STEPS = sum(T for *_, T, _ in FLAGSHIP_LAYERS)  # serial steps of the five layers: 775
K4F_SOURCE = "tpu_slu_torch/csrc/bigru_masked_fwd.cu"
K4F_REPLACES = "tpu_slu/ops/pallas_gru.py:323"
EXACT_LOGIT_ATOL = 1e-4  # length-exact (K4f) vs exact-shape (K1) decode on the card, same weights
K7_SOURCE = "tpu_slu_torch/csrc/beam_decode.cu"
K7_REPLACES = "tpu_slu/ops/pallas_beam.py:152"
K4B_SOURCE = "tpu_slu_torch/csrc/bigru_masked_bwd.cu"
K4B_REPLACES = "tpu_slu/ops/pallas_gru.py:400"
# K4b's and K5b's kernels by phase (one source, one set of kernels): the h_prev gather, the gate
# pass, the dh chain (the backward cluster recurrence of gru_cluster_bwd.cuh), the GEMM core in its
# three layouts, dW's reduce pass
K4B_PHASES = {"h_prev": "masked_hprev_kernel", "gates": "bwd_gates_kernel", "chain": "gru_cluster_bwd_kernel",
              "core gi/gh": "gemm_kernel<0, 0", "core dX": "gemm_kernel<0, 1", "core dW": "gemm_kernel<1, 1",
              "reduce": "dw_reduce_kernel"}
K5B_PHASES = K4B_PHASES
# K3's kernels by phase at bf16: the same, the products on the core's mixed kernel, and dX's
# rounded sum of the two directions
K3_BF16_PHASES = {"gates": "bwd_gates_kernel", "chain": "gru_cluster_bwd_kernel",
                  "core gi/gh": "gemm_kernel_tc<0, 0",
                  "core dX": "gemm_kernel_tc<0, 1", "dX sum": "dx_pair_sum_kernel",
                  "core dW": "gemm_kernel_mixed<1, 1", "reduce": "dw_reduce_kernel"}
# K4b's and K5b's kernels by phase at bf16: the same, the products on the core's mixed kernel
# (dW_hh's on the f32 one: it reads the widened h_prev), and K4b's rounded dX sum
K4B_BF16_PHASES = {"h_prev": "masked_hprev_kernel", "gates": "bwd_gates_kernel", "chain": "gru_cluster_bwd_kernel",
                   "core gi/gh": "gemm_kernel_tc<0, 0", "core dX": "gemm_kernel_tc<0, 1",
                   "dX sum": "dx_pair_sum_kernel", "core dW_ih": "gemm_kernel_mixed<1, 1",
                   "core dW_hh": "gemm_kernel<1, 1", "reduce": "dw_reduce_kernel"}
K5F_SOURCE = "tpu_slu_torch/csrc/bigru_masked_fwd.cu"
K5F_REPLACES = "tpu_slu/ops/pallas_gru.py:138"
K5B_SOURCE = "tpu_slu_torch/csrc/bigru_masked_bwd.cu"
K5B_REPLACES = "tpu_slu/ops/pallas_gru.py:189"
K8_SOURCE = "tpu_slu_torch/csrc/sinc_frontend.cu"
K8_REPLACES = "tpu_slu/ops/pallas_frontend.py:45"
K6_SOURCE = "tpu_slu_torch/csrc/bigru_shared_fwd.cu"
K6_REPLACES = "tpu_slu/ops/pallas_gru.py:887"
# the unidirectional flagship's GRU layers at 4 s of audio: name, input width D, T
UNI_SHAPES = [("phone_rnn0", 60, 400), ("phone_rnn1", 128, 200), ("word_rnn0", 128, 100),
              ("word_rnn1", 128, 50), ("intent_rnn0", 128, 25)]
S2S_U = 32  # label steps of the seq2seq train step: the JAX bench's train shape (bench.py:879-896)
# the attention's key bias shifts every frame's score alike, which the softmax cancels: its
# gradient is 0 in exact arithmetic, and it is held against the key weight's gradient's scale
KEY_BIAS, KEY_WEIGHT = "decoder.attention.key_linear.bias", "decoder.attention.key_linear.weight"
SERVE_BATCH = 8  # the IntentServer's max_batch: a served batch is (8, 4 s bucket)
# the card's published peaks at 700 W (NVIDIA H100 SXM data sheet): f32 outside the
# tensor cores, and HBM3
PEAK_F32 = 67e12
PEAK_BF16 = 989e12  # dense bf16 tensor-core products, f32 accumulation
PEAK_BYTES = 3.35e12
GATE_OPS = 20  # f32 operations per gate element and direction: 2 sigmoids, a tanh, ~8 adds and products


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# Developer copies of one kernel source each, for the A/Bs and the K7 trace: name -> (source in
# tpu_slu_torch/csrc, [(text, its replacement)], nvcc flags). Never the port's library.
_RULE_2DIR = "*C = (ndir == 1 ? 4 * B <= sms : 4 * 8 * B <= 3 * sms) ? 4 : 2;"
_TILE_C4 = ("if (C == 4) return nb == 1 ? launch_gru_cluster<4, 1, POOL, TRAIN, ROWS, TS>(a, ndir, st) : "
            "cudaErrorInvalidValue;")
# the two-direction cluster recurrence (K1, K2, K4f) on the cluster size the rule does not pick
# (2 <-> 4), with the 4-row tile C = 4 then takes at B = 64; only the ndir = 2 branch changes
_OTHER_C = [(_RULE_2DIR, _RULE_2DIR.replace("4 * 8 * B <= 3 * sms", "4 * 8 * B > 3 * sms")),
            (_TILE_C4, _TILE_C4.replace(" : cudaErrorInvalidValue", " : nb == 4 ? launch_gru_cluster<4, 4, POOL, "
                                                                    "TRAIN, ROWS, TS>(a, ndir, st) : cudaErrorInvalidValue"))]
# the backward chain (K3, K4b, K5b) on the cluster size its rule does not pick, with the 2- and 4-row
# tiles C = 4 then takes at B = 64 (K5b; K3 and K4b)
_RULE_BWD = "cudaError_t err = gru_cluster_size(a.B, ndir, &C);"
_TILE_BWD_C4 = ("if (C == 4) return nb == 1 ? launch_gru_cluster_bwd<4, 1, BF, SPLIT>(a, ndir, st) : "
                "cudaErrorInvalidValue;")
_BWD_OTHER_C = [(_RULE_BWD, _RULE_BWD + "\n  C = 6 - C;"),
                (_TILE_BWD_C4, _TILE_BWD_C4.replace(
                    " : cudaErrorInvalidValue", " : nb == 2 ? launch_gru_cluster_bwd<4, 2, BF, SPLIT>(a, ndir, st) : "
                    "nb == 4 ? launch_gru_cluster_bwd<4, 4, BF, SPLIT>(a, ndir, st) : cudaErrorInvalidValue"))]
VARIANTS = {
    "k1_other_c": ("bigru_shared_fwd.cu", _OTHER_C, []),
    "k2_other_c": ("bigru_trainpool_fwd.cu", _OTHER_C, []),
    "k4f_other_c": ("bigru_masked_fwd.cu", _OTHER_C, []),
    "bwd_other_c": ("bigru_masked_bwd.cu", _BWD_OTHER_C, []),
    # the same edits in K3's library: a variant compiles one source
    "k3_other_c": ("bigru_shared_bwd.cu", _BWD_OTHER_C, []),
    # K7 recording its first utterance's clocks by phase (tsl_beam_trace)
    "k7_trace": ("beam_decode.cu", [], ["-DTSL_TRACE"]),
}


def start_variant(name: str, source: str, edits, flags) -> tuple[subprocess.Popen, str]:
    """Start compiling a copy of ``tpu_slu_torch/csrc`` with ``edits`` (each
    text in exactly one file of it, every occurrence replaced) as the shared
    library of ``source`` alone, with nvcc ``flags``, into
    ``build/variants/<name>.so``. Returns the process and the path."""
    from tpu_slu_torch.ops import _build

    out_dir = os.path.join(HERE, "build", "variants", name)
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, out_dir)
    texts = {}
    for fn in os.listdir(out_dir):
        with open(os.path.join(out_dir, fn)) as f:
            texts[fn] = f.read()
    for old, new in edits:
        where = [fn for fn, t in texts.items() if old in t]
        if len(where) != 1:
            raise SystemExit(f"variant {name}: {old!r} is in {where or 'no file'} of tpu_slu_torch/csrc")
        texts[where[0]] = texts[where[0]].replace(old, new)
    for fn, t in texts.items():
        with open(os.path.join(out_dir, fn), "w") as f:
            f.write(t)
    path = f"{out_dir}.so"
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", *flags, "-shared", "-Xcompiler",
           "-fPIC", "-o", path, os.path.join(out_dir, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), path


def load_variant(name: str, proc: subprocess.Popen, path: str):
    """Wait for ``start_variant``'s build and load it, its entry points
    typed as the port's library types them."""
    import ctypes

    from tpu_slu_torch.ops import _build

    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name} failed to compile ({proc.returncode}):\n{err}")
    lib = ctypes.CDLL(path)
    sigs = {**_build._SIGNATURES, "tsl_beam_trace": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_int])}
    for fn, (restype, argtypes) in sigs.items():
        if hasattr(lib, fn):
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
    return lib


def cuda_times(fn, reps: int, warmup: int = 2) -> list[float]:
    """Device time of each of ``reps`` warm calls of ``fn`` in ms, CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call."""
    return statistics.median(cuda_times(fn, reps, warmup))


def k1_case(rng, n_parts, d, T, B, H, dev):
    """Random K1 inputs: (params on dev, parts on dev)."""
    import torch

    bound = 1.0 / H ** 0.5
    D = n_parts * d

    def u(*shape):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype("float32")).to(dev)

    params = {k: {"weight_ih": u(3 * H, D), "weight_hh": u(3 * H, H), "bias_ih": u(3 * H),
                  "bias_hh": u(3 * H)} for k in ("fwd", "bwd")}
    parts = tuple(torch.from_numpy(rng.standard_normal((T, B, d)).astype("float32")).to(dev)
                  for _ in range(n_parts))
    return params, parts


def same_zeros(g, r) -> bool:
    """The dropout zero pattern of ``g`` is ``r``'s: a window dropped whole
    is exactly 0 in both. A sum of kept values may cancel to exactly 0 in one
    version only, so such a position may differ if both are within 1e-6 of 0."""
    import torch

    differ = (g == 0) != (r == 0)
    return not differ.any() or torch.maximum(g.abs(), r.abs())[differ].max().item() <= 1e-6


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the
    operations over the f32 peak and the bytes over the memory rate; and
    which of the two binds. Ignores the serial chain of the recurrence."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_bf16(product_flops: float, other_flops: float, nbytes: float) -> tuple[float, str]:
    """``bound`` for work on bf16 operands: the products (bf16 x bf16,
    accumulated in f32) at the bf16 tensor-core peak, the rest (the gate
    math) at the f32 peak, against the bytes over the memory rate."""
    t_ops = (product_flops / PEAK_BF16 + other_flops / PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gru_weight_floats(D: int, H: int, dirs: int = 2) -> int:
    return dirs * (3 * H * D + 3 * H * H + 6 * H)


def gru_fwd_work(rows: int, D: int, H: int, in_floats: int, out_floats: int,
                 dirs: int = 2, stream_bytes: int = 4) -> tuple[float, float]:
    """FLOPs and bytes of a GRU layer's forward over ``rows`` (t, b) rows of
    width D and ``dirs`` directions: per row and direction the input
    projection and the recurrent product (2 * 3H * (D + H)) and the gate
    math (GATE_OPS per element); each input read once, each output written
    once, the f32 weights and the streams at ``stream_bytes`` a value (2 at
    bf16)."""
    flops = dirs * rows * (2 * 3 * H * (D + H) + GATE_OPS * H)
    return flops, stream_bytes * (in_floats + out_floats) + 4 * gru_weight_floats(D, H, dirs)


def cudnn_gru_ms(D: int, T: int, B: int, H: int, dev, lengths=None, backward=False,
                 bidirectional=True, dtype=None) -> float:
    """Median ms of one cuDNN ``torch.nn.GRU`` call at (T, B, D), a
    yardstick the port never calls; with ``lengths``, over
    ``pack_padded_sequence`` of the rows with n_b > 0 (it takes no empty
    row); ``backward``: the backward alone, input and weight gradients;
    ``dtype`` (default f32) the GRU's and its input's. Its input comes from a
    generator of its own, so that the phases' seeded data do not depend on
    which yardsticks ran."""
    import numpy as np
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    dtype = dtype or torch.float32
    gru = torch.nn.GRU(D, H, bidirectional=bidirectional).to(dev, dtype)
    x = np.random.default_rng(T * B + D).standard_normal((T, B, D)).astype("float32")
    x = torch.from_numpy(x).to(dev, dtype)
    if backward:
        x.requires_grad_()
        out, _ = gru(x)
        cot = torch.randn_like(out)
        return cuda_ms(lambda: out.backward(cot, retain_graph=True), reps=10, warmup=2)
    if lengths is not None:
        keep = [b for b, n in enumerate(lengths) if n > 0]
        x = pack_padded_sequence(x[:, keep], torch.tensor([lengths[b] for b in keep]),
                                 enforce_sorted=False)
    with torch.inference_mode():
        return cuda_ms(lambda: gru(x), reps=20, warmup=3)


def graph_ms(fn, reps: int = 20, calls: int = 1) -> float:
    """Device time of ``fn`` a call in ms: ``calls`` calls of ``fn`` captured
    once into a CUDA graph, then the median of ``reps`` replays between CUDA
    events, over ``calls``. A replay runs ``fn``'s kernels back to back, so a
    route of many small launches is not charged for the host's enqueueing,
    which CUDA events around a plain call would include; ``calls`` > 1
    spreads the replay's own launch over the calls."""
    import torch

    def body():
        for _ in range(calls):
            fn()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return cuda_ms(graph.replay, reps=reps, warmup=2) / calls


def host_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """Median host time of ``fn`` in ms, the clock around each call, the
    device drained between calls: what the host spends enqueueing a call
    that does not wait for the device."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - start))
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps: int = 10, name: str | None = None) -> float:
    """Device time of ``fn`` a call in ms, from ``torch.profiler`` over
    ``reps`` warm calls: the sum of the kernels' own times (of those whose
    name holds ``name``, if given). Host gaps between launches are not
    counted, so a route of many small launches is not charged for the
    host's enqueueing, which CUDA events around the call would include."""
    return device_split(fn, {"kernels": name or ""}, reps)["kernels"]


def device_split(fn, names: dict, reps: int = 5) -> dict:
    """Device time a call in ms of the kernels whose names hold each value of
    ``names`` (a string or a tuple of strings; the first key that matches),
    keyed as ``names``, from ``torch.profiler`` over ``reps`` warm calls;
    "other" holds the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {n: 0.0 for n in (*names, "other")}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue
        key = next((k for k, n in names.items() if any(v in e.key for v in ((n,) if isinstance(n, str) else n))),
                   "other")
        split[key] += e.self_device_time_total / reps / 1e3
    if not any(split[k] for k in names):
        raise AssertionError(f"the profiler saw none of {list(names.values())}")
    return split


def kernel_table(fn, reps: int = 10) -> tuple[float, dict]:
    """(traced wall ms a call, {kernel name: (launches a call, device ms a
    call)}) of ``reps`` warm calls of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    return wall, {e.key: (e.count / reps, e.self_device_time_total / reps / 1e3) for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)}


def counted_trace(fn, reset, check, what: str, tries: int = 3) -> tuple[float, dict, int]:
    """``kernel_table(fn, reps=3)`` of a trace that holds what the launch
    counters count: ``reset()`` zeroes the counters before each trace, and
    ``check(table)`` returns None, or (message, short): short when the trace
    only lacks launches the counters counted. The profiler drops kernel
    events now and then late in a long process (the whole smoke's bf16
    fixed-slot trace once missed 2 of 12 K2 launches), which would also
    under-report the busy time read from it, so a short trace is taken again,
    up to ``tries`` times, each shortfall printed; any other mismatch, or
    the last short trace, raises. Returns (wall, table, traces taken)."""
    for attempt in range(1, tries + 1):
        reset()
        wall, table = kernel_table(fn, reps=3)
        fault = check(table)
        if fault is None:
            return wall, table, attempt
        message, short = fault
        if not short or attempt == tries:
            raise AssertionError(f"{what}: {message}")
        print(f"[profile] {what}: trace {attempt} of {tries} is short of the counted launches: {message}")
    raise AssertionError(what)  # not reached


def profile_calls(fn, what: str, card: str, reps: int = 10, top: int = 8) -> None:
    """Trace ``reps`` warm calls with ``torch.profiler``: device busy time a
    call, the device's idle share of the traced wall time, and the kernels
    that take the most device time."""
    wall, kernels = kernel_table(fn, reps)
    busy = sum(ms for _, ms in kernels.values())
    launches = sum(n for n, _ in kernels.values())
    print(f"[profile] {what}: traced wall {wall:.3f} ms a call, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {launches:.0f} kernel launches a call, on {card}")
    for key, (n, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"[profile]   {ms:8.4f} ms  {n:5.1f} launches  {key[:80]}")


def rel_err(g, r) -> float:
    """Largest |g - r| over the largest |r|."""
    return (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)


def in_turns(plain_fn, kernel_fn, rounds: int = 2) -> tuple[float, float]:
    """Median ms of the kernel and of its plain version, timed in turns."""
    plain, kern = [], []
    for _ in range(rounds):  # plain, kernel, kernel, plain, ...
        plain.append(cuda_ms(plain_fn, reps=1, warmup=0))
        kern.append(cuda_ms(kernel_fn, reps=10, warmup=1))
        kern.append(cuda_ms(kernel_fn, reps=10, warmup=0))
        plain.append(cuda_ms(plain_fn, reps=1, warmup=0))
    return statistics.median(kern), statistics.median(plain)


class Batches:
    """A dataset in the port Trainer's format: ``.loader`` yields batches."""

    def __init__(self, batches):
        self.loader = batches


def graph_counts(model) -> tuple[int, int]:
    """(captures, replays) of the model's length-exact decode graphs
    (``models/decode_graph.py``): a served call replays its shape's graph,
    and the wrappers count the launches of a capture's eager warm pass."""
    return model.decode_graphs.captures, model.decode_graphs.replays


def serve_requests(server, reqs, threads: int = 8) -> tuple[list, dict]:
    """Submit ``reqs`` to a warmed-up ``IntentServer`` from ``threads`` client
    threads, each its share in turn; returns ([(i, answer, submit-to-answer
    ms)], device calls by requests carried)."""
    import concurrent.futures as cf

    import torch

    server.batch_sizes.clear()

    def ask(chunk):
        out = []
        for i in chunk:
            t0 = time.perf_counter()
            out.append((i, server.decode(reqs[i]), (time.perf_counter() - t0) * 1e3))
        return out

    with cf.ThreadPoolExecutor(threads) as pool:
        answers = [a for part in pool.map(ask, [range(k, len(reqs), threads) for k in range(threads)])
                   for a in part]
    torch.cuda.synchronize()
    return answers, dict(server.batch_sizes)


def synthetic_batches(rng, n: int, B: int, values_per_slot) -> list[dict]:
    """Seeded 4 s waveforms and slot labels, in the loader's batch format."""
    import numpy as np

    T = 4 * 16000
    return [{"x": (0.1 * rng.standard_normal((B, T))).astype(np.float32),
             "y_intent": np.stack([rng.integers(0, v, B) for v in values_per_slot], 1),
             "w": np.ones(B, np.float32), "len": np.full(B, T, np.int64)} for _ in range(n)]


def front_end_params(model) -> set:
    """The names of the front end's parameters in ``model`` (a
    ``PretrainedModel``, or a model that holds one as ``pretrained_model``):
    the sinc filters and the convs of ``phoneme_layers`` before its first
    GRU layer. Their gradients pass through the front end's branches (leaky
    ReLU signs, max-pool argmaxes; ``FrontEndBranches``), so the train step
    checks hold them against an f64 step on the card's branches: where the
    CPU's f32 step takes another branch than the card's at one element, the
    two differ by a whole branch there (up to ~2.5e-3 of the largest
    element of the first conv's weight gradient at the ASR step's B = 64)."""
    enc = getattr(model, "pretrained_model", model)
    prefix = "pretrained_model." if enc is not model else ""
    first_gru = min(spec.index for spec in enc.arch.phoneme_layers if spec.kind == "gru")
    return {f"{prefix}phoneme_layers.{i}.{n}" for i, layer in enumerate(enc.phoneme_layers) if i < first_gru
            for n, _ in layer.named_parameters()}


def step_vs_cpu(dev, rng, tag: str, **overrides) -> None:
    """One whole train step of ``no_pretraining.cfg``'s model (``overrides``
    set on its config; the intent layer's dropout 0, the encoder's 0.5) at
    B = 16 on 4 s, card against the CPU plain path from equal weights and
    equal dropout masks: the loss within STEP_LOSS_ATOL, every gradient
    within STEP_GRAD_TOL of its largest element, the parameters after masked
    Adam from equal gradients within STEP_PARAM_ATOL. The front end's
    parameters' gradients (``front_end_params``: the sinc filters and the
    convs) are held against an f64 CPU step that replays the card's
    front-end branches (``FrontEndBranches``), so that a correct card cannot
    fail on a leaky ReLU input or a max-pool tie within rounding of its
    branch; each side's error against the f64 step on its own branches is
    printed beside it."""
    import torch

    from tpu_slu_torch.models.flagship import TRAIN_CFG, flagship_model
    from tpu_slu_torch.training import MaskedAdam

    cpu_model = flagship_model("cpu", cfg=TRAIN_CFG, intent_rnn_drop=[0.0], **overrides).train()
    card_model = copy.deepcopy(cpu_model).to(dev)
    b16 = synthetic_batches(rng, 1, 16, cpu_model.values_per_slot)[0]

    def step(model, where, dtype=torch.float32):
        batch = {k: torch.from_numpy(v).to(where) for k, v in b16.items()}
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch["x"].to(dtype), batch["y_intent"], train=True, weights=batch["w"].to(dtype),
                             lengths=batch["len"], generator=torch.Generator().manual_seed(5))
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    l_cpu, g_cpu = step(cpu_model, torch.device("cpu"))
    branches = FrontEndBranches()
    with branches.record():
        l_card, g_card = step(card_model, dev)
    m64 = copy.deepcopy(cpu_model).double()
    g64_own = step(m64, torch.device("cpu"), torch.float64)[1]
    with branches.replay():
        g64 = step(m64, torch.device("cpu"), torch.float64)[1]
    del m64
    front = front_end_params(cpu_model)
    g64 = {n: g for n, g in g64.items() if n in front}
    print(f"[{tag}] front-end branches (leaky ReLU signs, max-pool argmaxes) where the card's step and the "
          f"f64 step part: {branches.flips}")
    if not abs(l_card - l_cpu) <= STEP_LOSS_ATOL:
        raise AssertionError(f"{tag}: train step loss: card {l_card} vs CPU {l_cpu}")
    for n, r in g64.items():
        e_card, e_cpu = rel_err(g_card[n].cpu().double(), r), rel_err(g_cpu[n].double(), g64_own[n])
        print(f"[{tag}] {n} gradient vs f64 on the card's branches, of its largest element: card {e_card:.3g} "
              f"(on f64's own {rel_err(g_card[n].cpu().double(), g64_own[n]):.3g}); CPU f32 vs f64 {e_cpu:.3g}")
    worst = 0.0
    for n, g in g_cpu.items():
        if g is None:  # the encoder's phoneme/word heads take no part in the SLU loss
            assert g_card[n] is None, n
            continue
        e = rel_err(g_card[n].cpu().double(), g64[n]) if n in g64 else rel_err(g_card[n].cpu(), g)
        worst = max(worst, e)
        if not e <= STEP_GRAD_TOL:
            raise AssertionError(f"{tag}: train step: gradient of {n} off the {'f64' if n in g64 else 'CPU'} "
                                 f"reference's by {e:.3g} of its largest")
    # masked Adam from equal gradients: the first Adam step is lr * g / (|g| + eps),
    # ~lr * sign(g), so f32 noise on a near-zero gradient flips an update. How
    # many would differ from each side's own gradients is counted, not held.
    lr = cpu_model.config.training_lr
    flips = sum(int(((g_card[n].cpu() / (g_card[n].cpu().abs() + 1e-8) - g / (g.abs() + 1e-8)).abs()
                     * lr > STEP_PARAM_ATOL).sum()) for n, g in g_cpu.items() if g is not None)
    n_params = sum(p.numel() for p in cpu_model.parameters())
    for n, p in cpu_model.named_parameters():
        p.grad = None if g_card[n] is None else g_card[n].cpu()
    for model in (cpu_model, card_model):
        opt = MaskedAdam(model.named_parameters(), lr)
        opt.set_mask(model.trainable_mask())
        opt.step()
    card_params = dict(card_model.named_parameters())
    p_err = max((card_params[n].detach().cpu() - p.detach()).abs().max().item()
                for n, p in cpu_model.named_parameters())
    if not p_err <= STEP_PARAM_ATOL:
        raise AssertionError(f"{tag}: masked Adam: card vs CPU parameters off by {p_err:.3g}")
    print(f"[{tag}] train step B=16, 4 s audio, card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} "
          f"(atol {STEP_LOSS_ATOL}); every gradient within {worst:.3g} of its largest element, the front "
          f"end's of the f64 reference's on the card's branches, the others' of the CPU's (limit "
          f"{STEP_GRAD_TOL}); params after masked Adam from equal gradients within {p_err:.3g} "
          f"(atol {STEP_PARAM_ATOL}); from each side's own gradients {flips} of {n_params} would "
          f"differ by more than {STEP_PARAM_ATOL}")


def k1_layer(rng, dev, d: int, n_parts: int, T: int, B: int, pool: int, rowstack: bool = False):
    """K1 (K6 with ``rowstack``) at one flagship layer shape, called through a
    library's ``tsl_bigru_shared_fwd`` (``tsl_bigru_shared_fwd_rs``):
    ``(launch(lib) -> error code, check())``; ``check`` raises unless the
    last launch's outputs match the plain version."""
    import torch

    from tpu_slu_torch.ops.bigru_shared import (_part_ptrs, _ptrs, bigru_shared_reference,
                                                bigru_shared_rowstack_reference)

    params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
    gi = torch.empty((2, T, B, 384), device=dev)
    out = torch.empty((2, -(-T // pool), B, 128), device=dev)

    def launch(lib):
        fn = lib.tsl_bigru_shared_fwd_rs if rowstack else lib.tsl_bigru_shared_fwd
        return fn(*_part_ptrs(parts), *_ptrs(params), gi.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), T, B,
                  128, pool, 0, torch.cuda.current_stream(dev).cuda_stream)

    def check():
        ref = (bigru_shared_rowstack_reference if rowstack else bigru_shared_reference)(params, parts, pool=pool)
        if not all(torch.allclose(g, r, atol=ATOL, rtol=RTOL) for g, r in zip(out, ref)):
            raise AssertionError(f"{'K6' if rowstack else 'K1'} T={T} B={B} disagrees with its plain version")
    return launch, check


def k2_layer(rng, dev, d: int, n_parts: int, T: int, B: int):
    """K2 at one encoder layer shape (pool 2, dropout 0.5, a seeded mask),
    called through a library's ``tsl_bigru_trainpool_fwd``: ``(launch,
    check)`` as :func:`k1_layer`'s; ``check`` also holds the zero pattern."""
    import torch

    from tpu_slu_torch.ops.bigru_shared import _part_ptrs, _ptrs, bigru_trainpool_reference
    from tpu_slu_torch.ops.dropout import keep_threshold

    params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
    seed = int(rng.integers(2**32))
    gi = torch.empty((2, T, B, 384), device=dev)
    hp, pooled = torch.empty((2, T, B, 128), device=dev), torch.empty((2, -(-T // 2), B, 128), device=dev)

    def launch(lib):
        return lib.tsl_bigru_trainpool_fwd(*_part_ptrs(parts), *_ptrs(params), gi.data_ptr(), hp[0].data_ptr(),
                                           hp[1].data_ptr(), pooled[0].data_ptr(), pooled[1].data_ptr(), T, B,
                                           128, 2, seed, keep_threshold(0.5), 2.0,
                                           torch.cuda.current_stream(dev).cuda_stream)

    def check():
        ref = bigru_trainpool_reference(params, parts, pool=2, drop_p=0.5, seed=seed)
        if not (all(torch.allclose(g, r, atol=ATOL, rtol=RTOL) for g, r in zip((*hp, *pooled), ref))
                and all(same_zeros(g, r) for g, r in zip(pooled, ref[2:]))):
            raise AssertionError(f"K2 T={T} B={B} disagrees with its plain version")
    return launch, check


def k4f_layer(rng, dev, D: int, T: int, B: int):
    """K4f at one flagship layer shape with seeded mixed lengths (row 0 holds
    T, the last row of B > 1 holds 0), called through a library's
    ``tsl_bigru_masked_fwd``: ``(launch, check)`` as :func:`k1_layer`'s;
    ``check`` also holds exact zeros past each length."""
    import torch

    from tpu_slu_torch.ops.bigru_masked import bigru_masked_reference
    from tpu_slu_torch.ops.bigru_shared import _ptrs

    params, parts = k1_case(rng, 1, D, T, B, 128, dev)
    x = parts[0].transpose(0, 1).contiguous()
    lengths = rng.integers(1, T + 1, B)
    lengths[-1], lengths[0] = 0, T
    n = torch.from_numpy(lengths).to(dev)
    gi, out = torch.empty((2, B, T, 384), device=dev), torch.empty((B, T, 256), device=dev)

    def launch(lib):
        return lib.tsl_bigru_masked_fwd(x.data_ptr(), D, n.data_ptr(), *_ptrs(params), gi.data_ptr(),
                                        out.data_ptr(), T, B, 128, torch.cuda.current_stream(dev).cuda_stream)

    def check():
        ref = bigru_masked_reference(params, x, n)
        tail = torch.arange(T, device=dev)[None, :] >= n[:, None]
        if not (rel_err(out, ref) <= ATOL and (out[tail] == 0).all()):
            raise AssertionError(f"K4f T={T} B={B} lengths {lengths.tolist()} disagrees with its plain version")
    return launch, check


def bwd_layer(rng, dev, ndir: int, D: int, T: int, B: int, lengths=None):
    """K4b (``ndir`` 2) or K5b (1) at one layer shape, H = 128, seeded
    weights, input and cotangent, ``lengths`` (B,) or None for T in every
    row (K4b: all T), called through a library's ``tsl_bigru_masked_bwd``
    or ``tsl_gru1_bwd``: ``(launch, check)`` as :func:`k1_layer`'s;
    ``check`` holds dX and every weight and bias gradient within
    ``GRAD_TOL`` of its largest element, and dX exactly 0 past each length."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_masked import bigru_masked_bwd_reference, bigru_masked_fwd
    from tpu_slu_torch.ops.gru1 import gru1_bwd_reference, gru1_fwd

    H, names = 128, ("weight_ih", "bias_ih", "weight_hh", "bias_hh")
    params, parts = k1_case(rng, 1, D, T, B, H, dev)
    dirs = ("fwd", "bwd")[:ndir]
    params = {d: params[d] for d in dirs}
    x = parts[0].transpose(0, 1).contiguous()
    if ndir == 2 and lengths is None:
        lengths = [T] * B
    n = None if lengths is None else torch.from_numpy(np.asarray(lengths, np.int64)).to(dev)
    with torch.inference_mode():
        out = bigru_masked_fwd(params, x, n) if ndir == 2 else gru1_fwd(params, x, n)
    dy = torch.from_numpy(rng.standard_normal((B, T, ndir * H)).astype(np.float32)).to(dev)

    def empty(*shape):
        return torch.empty(shape, device=dev, dtype=torch.float32)

    dx = empty(B, T, D)
    grads = {d: {"weight_ih": empty(3 * H, D), "bias_ih": empty(3 * H), "weight_hh": empty(3 * H, H),
                 "bias_hh": empty(3 * H)} for d in dirs}
    scratch = [empty(ndir, B, T, H), empty(ndir, B, T, 3 * H), empty(ndir, B, T, 3 * H), empty(ndir, B, T, 4 * H),
               empty(_build.partial_floats(D, 0, H, B * T, ndir))]  # hp, buf_a, buf_b, gates, partial
    ptrs = ([x.data_ptr(), D, None if n is None else n.data_ptr(), out.data_ptr(), dy.data_ptr()]
            + [params[d][k].data_ptr() for d in dirs for k in names] + [dx.data_ptr()]
            + [grads[d][k].data_ptr() for d in dirs for k in names] + [t.data_ptr() for t in scratch])

    def launch(lib, scratch=scratch):  # holds the workspaces: the launch writes them by address
        entry = lib.tsl_bigru_masked_bwd if ndir == 2 else lib.tsl_gru1_bwd
        return entry(*ptrs, T, B, H, torch.cuda.current_stream(dev).cuda_stream)

    def check():
        rdx, rgrads = (bigru_masked_bwd_reference if ndir == 2 else gru1_bwd_reference)(params, x, out, n, dy)
        pairs = [("dX", dx, rdx)] + [(f"{d}.{k}", grads[d][k], rgrads[d][k]) for d in dirs for k in names]
        for what, g, r in pairs:
            if not rel_err(g, r) <= GRAD_TOL:
                raise AssertionError(f"{'K4b' if ndir == 2 else 'K5b'} T={T} B={B}: {what} off its plain "
                                     f"version by {rel_err(g, r):.3g} of its largest element")
        if n is not None and not (dx[torch.arange(T, device=dev)[None, :] >= n[:, None]] == 0).all():
            raise AssertionError(f"{'K4b' if ndir == 2 else 'K5b'} T={T} B={B}: dX past a length is not 0")
    return launch, check


def cluster_ab(what: str, layers_of, dev, card: str, other_lib, batches, rule_of=None) -> dict:
    """``[<what>-batch]``: a cluster kernel's layers (K1, K2, K4f, or the
    backward chain's K4b and K5b; ``layers_of(B)`` gives their ``(launch,
    check)`` pairs and serial steps) back to back at clusters of 2 and of 4
    CTAs, in turns (the size
    the rule takes at that B first, the other, the other, the first) at each
    batch; each size takes the smallest batch tile that keeps the grid in one
    wave. The rule's size runs in the port's library, the other in
    ``other_lib``, the kernel's ``*_other_c`` variant (``VARIANTS``: the
    two-direction rule inverted; ``rule_of(B)``, the rule's size, defaults
    to that rule). Both sizes' outputs are held against the plain version
    first. Returns {"B=..": {"C": rule's size, "C=2": [ms, ms], "C=4": [ms,
    ms]}}."""
    import torch

    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_shared import bigru_cluster_size

    out = {}
    for B in batches:
        layers, steps = layers_of(B)
        rule = (rule_of or bigru_cluster_size)(B)  # default: the two-direction rule of gru_cluster.cuh
        other = 6 - rule
        libs = {rule: _build.library(), other: other_lib}

        def run(C, layers=layers, B=B):
            def f():
                for launch, _ in layers:
                    _build.check(launch(libs[C]), f"{what} on clusters of {C} (B={B})")
            return f

        for C in (rule, other):
            run(C)()
            torch.cuda.synchronize()
            for _, check in layers:
                check()
        turns = {rule: [], other: []}
        for C in (rule, other, other, rule):
            turns[C].append(cuda_ms(run(C), reps=10, warmup=2))
        out[f"B={B}"] = {"C": rule, **{f"C={C}": v for C, v in sorted(turns.items())}}
        faster_c = min(turns, key=lambda C: statistics.mean(turns[C]))
        print(f"[{what.lower()}-batch] {what} {len(layers)} layers B={B:2d}, in turns: clusters of {rule} (the "
              f"rule's) {turns[rule][0]:.4f}, of {other} {turns[other][0]:.4f}, {turns[other][1]:.4f}, of {rule} "
              f"{turns[rule][1]:.4f} ms ({1e3 * statistics.mean(turns[rule]) / steps:.3f} against "
              f"{1e3 * statistics.mean(turns[other]) / steps:.3f} us a step); faster: {faster_c} on {card}")
    return out


def k1_cluster_ab(dev, card: str, rng, other_lib, batches=(1, 16, 64)) -> dict:
    """``[k1-batch]``: K1's five flagship layers at B = 1, 16 and 64 (:func:`cluster_ab`)."""
    return cluster_ab("K1", lambda B: ([k1_layer(rng, dev, d, n, T, B, pool) for _, d, n, T, pool in FLAGSHIP_LAYERS],
                                       K1_STEPS), dev, card, other_lib, batches)


def k2_cluster_ab(dev, card: str, rng, other_lib, batches=(16, 64)) -> dict:
    """``[k2-batch]``: K2's four encoder layers at B = 16 and the train step's 64 (:func:`cluster_ab`)."""
    return cluster_ab("K2", lambda B: ([k2_layer(rng, dev, d, n, T, B) for _, d, n, T in ENC_SHAPES],
                                       sum(T for *_, T in ENC_SHAPES)), dev, card, other_lib, batches)


def k4f_cluster_ab(dev, card: str, rng, other_lib, batches=(1, SERVE_BATCH, 64)) -> dict:
    """``[k4f-batch]``: K4f's five flagship layers with mixed lengths at B = 1,
    the served batch of 8 and 64 (:func:`cluster_ab`)."""
    return cluster_ab("K4f", lambda B: ([k4f_layer(rng, dev, n * d, T, B) for _, d, n, T, _ in FLAGSHIP_LAYERS],
                                        K1_STEPS), dev, card, other_lib, batches)


def k3_layer(rng, dev, d: int, n_parts: int, T: int, B: int, fused: bool, bf16: bool = False):
    """K3 at one bi-GRU layer's shape (fused: on K2's outputs, pool 2 and
    dropout 0.5; else plain, on K1's), through its wrapper with the library
    to time swapped in for the call: ``(launch(lib), check)``, the check
    holding the last launch's dX and gradients against the plain version
    within ``GRAD_TOL`` of each largest element (``bf16``: bf16 streams,
    held by ``bf16_hold``)."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_shared import (_shift_hp, bigru_shared, bigru_shared_bwd,
                                                bigru_shared_bwd_reference, bigru_trainpool)

    params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
    if bf16:
        parts = tuple(p.to(torch.bfloat16) for p in parts)
    kw = {"pool": 2, "drop_p": 0.5, "seed": int(rng.integers(2**32))} if fused else {}
    if fused:
        hp_f, hp_b, o_f, _ = bigru_trainpool(params, parts, **kw)
    else:
        o_f, o_b = bigru_shared(params, parts)[:2]
        hp_f, hp_b = _shift_hp(o_f, o_b)
    dy = [torch.from_numpy(rng.standard_normal(tuple(o_f.shape)).astype(np.float32)).to(dev).to(parts[0].dtype)
          for _ in range(2)]
    got = {}

    def launch(lib):
        real, _build._lib = _build._lib, lib
        try:
            got["v"] = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
        finally:
            _build._lib = real
        return 0

    def check():
        (dxs, grads), (rdxs, rgrads) = got["v"], bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw)
        pairs = list(zip(dxs, rdxs)) + [(grads[k][n], rgrads[k][n]) for k in grads for n in grads[k]]
        if bf16:
            r32dxs, r32grads = bigru_shared_bwd_reference(params, tuple(p.float() for p in parts),
                                                          *[t.float() for t in (hp_f, hp_b, *dy)], **kw)
            r32 = list(r32dxs) + [r32grads[k][n] for k in grads for n in grads[k]]
            for (g, r), r2 in zip(pairs, r32):
                bf16_hold(f"K3 bf16 T={T} B={B}", g, r, r2)
        elif not all(rel_err(g, r) <= GRAD_TOL for g, r in pairs):
            raise AssertionError(f"K3 T={T} B={B} disagrees with its plain version")
    return launch, check


def k3_cluster_ab(dev, card: str, rng, other_lib, batches, asr: bool = False) -> dict:
    """``[k3-batch]``: K3's five flagship layers (``asr``: the ASR encoder's
    four, ``asr_shapes``) at each batch, their chain on clusters of 2 and of
    4 CTAs in turns (:func:`cluster_ab`; the rule's size the two-direction
    one, the other from the ``k3_other_c`` variant)."""
    shapes = [(*s, True) for s in asr_shapes()] if asr else [
        (name, d, n, T, name != INTENT_SHAPE[0]) for name, d, n, T in ENC_SHAPES + [INTENT_SHAPE]]

    def layers_of(B):
        return [k3_layer(rng, dev, d, n, T, B, fused) for _, d, n, T, fused in shapes], sum(s[3] for s in shapes)

    return cluster_ab("K3 ASR" if asr else "K3", layers_of, dev, card, other_lib, batches)


def bwd_cluster_ab(what: str, dev, card: str, rng, other_lib, batches) -> dict:
    """``[k4b-batch]`` / ``[k5b-batch]``: K4b at the seq2seq encoder layer
    (T = 25, D = 256, mixed lengths below B = 64) or K5b's five layers (every
    row T) at each batch, on clusters of 2 and of 4 CTAs in turns
    (:func:`cluster_ab`; the rule's size the forward's, the other from the
    ``bwd_other_c`` variant)."""
    from tpu_slu_torch.ops.gru1 import gru1_cluster_size

    ndir = 2 if what == "K4b" else 1

    def layers_of(B):
        if ndir == 2:
            lengths = None if B >= 64 else [25] + rng.integers(1, 26, B - 1).tolist()
            return [bwd_layer(rng, dev, 2, 256, 25, B, lengths)], 25
        return [bwd_layer(rng, dev, 1, D, T, B) for _, D, T in UNI_SHAPES], sum(T for *_, T in UNI_SHAPES)

    return cluster_ab(what, layers_of, dev, card, other_lib, batches,
                      rule_of=None if ndir == 2 else gru1_cluster_size)


def phase_train(dev, card: str, rng, k2_other, k3_other) -> tuple[list[dict], int]:
    """Phase 6: the flagship train step. Returns K2's and K3's JSON entries
    and K1's launches in ``Trainer.train``; ``k2_other`` and ``k3_other``
    are the ``k2_other_c`` and ``k3_other_c`` variants, for ``[k2-batch]``
    and ``[k3-batch]``."""
    import numpy as np
    import torch

    from tpu_slu_torch.models.flagship import TRAIN_CFG, flagship_model
    from tpu_slu_torch.ops.bigru_shared import (
        _shift_hp,
        bigru_cluster_size,
        bigru_shared,
        bigru_shared_bwd,
        bigru_shared_bwd_reference,
        bigru_shared_reference,
        bigru_trainpool,
        bigru_trainpool_reference,
    )
    from tpu_slu_torch.training import Trainer

    # 6.1 K2 against its plain version at the encoder layers' shapes, and an odd T
    k2_err = 0.0
    for name, d, n_parts, T in ENC_SHAPES + [("odd T", 128, 2, 199)]:
        for B in (1, 16, 64):
            params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
            seed = int(rng.integers(2**32))
            before = bigru_trainpool.launches
            got = bigru_trainpool(params, parts, pool=2, drop_p=0.5, seed=seed)
            torch.cuda.synchronize()
            assert bigru_trainpool.launches == before + 1, "K2 launch counter did not advance"
            ref = bigru_trainpool_reference(params, parts, pool=2, drop_p=0.5, seed=seed)
            err = max((g - r).abs().max().item() for g, r in zip(got, ref))
            k2_err = max(k2_err, err)
            for what, g, r in zip(("hp_f", "hp_b", "pooled_f", "pooled_b"), got, ref):
                if g.shape != r.shape or not torch.allclose(g, r, atol=ATOL, rtol=RTOL):
                    raise AssertionError(f"K2 {name} T={T} B={B}: {what} disagrees with its plain "
                                         f"version (max abs {err:.3g})")
            for g, r in zip(got[2:], ref[2:]):
                if not same_zeros(g, r):
                    raise AssertionError(f"K2 {name} T={T} B={B}: dropout zero pattern differs")
            print(f"[k2] {name:10s} T={T:3d} B={B:2d} D={n_parts * d:3d} drop 0.5 pool 2: "
                  f"max abs err {err:.3g}, zero pattern equal")
    print(f"[k2] within atol {ATOL} rtol {RTOL}, zero patterns equal; max abs err {k2_err:.3g}")

    # 6.2 K3 against its plain version: fused mode (encoder), plain mode (intent)
    def k3_case(d, n_parts, T, B, fused):
        params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
        if fused:
            seed = int(rng.integers(2**32))
            hp_f, hp_b, o_f, _ = bigru_trainpool(params, parts, pool=2, drop_p=0.5, seed=seed)
            kw = {"pool": 2, "drop_p": 0.5, "seed": seed}
        else:
            o_f, o_b = bigru_shared(params, parts)[:2]
            hp_f, hp_b = _shift_hp(o_f, o_b)
            kw = {}
        dy = [torch.from_numpy(rng.standard_normal(tuple(o_f.shape)).astype(np.float32)).to(dev)
              for _ in range(2)]
        return params, parts, hp_f, hp_b, dy, kw

    k3_err = 0.0
    for name, d, n_parts, T in ENC_SHAPES + [INTENT_SHAPE]:
        fused = name != INTENT_SHAPE[0]
        for B in (16, 64):
            params, parts, hp_f, hp_b, dy, kw = k3_case(d, n_parts, T, B, fused)
            before = bigru_shared_bwd.launches
            dxs, grads = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
            torch.cuda.synchronize()
            assert bigru_shared_bwd.launches == before + 1, "K3 launch counter did not advance"
            rdxs, rgrads = bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw)
            pairs = [(f"dx{i}", g, r) for i, (g, r) in enumerate(zip(dxs, rdxs))]
            pairs += [(f"{dd}.{n}", grads[dd][n], rgrads[dd][n]) for dd in grads for n in grads[dd]]
            worst = 0.0
            for what, g, r in pairs:
                e = rel_err(g, r)
                worst = max(worst, e)
                k3_err = max(k3_err, (g - r).abs().max().item())
                if g.shape != r.shape or not e <= GRAD_TOL:
                    raise AssertionError(f"K3 {name} T={T} B={B}: {what} off its plain version by "
                                         f"{e:.3g} of its largest element")
            print(f"[k3] {name:11s} T={T:3d} B={B:2d} {'fused' if fused else 'plain'}: dX, dW, db "
                  f"within {worst:.3g} of each largest element")
    print(f"[k3] within {GRAD_TOL} of each tensor's largest element; max abs err {k3_err:.3g}")

    # 6.3 the repaired eval path: gradients through the pooled K1 call
    for method in ("avg", "max"):
        params, parts = k1_case(rng, 2, 128, 200, 16, 128, dev)
        leaves = [({dd: {n: t.clone().requires_grad_() for n, t in params[dd].items()} for dd in params},
                   [p.clone().requires_grad_() for p in parts]) for _ in range(2)]
        out = bigru_shared(*leaves[0], pool=2, pool_method=method)[:2]
        if out[0].grad_fn is None:
            raise AssertionError("bigru_shared on CUDA with grad on returned a detached result")
        ref = bigru_shared_reference(*leaves[1], pool=2, pool_method=method)
        cot = [torch.from_numpy(rng.standard_normal(tuple(r.shape)).astype(np.float32)).to(dev)
               for r in ref]
        torch.autograd.backward(out, cot)
        torch.autograd.backward(ref, cot)
        (kp, kx), (rp, rx) = leaves
        worst = max(rel_err(a.grad, b.grad) for a, b in
                    list(zip(kx, rx)) + [(kp[dd][n], rp[dd][n]) for dd in kp for n in kp[dd]])
        if not worst <= GRAD_TOL:
            raise AssertionError(f"pooled eval path ({method}): gradients off autograd of the plain "
                                 f"version by {worst:.3g}")
        print(f"[grad] eval path pool 2/{method} under autograd on the card: every gradient within "
              f"{worst:.3g} of autograd of the plain version")

    # 6.4 one whole train step, card against the CPU plain path, B = 16
    step_vs_cpu(dev, rng, "step")

    # 6.5 the main path: Trainer.train over seeded batches of B = 64
    model = flagship_model(dev, cfg=TRAIN_CFG, seed=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        model.config.folder = tmp
        trainer = Trainer(model, model.config, generator=torch.Generator().manual_seed(7))
        B = model.config.training_batch_size
        data = Batches(synthetic_batches(rng, 3, B, model.values_per_slot))
        bigru_shared.launches = bigru_trainpool.launches = bigru_shared_bwd.launches = 0
        acc, loss = trainer.train(data)
        torch.cuda.synchronize()
        launches = {"K1": bigru_shared.launches, "K2": bigru_trainpool.launches,
                    "K3": bigru_shared_bwd.launches}
        steps = len(data.loader)
        if launches != {"K1": steps, "K2": 4 * steps, "K3": 5 * steps}:
            raise AssertionError(f"Trainer.train over {steps} steps launched {launches}; want 1 K1, "
                                 "4 K2 and 5 K3 per step")
        if not (np.isfinite(loss) and np.isfinite(acc)):
            raise AssertionError(f"Trainer.train: loss {loss}, acc {acc}")
        with open(os.path.join(tmp, "training", "log.csv")) as f:
            header = f.readline().strip()
        if not header.startswith(",intent_loss,intent_acc,set,examples_per_sec,steps"):
            raise AssertionError(f"log.csv header {header!r}")
        t_acc, t_loss = trainer.test(data)
        if not (np.isfinite(t_loss) and np.isfinite(t_acc)):
            raise AssertionError(f"Trainer.test: loss {t_loss}, acc {t_acc}")
        print(f"[train] Trainer.train at no_pretraining.cfg width, B={B}, {steps} steps: loss {loss:.4f} "
              f"acc {acc:.3f}; launches {launches}; log.csv {header}; Trainer.test loss {t_loss:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6.6 timings
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.loader[0].items()}
    step_ms = cuda_ms(lambda: trainer.train_step(batch), reps=10, warmup=2)
    print(f"[time] warm train step B={B}, 4 s audio (forward, backward, masked Adam): median "
          f"{step_ms:.3f} ms of 10 (CUDA events) on {card}")
    k2_ms = k2_plain = k2_lib = k3_ms = k3_plain = k3_lib = 0.0
    k2_work, k3_work = [0.0, 0.0], [0.0, 0.0]  # FLOPs, bytes
    H = 128
    k3_layers, core_flops = [], 0.0
    for name, d, n_parts, T in ENC_SHAPES + [INTENT_SHAPE]:
        fused = name != INTENT_SHAPE[0]
        D, To = n_parts * d, -(-T // 2) if fused else T
        params, parts, hp_f, hp_b, dy, kw = k3_case(d, n_parts, T, B, fused)
        k3_layers.append((params, parts, hp_f, hp_b, dy, kw))
        # the GEMM core's products: gi, dX and dW_ih (D each), gh and dW_hh (H each), two directions
        core_flops += 2 * 2 * T * B * 3 * H * (3 * D + 2 * H)
        if fused:
            kw2 = {"pool": 2, "drop_p": 0.5, "seed": kw["seed"]}
            a, b = in_turns(lambda: bigru_trainpool_reference(params, parts, **kw2),
                            lambda: bigru_trainpool(params, parts, **kw2))
            lib = cudnn_gru_ms(D, T, B, H, dev)  # the nearest call: no dropout, no pool, no h_prev
            k2_ms, k2_plain, k2_lib = k2_ms + a, k2_plain + b, k2_lib + lib
            # in: x; out: the pooled outputs and h_prev of both directions
            w = gru_fwd_work(T * B, D, H, T * B * D, 2 * To * B * H + 2 * T * B * H)
            k2_work = [k2_work[0] + w[0], k2_work[1] + w[1]]
            print(f"[time] K2 {name:11s} B={B} T={T:3d}: kernel {a:.4f} ms ({1e3 * a / T:.3f} us a step), plain "
                  f"{b:.3f} ms, cuDNN nn.GRU unpooled {lib:.4f} ms, bound {bound(*w)[0]:.4f} ms ({bound(*w)[1]})")
        a, b = in_turns(lambda: bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw),
                        lambda: bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw))
        lib = cudnn_gru_ms(D, T, B, H, dev, backward=True)
        k3_ms, k3_plain, k3_lib = k3_ms + a, k3_plain + b, k3_lib + lib
        # per row and direction: gi and gh recomputed, the dh chain, dX, dW_ih, dW_hh
        # (2 * 3H * (3D + 3H)) and the gate derivatives; in: x, h_prev, dy, weights;
        # out: dX and the weight gradients
        w = (2 * T * B * (2 * 3 * H * (3 * D + 3 * H) + 2 * GATE_OPS * H),
             4 * (2 * T * B * D + 2 * T * B * H + 2 * To * B * H + 2 * gru_weight_floats(D, H)))
        k3_work = [k3_work[0] + w[0], k3_work[1] + w[1]]
        print(f"[time] K3 {name:11s} B={B} T={T:3d} {'fused' if fused else 'plain'}: kernel {a:.4f} ms, "
              f"plain {b:.3f} ms, cuDNN nn.GRU backward {lib:.4f} ms, bound {bound(*w)[0]:.4f} ms "
              f"({bound(*w)[1]})")
    (k2_bound, k2_by), (k3_bound, k3_by) = bound(*k2_work), bound(*k3_work)
    k2_steps = sum(T for *_, T in ENC_SHAPES)
    print(f"[time] K2 four encoder layers B={B}: kernel {k2_ms:.4f} ms ({1e3 * k2_ms / k2_steps:.3f} us a step, "
          f"clusters of {bigru_cluster_size(B)}), plain {k2_plain:.3f} ms, cuDNN nn.GRU unpooled (the nearest "
          f"call: no dropout, pool or h_prev) {k2_lib:.4f} ms, bound {k2_bound:.4f} ms ({k2_by}); K3 five layers: "
          f"kernel {k3_ms:.4f} ms, plain "
          f"{k3_plain:.3f} ms, cuDNN nn.GRU backward {k3_lib:.4f} ms, bound {k3_bound:.4f} ms "
          f"({k3_by}) on {card}")
    k2_ab = k2_cluster_ab(dev, card, rng, k2_other)
    k3_ab = k3_cluster_ab(dev, card, rng, k3_other, (16, 64))
    # K3 by phase: the gate pass, the chain, the GEMM core's launches and dW's reduce pass
    k3_split = device_split(lambda: [bigru_shared_bwd(p, x, hf, hb, *dy, **kw) for p, x, hf, hb, dy, kw in k3_layers],
                            K3_PHASES)
    core_ms = sum(v for k, v in k3_split.items() if k.startswith("core"))
    core_tflops = core_flops / (core_ms * 1e-3) / 1e12
    print(f"[time] K3 five layers B={B} by phase (profiler, device ms a step): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k3_split.items())
          + f"; the GEMM core: {core_flops / 1e9:.2f} GFLOP in {core_ms:.4f} ms, {core_tflops:.1f} TFLOP/s "
          f"({core_tflops / (PEAK_F32 / 1e12):.2f} of the f32 peak) on {card}")
    return [
        {"name": "bigru_trainpool_fwd", "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
         "library_call": "cuDNN nn.GRU, bidirectional, unpooled: the nearest call, not the same function",
         "us_per_step": 1e3 * k2_ms / k2_steps, "ab_cluster": k2_ab},
        {"name": "bigru_shared_bwd", "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": launches["K3"], "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib, "phase_ms": k3_split,
         "core_gflop": core_flops / 1e9, "core_tflops": core_tflops, "ab_cluster": k3_ab},
    ], launches["K1"]


def phase_serve(dev, card: str, rng, golden, expected, k4f_other) -> dict:
    """Phase 7: length-exact decode and the micro-batching server. Returns
    K4f's JSON entry; its launches are those of the served run. ``k4f_other``
    is the ``k4f_other_c`` variant, for ``[k4f-batch]``."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from tpu_slu_torch.models.flagship import flagship_model
    from tpu_slu_torch.ops.bigru_masked import bigru_masked, bigru_masked_reference
    from tpu_slu_torch.ops.bigru_shared import bigru_cluster_size, bigru_shared
    from tpu_slu_torch.serving import IntentServer, make_http_server

    H = 128
    # 7.1 K4f against its plain version at the five flagship layer shapes, B = 8,
    # seeded mixed lengths (each set holds T and 0); timings in turns
    k4_err = k4_ms = k4_plain = k4_lib = 0.0
    k4_work = [0.0, 0.0]
    for name, d, n_parts, T in ENC_SHAPES + [INTENT_SHAPE]:
        D, B = n_parts * d, SERVE_BATCH
        params, parts = k1_case(rng, 1, D, T, B, H, dev)
        x = parts[0].transpose(0, 1).contiguous()
        lengths = rng.integers(1, T + 1, B)
        lengths[0], lengths[-1] = T, 0
        n = torch.from_numpy(lengths).to(dev)
        before = bigru_masked.launches
        with torch.inference_mode():
            got = bigru_masked(params, x, n)
        torch.cuda.synchronize()
        assert bigru_masked.launches == before + 1, "K4f launch counter did not advance"
        ref = bigru_masked_reference(params, x, n)
        err = (got - ref).abs().max().item()
        k4_err = max(k4_err, err)
        if got.shape != ref.shape or not rel_err(got, ref) <= ATOL:
            raise AssertionError(f"K4f {name} T={T}: off its plain version by {rel_err(got, ref):.3g} "
                                 f"of the largest element (limit {ATOL})")
        tail = torch.arange(T, device=dev)[None, :] >= n[:, None]
        if not (got[tail] == 0).all():
            raise AssertionError(f"K4f {name} T={T}: a frame past its row's length is not 0")
        with torch.inference_mode():
            a, b = in_turns(lambda: bigru_masked_reference(params, x, n),
                            lambda: bigru_masked(params, x, n))
        lib = cudnn_gru_ms(D, T, B, H, dev, lengths=lengths.tolist())
        rows = int(lengths.sum())
        # the valid rows' work; in: their x; out: all of (B, T, 2H), zeros included
        w = gru_fwd_work(rows, D, H, rows * D, B * T * 2 * H)
        k4_work = [k4_work[0] + w[0], k4_work[1] + w[1]]
        k4_ms, k4_plain, k4_lib = k4_ms + a, k4_plain + b, k4_lib + lib
        print(f"[k4f] {name:11s} B={B} T={T:3d} D={D:3d} lengths {lengths.tolist()}: max abs err "
              f"{err:.3g} (rel {rel_err(got, ref):.3g}), zeros past each length; kernel {a:.4f} ms, "
              f"plain {b:.3f} ms, cuDNN nn.GRU on packed rows {lib:.4f} ms, bound "
              f"{bound(*w)[0]:.4f} ms ({bound(*w)[1]})")
    k4_bound, k4_by = bound(*k4_work)
    print(f"[time] K4f five flagship layers B={SERVE_BATCH}: kernel {k4_ms:.4f} ms "
          f"({1e3 * k4_ms / K1_STEPS:.3f} us a step, clusters of {bigru_cluster_size(SERVE_BATCH)}), plain "
          f"{k4_plain:.3f} ms, cuDNN nn.GRU {k4_lib:.4f} ms, bound {k4_bound:.4f} ms ({k4_by}); "
          f"within {ATOL} of each largest element, max abs err {k4_err:.3g} on {card}")
    k4_ab = k4f_cluster_ab(dev, card, rng, k4f_other)

    # 7.2 a length-exact decode of (8, 4 s bucket) against each example's exact-shape
    # decode (the K1 path) on the card
    model = flagship_model(dev)
    n_samples = rng.integers(16000, 64001, SERVE_BATCH)
    n_samples[0] = 64000
    waves = [(0.1 * rng.standard_normal(int(t))).astype(np.float32) for t in n_samples]
    x = np.zeros((SERVE_BATCH, 64000), np.float32)
    for i, w in enumerate(waves):
        x[i, :len(w)] = w
    bigru_masked.launches = bigru_shared.launches = 0
    logits, preds = model.predict_intents(x, lengths=n_samples)
    torch.cuda.synchronize()
    if (bigru_masked.launches, bigru_shared.launches) != (5, 0):
        raise AssertionError(f"length-exact decode launched K4f {bigru_masked.launches} and K1 "
                             f"{bigru_shared.launches} times; want 5 and 0")
    worst = 0.0
    for i, w in enumerate(waves):
        alone, alone_preds = model.predict_intents(w)
        e = (logits[i] - alone[0]).abs().max().item()
        worst = max(worst, e)
        if not (torch.isfinite(logits[i]).all() and e <= EXACT_LOGIT_ATOL
                and torch.equal(preds[i], alone_preds[0])):
            raise AssertionError(f"length-exact row {i} ({len(w)} samples): logits off its exact-shape "
                                 f"decode by {e:.3g} (atol {EXACT_LOGIT_ATOL}) or predictions differ")
    print(f"[exact] flagship predict_intents(lengths=) at ({SERVE_BATCH}, 64000), lengths "
          f"{n_samples.tolist()}: 5 K4f, 0 K1 launches; each row within {worst:.3g} of its "
          f"exact-shape decode (atol {EXACT_LOGIT_ATOL}), predictions equal")
    xd, nd = torch.from_numpy(x).to(dev), torch.from_numpy(n_samples).to(dev)
    full = torch.from_numpy((0.1 * rng.standard_normal((SERVE_BATCH, 64000))).astype(np.float32)).to(dev)
    exact_ms = cuda_ms(lambda: model.predict_intents(xd, lengths=nd), reps=30, warmup=5)
    shape_ms = cuda_ms(lambda: model.predict_intents(full), reps=30, warmup=5)
    print(f"[time] warm length-exact predict_intents ({SERVE_BATCH}, 4 s bucket): median "
          f"{exact_ms:.3f} ms of 30; exact-shape predict_intents B={SERVE_BATCH}, 4 s: median "
          f"{shape_ms:.3f} ms of 30 (CUDA events) on {card}")
    profile_calls(lambda: model.predict_intents(xd, lengths=nd), f"length-exact predict_intents "
                  f"({SERVE_BATCH}, 4 s bucket)", card)
    profile_calls(lambda: model.predict_intents(full), f"exact-shape predict_intents B={SERVE_BATCH}, 4 s",
                  card)

    # 7.3 the main path: an IntentServer answering 32 seeded requests of 1.0-4.0 s from 8 threads
    reqs = [(0.1 * rng.standard_normal(int(t))).astype(np.float32)
            for t in rng.integers(16000, 64001, 32)]
    server = IntentServer(model, max_batch=SERVE_BATCH)
    try:
        server.warmup()
        bigru_masked.launches = bigru_shared.launches = 0
        graphs = graph_counts(model)
        answers, sizes = serve_requests(server, reqs)
        k4_launches, k1_launches = bigru_masked.launches, bigru_shared.launches
        captured, replayed = (b - a for a, b in zip(graphs, graph_counts(model)))
    finally:
        server.close()
    calls = sum(sizes.values())
    if replayed != calls or k4_launches != 5 * captured or k1_launches != 0:
        raise AssertionError(f"served run: {calls} device calls, {replayed} graph replays, {captured} captures; "
                             f"K4f launched {k4_launches} and K1 {k1_launches} times; want a replay a call, 5 "
                             "K4f a capture (its eager warm pass) and 0 K1")
    if sum(k * v for k, v in sizes.items()) != 32 or max(sizes) < 2:
        raise AssertionError(f"served run: device calls by requests carried {sizes}")
    for i, got, _ in answers:
        want = model.decode_intents(reqs[i])[0]
        if got != want:
            raise AssertionError(f"served request {i} ({len(reqs[i])} samples): {got}, exact-shape {want}")
    lat = sorted(ms for *_, ms in answers)
    p50, p90 = lat[len(lat) // 2], lat[int(0.9 * len(lat))]
    print(f"[serve] IntentServer(max_batch={SERVE_BATCH}) after warmup: 32 requests of 1.0-4.0 s from 8 "
          f"threads in {calls} device calls (by requests carried: {sizes}), each a CUDA graph's replay ({captured} "
          f"captured in the run); K4f launches {k4_launches}, K1 {k1_launches}; every answer equals its exact-shape "
          f"decode")
    print(f"[time] served latency (submit to answer, host clock): p50 {p50:.3f} ms, p90 {p90:.3f} ms, "
          f"max {lat[-1]:.3f} ms on {card}")

    # 7.4 HTTP on the golden checkpoint
    server = IntentServer(golden, max_batch=SERVE_BATCH)
    httpd = make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True}
        for case in expected:
            with open(os.path.join(GOLDEN, case["wav"]), "rb") as f:
                req = urllib.request.Request(f"{base}/decode", data=f.read())
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())["intents"]
            want = [case["action"], case["object"], case["location"]]
            if got != want:
                raise AssertionError(f"HTTP /decode {case['wav']}: {got}, want {want}")
        print(f"[http] make_http_server on the golden checkpoint: /healthz ok; {len(expected)} golden "
              f"wavs POSTed to /decode, each decoded to its expected intents")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(timeout=10)
    return {"name": "bigru_masked_fwd", "route": "cuda", "source": K4F_SOURCE, "replaces": K4F_REPLACES,
            "launches": k4_launches, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
            "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": k4_lib,
            "us_per_step": 1e3 * k4_ms / K1_STEPS, "ab_cluster": k4_ab}


def k7_work(B: int, T: int, W: int, U: int, nl: int, H: int, K: int, V: int, L: int) -> tuple[float, float]:
    """FLOPs and bytes of a whole beam search: per step and hypothesis row,
    the query, the scores and context over T frames, the cells (2 * 3H *
    (in + H) each, and the gate math), the label projection, the
    log-softmax; in: keys, values and the decoder weights once; out: scores
    and int64 tokens."""
    cells = sum(2 * 3 * H * ((H + V if li == 0 else H) + H) + GATE_OPS * H for li in range(nl))
    row = 2 * H * K + 2 * T * (K + V) + 4 * T + cells + 2 * H * L + 4 * L
    weights = H * K + K + L * H + H + sum(3 * H * ((H + V if li == 0 else H) + H) + 6 * H for li in range(nl)) \
        + H * L + L + nl * H
    return float(row) * W * B * U, 4.0 * (B * T * (K + V) + weights + W * B) + 8.0 * W * B * U


def k7_round_split(trace_lib, dec, keys, values, U: int, ms: float, card: str) -> dict:
    """One K7 search through ``trace_lib``, a build of ``beam_decode.cu``
    with ``TSL_TRACE`` (the ``k7_trace`` variant, or a tool's): the first
    utterance's step split by phase as one CTA's thread 0 sees it, its own
    products and then its wait for each exchange round, scaled to ``ms``,
    the served kernel's time; printed and returned in us a step."""
    import ctypes

    import torch

    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.beam_fused import beam_decode

    nl = dec.initial_state.shape[0]
    served = _build.library()
    _build._lib = trace_lib
    try:
        with torch.inference_mode():
            beam_decode(dec, keys, values, None, 4, U)
        torch.cuda.synchronize()
    finally:
        _build._lib = served
    clocks = (ctypes.c_longlong * (2 * nl + 5))()
    _build.check(trace_lib.tsl_beam_trace(clocks, 2 * nl + 5), "tsl_beam_trace")
    clocks = list(clocks)
    names = (["prologue", "attention + embedding"]
             + [f"layer {li} {part}" for li in range(nl) for part in ("products", "exchange wait")]
             + ["head products", "head exchange wait", "log-softmax, top-W, reorder"])
    us = 1e3 * ms / U / sum(clocks[1:])  # us a clock of a step, from the untraced time
    split = {n: c * us for n, c in zip(names, clocks) if n != "prologue"}
    print(f"[time] K7 B={keys.shape[0]:2d} T={keys.shape[1]:3d} W=4 step by phase (traced clocks, scaled to "
          f"{1e3 * ms / U:.2f} us a step): " + ", ".join(f"{n} {v:.2f} us" for n, v in split.items())
          + f" on {card}")
    return split


def tie_tolerance(steps: int, scores) -> float:
    """How far apart two f32 beam searches may score the same hypotheses
    after ``steps`` steps, given the beams' ``scores`` (any iterable of
    floats), derived from the length of the sum, not fitted to any case.

    A beam's score after n steps is the f32 running sum s_k = fl(s_{k-1} +
    lp_{k-1}), k = 1..n, of its n per-step log-probabilities. Each addition
    rounds by at most half a spacing of its result, and every lp <= 0, so
    |s_k| never exceeds |s_n|; a spacing of f32 at |s| is at most 2^-23 |s|.
    So one search's score lies within n 2^-24 |s_n| of the exact sum of its
    own log-probabilities, and two searches, each rounding its own sums, lie
    within n 2^-23 |s_n| of each other. Their log-probabilities differ too,
    evaluated in other orders: with every lp of one sign, a relative error
    of a few units in each adds up to the same relative error of the sum,
    whatever n, for which 4 spacings of the score are allowed. Together (n +
    4) 2^-23 max |s|, and at least 1e-5 for scores near 0."""
    return max((steps + 4) * 2**-23 * max(abs(float(s)) for s in scores), 1e-5)


def parting_step(run, ref_run, U: int, b: int) -> int:
    """The step u < U of row ``b`` at which two beam searches' beams first
    differ (their beams after u steps were equal), found by bisection over
    searches of fewer steps; ``run(n)`` and ``ref_run(n)`` as in
    ``compare_searches``. The row's tokens must differ after U steps."""
    import torch

    def differ(n: int) -> bool:
        return not torch.equal(run(n)[1][:, b], ref_run(n)[1][:, b])

    lo, hi = 0, U - 1  # differ(hi + 1); lo == 0 or not differ(lo)
    while lo < hi:
        mid = (lo + hi) // 2
        if differ(mid + 1):
            hi = mid
        else:
            lo = mid + 1
    return lo


def compare_searches(what: str, run, ref_run, U: int) -> tuple[object, object, list[int], list[str]]:
    """Hold a beam search against a reference: ``run(n)`` and ``ref_run(n)``
    give (scores (W, B), tokens (W, B, n)) of searches of n steps, on the CPU.

    A row whose tokens are equal passes. A row whose tokens differ is
    followed back (``parting_step``) to a step u whose beams differ while
    those of step u - 1 were equal, so both ranked extensions of the same
    hypotheses there: the two beams' sorted scores must then agree within
    the f32 drift of u + 1 summed steps (``tie_tolerance``), i.e. the two
    took different members of a tie; anything else raises. Returns both
    full results, the rows that passed whole, and a note for each row that
    parted at a tie (not compared after it)."""
    import torch

    got, ref = run(U), ref_run(U)
    rows, notes = [], []
    for b in range(ref[1].shape[1]):
        if torch.equal(got[1][:, b], ref[1][:, b]):
            rows.append(b)
            continue
        lo = parting_step(run, ref_run, U, b)
        gs, rs = run(lo + 1)[0][:, b].double(), ref_run(lo + 1)[0][:, b].double()
        eps = tie_tolerance(lo + 1, rs.tolist())
        gap = (gs - rs).abs().max().item()
        if gap > eps:
            raise AssertionError(f"{what}: row {b}'s beams differ at step {lo}, equal before it, with sorted "
                                 f"scores {gs.tolist()} against the reference's "
                                 f"{rs.tolist()}: {gap:.3g} apart, more than the f32 drift of {lo + 1} "
                                 f"summed steps ({eps:.3g})")
        notes.append(f"row {b} parts from the reference at step {lo} of {U}, where the two took different members "
                     f"of a tie (beam scores within {gap:.3g}, f32 drift of {lo + 1} steps {eps:.3g}); equal "
                     f"before it")
    return got, ref, rows, notes


def phase_seq2seq(dev, card: str, rng, trace_lib) -> dict:
    """Phase 8: seq2seq decode and serving. Returns K7's JSON entry; its
    launches are those of the served run."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from tpu_slu_torch import read_config
    from tpu_slu_torch.data.audio import read_wav
    from tpu_slu_torch.models.flagship import flagship_seq2seq_model
    from tpu_slu_torch.models.slu import Seq2SeqArch, Seq2SeqDecoder
    from tpu_slu_torch.ops import beam as plain
    from tpu_slu_torch.ops.attention import attention_kv
    from tpu_slu_torch.ops.beam_fused import SMEM_LIMIT, beam_cluster_size, beam_decode
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_masked import bigru_masked
    from tpu_slu_torch.ops.bigru_shared import bigru_shared
    from tpu_slu_torch.serving import IntentServer, load_trained_model, make_http_server

    cpu = flagship_seq2seq_model("cpu")
    model = copy.deepcopy(cpu).to(dev)
    a = model.seq2seq_arch
    flag = (a.num_decoder_layers, a.decoder_dim, a.key_dim, a.value_dim, a.num_labels)  # 2, 256, 100, 200, 102
    U = a.max_decode_len

    def decoder(seed, nl, H, K, V, L):
        if (nl, H, K, V, L) == flag:
            return model.decoder
        arch = Seq2SeqArch(num_labels=L, num_encoder_layers=1, encoder_dim=a.encoder_dim,
                           num_decoder_layers=nl, decoder_dim=H, key_dim=K, value_dim=V, sos=0)
        return Seq2SeqDecoder(arch, torch.Generator().manual_seed(seed)).eval().to(dev)

    def kv(dec, B, T):
        enc = rng.standard_normal((B, T, 2 * a.encoder_dim)).astype(np.float32)
        with torch.inference_mode():
            return attention_kv(dec.attention, torch.from_numpy(enc).to(dev))

    # 8.1 K7 against its plain version on the card, at 4 s (25 frames) and 30 s (188)
    k7_err, k7_ties = 0.0, []
    cases = [("flagship", 1, 25, *flag, 4, U, False), ("flagship", 16, 25, *flag, 4, U, False),
             ("flagship mixed", 8, 25, *flag, 4, U, True), ("golden decoder", 4, 13, 1, 64, 64, 64, 102, 4, 16, True),
             ("odd small", 5, 6, 2, 8, 4, 8, 11, 3, 10, False), ("greedy", 4, 25, *flag, 1, U, True),
             ("flagship 30 s", 1, 188, *flag, 4, U, False), ("flagship 30 s", 4, 188, *flag, 4, U, True),
             ("flagship odd T", 3, 171, *flag, 4, U, True), ("flagship W=9", 2, 25, *flag, 9, U, False),
             ("flagship W=16", 2, 25, *flag, 16, U, True), ("flagship W=20", 2, 25, *flag, 20, U, False),
             ("flagship W=32", 2, 25, *flag, 32, U, True), ("flagship 30 s W=20", 1, 188, *flag, 20, U, True),
             ("flagship 30 s W=32", 2, 188, *flag, 32, U, False), ("flagship B=17", 17, 25, *flag, 4, U, True),
             ("flagship B=64", 64, 25, *flag, 4, U, True), ("flagship two waves", 133, 25, *flag, 4, 40, True),
             ("flagship W=25", 33, 25, *flag, 25, U, True), ("flagship W=25 waves", 133, 25, *flag, 25, U, False)]
    plan_bytes = _build.library().tsl_beam_decode_smem_bytes
    for i, (name, B, T, nl, H, K, V, L, W, Ub, mixed) in enumerate(cases):
        dec = decoder(i, nl, H, K, V, L)
        keys, values = kv(dec, B, T)
        n = None
        if mixed:
            n = torch.from_numpy(rng.integers(1, T + 1, B)).to(dev)
            n[0] = 1
        global_plan = plan_bytes(W, nl, H, K, V, L, Ub) > SMEM_LIMIT
        before = beam_decode.launches, beam_decode.launches_global
        with torch.inference_mode():
            beam_decode(dec, keys, values, n, W, Ub)
        torch.cuda.synchronize()
        launched = beam_decode.launches - before[0], beam_decode.launches_global - before[1]
        if launched != (1, int(global_plan)) or global_plan != (W >= 26 and (nl, H, K, V, L) == flag):
            raise AssertionError(f"K7 {name} B={B} T={T} W={W}: launches +{launched[0]}, of them +{launched[1]} "
                                 f"with the global plan; want 1 launch, on the global plan from W = 26 at the "
                                 "flagship decoder")
        C = beam_cluster_size(B, T, W, nl, H, K, V, L, Ub)

        def search(fn):
            def steps(n_steps):
                with torch.inference_mode():
                    return tuple(t.cpu() for t in fn(dec, keys, values, n, W, n_steps))
            return steps

        (scores, _), (ref_scores, _), rows, notes = compare_searches(
            f"K7 {name} B={B}", search(beam_decode), search(plain.beam_search_reference), Ub)
        err = (scores - ref_scores)[:, rows].abs().amax().item() if rows else 0.0
        k7_err = max(k7_err, err)
        if not torch.allclose(scores[:, rows], ref_scores[:, rows], rtol=1e-5, atol=1e-4):
            raise AssertionError(f"K7 {name} B={B}: scores off the plain version's by {err:.3g}")
        k7_ties += notes
        print(f"[k7] {name:18s} B={B:2d} T={T:3d} layers={nl} H={H:3d} K={K:3d} V={V:3d} L={L:3d} W={W:2d} U={Ub:3d} "
              f"{'global' if global_plan else 'smem'} plan, clusters of {C}"
              f"{' mixed valid frames ' + str(n.tolist()) if mixed else ''}: tokens equal in {len(rows)} of {B} "
              f"rows, scores max abs err {err:.3g}" + "".join(f"; {t}" for t in notes))
    print(f"[k7] tokens equal in every row but {len(k7_ties)} that parted at a tie; scores within rtol 1e-5 "
          f"atol 1e-4, max abs err {k7_err:.3g}; plans past {SMEM_LIMIT} bytes of shared memory (W >= 26 at "
          "the flagship decoder) lie in device memory")

    # 8.2 the golden seq2seq checkpoint on the card: one K7 launch a decode, no plain search
    golden_dir = os.path.join(HERE, "tests", "assets", "golden_seq2seq")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s2s_")
    try:
        folder = os.path.join(tmp, "exp")
        with open(os.path.join(golden_dir, "experiment.cfg.template")) as f:
            template = f.read()
        with open(os.path.join(tmp, "exp.cfg"), "w") as f:
            f.write(template.replace("__GOLDEN_FOLDER__", folder))
        config = read_config(os.path.join(tmp, "exp.cfg"))
        with open(os.path.join(golden_dir, "expected.json")) as f:
            meta = json.load(f)
        config.seq2seq_max_decode_len = meta["max_decode_len"]
        for name in ("model_state.npz", "vocab.json"):
            shutil.copyfile(os.path.join(golden_dir, name), os.path.join(folder, "training", name))
        golden = load_trained_model(config, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cases = [(c["wav"], read_wav(os.path.join(golden_dir, c["wav"]))[0], c["semantics"]) for c in meta["expected"]]
    plain_calls = []
    real_search = plain.beam_search
    plain.beam_search = lambda *args, **kw: plain_calls.append(1) or real_search(*args, **kw)
    try:
        for wav_name, wav, want in cases:
            before = beam_decode.launches
            got = golden.decode_intents(wav[None, :])[0]
            if got != want or beam_decode.launches != before + 1:
                raise AssertionError(f"golden seq2seq {wav_name}: {got!r}, want {want!r}; K7 launches "
                                     f"+{beam_decode.launches - before}, want 1")
            print(f"[golden-s2s] {wav_name}: {got!r} exact, K7 launches +1")
        server = IntentServer(golden, max_batch=SERVE_BATCH)
        httpd = make_http_server(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            served = [f.result(timeout=120) for f in [server.submit(w) for _, w, _ in cases]]
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            over_http = []
            for wav_name, _, _ in cases:
                with open(os.path.join(golden_dir, wav_name), "rb") as f:
                    req = urllib.request.Request(f"{base}/decode", data=f.read())
                with urllib.request.urlopen(req, timeout=120) as r:
                    over_http.append(json.loads(r.read())["intents"])
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
            thread.join(timeout=10)
    finally:
        plain.beam_search = real_search
    want = [w for *_, w in cases]
    if served != want or over_http != want or plain_calls:
        raise AssertionError(f"golden seq2seq served {served}, over HTTP {over_http}, want {want}; plain "
                             f"searches on the path: {len(plain_calls)}")
    print(f"[golden-s2s] the {len(cases)} wavs exact through IntentServer and over HTTP; no plain search ran")

    # 8.3 flagship seq2seq decode, card against the CPU plain path; length-exact rows
    def predict(m, xs, n_steps, **kw):
        """m.predict_intents(xs, **kw) with a search of n_steps, on the CPU."""
        arch = m.seq2seq_arch
        m.seq2seq_arch = dataclasses.replace(arch, max_decode_len=n_steps)
        try:
            return tuple(t.cpu() for t in m.predict_intents(xs, **kw))
        finally:
            m.seq2seq_arch = arch

    x = (0.1 * np.random.default_rng(2).standard_normal((16, 4 * 16000))).astype(np.float32)
    for B in (1, 16):
        before = beam_decode.launches
        model.predict_intents(x[:B])
        torch.cuda.synchronize()
        launched = beam_decode.launches - before
        (scores, _), (ref_scores, _), rows, notes = compare_searches(
            f"flagship seq2seq B={B}, card vs CPU", lambda n: predict(model, x[:B], n),
            lambda n: predict(cpu, x[:B], n), U)
        err = rel_err(scores[:, rows], ref_scores[:, rows]) if rows else 0.0
        if not (launched == 1 and torch.isfinite(scores).all()
                and torch.allclose(scores[:, rows], ref_scores[:, rows], rtol=1e-3, atol=0)):
            raise AssertionError(f"flagship seq2seq B={B}: {launched} K7 launches; scores off the CPU's by "
                                 f"{err:.3g} of the largest")
        print(f"[s2s] flagship seq2seq predict_intents B={B}, 4 s, W=4, U={U}: 1 K7 launch; tokens equal the CPU "
              f"plain path's in {len(rows)} of {B} rows, scores within {err:.3g} of the largest (limit 1e-3 "
              f"relative)" + "".join(f"; {t}" for t in notes))
    print(f"[s2s] decode_intents B=1 (random weights): {model.decode_intents(x[:1])[0][:60]!r}")
    x30 = (0.1 * np.random.default_rng(3).standard_normal((1, 30 * 16000))).astype(np.float32)
    before = beam_decode.launches
    model.predict_intents(x30)
    torch.cuda.synchronize()
    launched = beam_decode.launches - before
    (scores, _), (ref_scores, _), rows, notes = compare_searches(
        "flagship seq2seq 30 s, card vs CPU", lambda n: predict(model, x30, n), lambda n: predict(cpu, x30, n), U)
    err = rel_err(scores[:, rows], ref_scores[:, rows]) if rows else 0.0
    if not (launched == 1 and torch.isfinite(scores).all()
            and torch.allclose(scores[:, rows], ref_scores[:, rows], rtol=1e-3, atol=0)):
        raise AssertionError(f"flagship seq2seq 30 s: {launched} K7 launches; scores off the CPU's by "
                             f"{err:.3g} of the largest")
    print(f"[s2s] flagship seq2seq predict_intents B=1, 30 s, W=4, U={U}: 1 K7 launch; tokens equal "
          f"the CPU plain path's in {len(rows)} of 1 rows, scores within {err:.3g} of the largest (limit 1e-3 "
          f"relative)" + "".join(f"; {t}" for t in notes))
    n_samples = rng.integers(16000, 64001, SERVE_BATCH)
    n_samples[0] = 64000
    waves = [(0.1 * rng.standard_normal(int(t))).astype(np.float32) for t in n_samples]
    xb = np.zeros((SERVE_BATCH, 64000), np.float32)
    for i, w in enumerate(waves):
        xb[i, :len(w)] = w
    before = (beam_decode.launches, bigru_masked.launches)
    model.predict_intents(xb, lengths=n_samples)
    torch.cuda.synchronize()
    launched = (beam_decode.launches - before[0], bigru_masked.launches - before[1])
    if launched != (1, 5):
        raise AssertionError(f"length-exact seq2seq decode launched K7 {launched[0]} and K4f {launched[1]} "
                             "times; want 1 and 5")
    _, _, rows, notes = compare_searches(
        "length-exact seq2seq vs each row's exact-shape decode", lambda n: predict(model, xb, n, lengths=n_samples),
        lambda n: tuple(torch.cat(r, dim=1) for r in zip(*[predict(model, w, n) for w in waves])), U)
    print(f"[s2s] length-exact predict_intents at ({SERVE_BATCH}, 64000), lengths {n_samples.tolist()}: 1 K7 "
          f"and 5 K4f launches; tokens equal the row's exact-shape decode's in {len(rows)} of {SERVE_BATCH} rows"
          + "".join(f"; {t}" for t in notes))

    # 8.4 timings: K7 against its plain version at 4 s and 30 s, with its cluster size and
    # plan, the step's split by phase (the kernel's trace), the warm decode, its device
    # time by kernel
    k7_ms = {}
    for B, T in ((1, 25), (16, 25), (1, 188), (16, 188)):
        keys, values = kv(model.decoder, B, T)
        with torch.inference_mode():
            kern, pl = in_turns(lambda: plain.beam_search_reference(model.decoder, keys, values, None, 4, U),
                                lambda: beam_decode(model.decoder, keys, values, None, 4, U))
        w = k7_work(B, T, 4, U, *flag)
        k7_ms[B, T] = (kern, pl, *bound(*w))
        print(f"[time] K7 flagship B={B:2d} T={T:3d} W=4 U={U}, clusters of {beam_cluster_size(B, T, 4, *flag, U)}, "
              f"smem plan: kernel {kern:.4f} ms ({kern / U * 1e3:.2f} us a step), plain {pl:.3f} ms, bound "
              f"{k7_ms[B, T][2]:.4f} ms ({k7_ms[B, T][3]}: {w[0] / 1e9:.2f} GFLOP, {w[1] / 1e6:.2f} MB) on {card}")
    k7_split = {f"B={B} T={T}": k7_round_split(trace_lib, model.decoder, *kv(model.decoder, B, T), U,
                                               k7_ms[B, T][0], card)
                for B, T in ((1, 25), (16, 25))}
    # wide beams at B = 16, 4 s: W = 16 and 20 on the smem plan, 32 on the global one
    keys, values = kv(model.decoder, 16, 25)
    for W in (16, 20, 32):
        with torch.inference_mode():
            k7_ms["W", W] = cuda_ms(lambda: beam_decode(model.decoder, keys, values, None, W, U), reps=3, warmup=1)
        plan = "global" if plan_bytes(W, *flag, U) > SMEM_LIMIT else "smem"
        print(f"[time] K7 flagship B=16 T= 25 W={W} U={U}, clusters of {beam_cluster_size(16, 25, W, *flag, U)}, {plan} "
              f"plan of {plan_bytes(W, *flag, U)} bytes a CTA: kernel {k7_ms['W', W]:.4f} ms "
              f"({k7_ms['W', W] / U * 1e3:.2f} us a step), bound {bound(*k7_work(16, 25, W, U, *flag))[0]:.4f} ms "
              f"on {card}")
    for B in (1, 16):
        xd = torch.from_numpy(x[:B]).to(dev)
        ms = cuda_ms(lambda: model.predict_intents(xd), reps=10, warmup=2)
        print(f"[time] warm seq2seq predict_intents B={B:2d}, 4 s, W=4, U={U}: median {ms:.3f} ms of 10 "
              f"(CUDA events) on {card}")
    xd = torch.from_numpy(x).to(dev)
    profile_calls(lambda: model.predict_intents(xd), f"seq2seq predict_intents B=16, 4 s, W=4, U={U}", card,
                  reps=5)

    # 8.5 the main path: the seq2seq IntentServer, the traffic of phase 7
    reqs = [(0.1 * rng.standard_normal(int(t))).astype(np.float32) for t in rng.integers(16000, 64001, 32)]
    server = IntentServer(model, max_batch=SERVE_BATCH)
    try:
        server.warmup()
        beam_decode.launches = bigru_masked.launches = bigru_shared.launches = 0
        graphs = graph_counts(model)
        answers, sizes = serve_requests(server, reqs)
        launches = {"K7": beam_decode.launches, "K4f": bigru_masked.launches, "K1": bigru_shared.launches}
        captured, replayed = (b - a for a, b in zip(graphs, graph_counts(model)))
    finally:
        server.close()
    calls = sum(sizes.values())
    if (replayed != calls or launches != {"K7": captured, "K4f": 5 * captured, "K1": 0}
            or sum(k * v for k, v in sizes.items()) != 32):
        raise AssertionError(f"served seq2seq run: {calls} device calls ({sizes}), {replayed} graph replays, "
                             f"{captured} captures, launched {launches}; want a replay a call, 1 K7, 5 K4f and 0 "
                             "K1 a capture (its eager warm pass)")
    for i, got, _ in answers:
        want = model.decode_intents(reqs[i])[0]
        if got != want:
            raise AssertionError(f"served seq2seq request {i} ({len(reqs[i])} samples): {got!r}, exact-shape "
                                 f"{want!r}")
    lat = sorted(ms for *_, ms in answers)
    print(f"[serve] seq2seq IntentServer(max_batch={SERVE_BATCH}) after warmup: 32 requests of 1.0-4.0 s from "
          f"8 threads in {calls} device calls (by requests carried: {sizes}), each a CUDA graph's replay "
          f"({captured} captured in the run); launches {launches}; every answer equals its exact-shape decode")
    print(f"[time] seq2seq served latency (submit to answer, host clock): p50 {lat[len(lat) // 2]:.3f} ms, "
          f"p90 {lat[int(0.9 * len(lat))]:.3f} ms, max {lat[-1]:.3f} ms on {card}")
    return {"name": "beam_decode", "route": "cuda", "source": K7_SOURCE, "replaces": K7_REPLACES,
            "launches": launches["K7"], "max_abs_err": k7_err, "ms": k7_ms[16, 25][0],
            "plain_ms": k7_ms[16, 25][1], "bound_ms": k7_ms[16, 25][2], "bound_by": k7_ms[16, 25][3],
            "library_ms": None, "ms_30s": k7_ms[16, 188][0], "plain_ms_30s": k7_ms[16, 188][1],
            "bound_ms_30s": k7_ms[16, 188][2], "ms_b1": k7_ms[1, 25][0], "ms_30s_b1": k7_ms[1, 188][0],
            "us_per_step": k7_ms[16, 25][0] / U * 1e3, "cluster_by_batch": {
                str(B): beam_cluster_size(B, 25, 4, *flag, U) for B in (1, 16, 17, 33, 64, 133)},
            "round_split_us": k7_split, "ms_w16": k7_ms["W", 16], "ms_w20": k7_ms["W", 20],
            "ms_w32_global": k7_ms["W", 32]}


class FrontEndBranches:
    """The front end's data-dependent branches in a train step: the sign of
    each leaky ReLU's input and the argmax of each max-pool window. Where f32
    rounding puts a value on the other side of a branch than f64 does, the
    two steps differ by a whole branch at that element, and the sinc
    parameters' gradients, sums over every sample that cancel heavily, move
    by up to ~1e-3 of their largest element. ``record()`` keeps one step's
    branches; ``replay()`` makes another step take them, counting the
    elements where its own would differ, so that an f64 reference of the
    card's step differs from it by rounding alone."""

    def __init__(self):
        self.taken: list = []
        self.flips = 0

    @contextlib.contextmanager
    def _patched(self, relu, pool):
        from tpu_slu_torch.models import encoder as enc

        saved = enc.leaky_relu, enc.max_pool1d_ceil
        enc.leaky_relu, enc.max_pool1d_ceil = relu, pool
        try:
            yield self
        finally:
            enc.leaky_relu, enc.max_pool1d_ceil = saved

    def record(self):
        import torch.nn.functional as F

        self.taken = []

        def relu(x, slope=0.2):
            self.taken.append((x > 0).cpu())
            return F.leaky_relu(x, slope)

        def pool(x, k):
            if k == 1:
                return x
            out, idx = F.max_pool1d(x, k, ceil_mode=True, return_indices=True)
            self.taken.append(idx.cpu())
            return out

        return self._patched(relu, pool)

    def replay(self):
        import torch
        import torch.nn.functional as F

        taken = list(self.taken)
        self.flips = 0

        def relu(x, slope=0.2):
            keep = taken.pop(0).to(x.device)
            self.flips += int((keep != (x > 0)).sum())
            return torch.where(keep, x, slope * x)

        def pool(x, k):
            if k == 1:
                return x
            idx = taken.pop(0).to(x.device)
            self.flips += int((idx != F.max_pool1d(x, k, ceil_mode=True, return_indices=True)[1]).sum())
            return torch.gather(x, 2, idx)

        return self._patched(relu, pool)


def s2s_batches(rng, n: int, B: int, labels: list, U: int = S2S_U) -> list[dict]:
    """Seeded 4 s waveforms and one-hot label strings in the loader's seq2seq
    batch format over the vocabulary ``labels``: ``<sos>``, random printable
    characters, ``<eos>``, EOS-padded to U past each row's true length
    ``y_len`` (U/2..U, one row of U)."""
    import numpy as np

    sos, eos = labels.index("<sos>"), labels.index("<eos>")
    chars = np.array([i for i, c in enumerate(labels) if len(c) == 1 and c.isprintable()])
    out = []
    for _ in range(n):
        y_len = rng.integers(U // 2, U + 1, B)
        y_len[0] = U
        ids = chars[rng.integers(0, len(chars), (B, U))]
        ids[:, 0] = sos
        ids[np.arange(U)[None, :] >= y_len[:, None] - 1] = eos
        out.append({"x": (0.1 * rng.standard_normal((B, 4 * 16000))).astype(np.float32),
                    "y_intent": np.eye(len(labels), dtype=np.float32)[ids], "w": np.ones(B, np.float32),
                    "len": np.full(B, 4 * 16000, np.int64), "y_len": y_len.astype(np.int64)})
    return out


def phase_s2s_train(dev, card: str, rng, bwd_other) -> dict:
    """Phase 9: the seq2seq train step. Returns K4b's JSON entry; its
    launches are those of ``Trainer.train``; ``bwd_other`` is the
    ``bwd_other_c`` variant for ``[k4b-batch]``."""
    import numpy as np
    import torch

    from tpu_slu_torch.models.flagship import flagship_seq2seq_model
    from tpu_slu_torch.ops import beam as plain
    from tpu_slu_torch.ops.beam_fused import beam_decode
    from tpu_slu_torch.ops.bigru_masked import (
        bigru_masked,
        bigru_masked_bwd,
        bigru_masked_bwd_reference,
    )
    from tpu_slu_torch.ops.bigru_shared import bigru_cluster_size, bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.training import Trainer

    # 9.1 K4b against its plain version on the card
    def k4b_case(B, T, D, H, lengths):
        params, parts = k1_case(rng, 1, D, T, B, H, dev)
        x = parts[0].transpose(0, 1).contiguous()
        n = torch.from_numpy(np.asarray(lengths, np.int64)).to(dev)
        with torch.inference_mode():
            out = bigru_masked(params, x, n)
        dy = torch.from_numpy(rng.standard_normal((B, T, 2 * H)).astype(np.float32)).to(dev)
        return params, x, n, out, dy

    B, T, D, H = 64, 25, 256, 128  # the seq2seq encoder layer at 4 s of audio
    mixed = rng.integers(2, T + 1, 8)
    mixed[:3] = T, 0, 1
    waves = rng.integers(0, T + 1, 133)  # tiles of several rows, of different lengths
    waves[:3] = T, 0, 1
    cases = [("flagship layer", B, T, D, H, [T] * B), ("mixed lengths", 8, T, D, H, mixed.tolist()),
             ("mixed, B=133", 133, T, D, H, waves.tolist()), ("odd small", 5, 7, 12, 16, [7, 0, 1, 3, 6])]
    k4b_err = 0.0
    for name, Bc, Tc, Dc, Hc, lengths in cases:
        params, x, n, out, dy = k4b_case(Bc, Tc, Dc, Hc, lengths)
        before = bigru_masked_bwd.launches
        dx, grads = bigru_masked_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        assert bigru_masked_bwd.launches == before + 1, "K4b launch counter did not advance"
        rdx, rgrads = bigru_masked_bwd_reference(params, x, out, n, dy)
        pairs = [("dX", dx, rdx)] + [(f"{d}.{k}", grads[d][k], rgrads[d][k]) for d in grads for k in grads[d]]
        worst = 0.0
        for what, g, r in pairs:
            e = rel_err(g, r)
            worst = max(worst, e)
            k4b_err = max(k4b_err, (g - r).abs().max().item())
            if g.shape != r.shape or not e <= GRAD_TOL:
                raise AssertionError(f"K4b {name}: {what} off its plain version by {e:.3g} of its largest "
                                     f"element (limit {GRAD_TOL})")
        tail = torch.arange(Tc, device=dev)[None, :] >= n[:, None]
        if not (dx[tail] == 0).all():
            raise AssertionError(f"K4b {name}: dX past a row's length is not exactly 0")
        shown = lengths if Bc <= 8 else f"all {Tc}" if min(lengths) == Tc else f"mixed, 0 to {Tc}"
        print(f"[k4b] {name:14s} B={Bc:3d} T={Tc:2d} D={Dc:3d} H={Hc:3d} lengths {shown}: dX and the 8 weight and "
              f"bias gradients within {worst:.3g} of each largest element, dX exactly 0 past each length")
    print(f"[k4b] within {GRAD_TOL} of each tensor's largest element; max abs err {k4b_err:.3g}")

    # 9.2 one flagship seq2seq train step, card against the CPU plain path, B = 16
    cpu_model = flagship_seq2seq_model("cpu").train()
    card_model = copy.deepcopy(cpu_model).to(dev)
    b16 = s2s_batches(rng, 1, 16, cpu_model.Sy_intent)[0]

    def step(model, where, dtype=torch.float32):
        batch = {k: torch.from_numpy(v).to(where) for k, v in b16.items()}
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch["x"].to(dtype), batch["y_intent"].to(dtype), train=True,
                             weights=batch["w"].to(dtype), lengths=batch["len"], y_len=batch["y_len"],
                             generator=torch.Generator().manual_seed(5))
        loss.backward()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}

    l_cpu, g_cpu = step(cpu_model, torch.device("cpu"))
    branches = FrontEndBranches()
    with branches.record():
        l_card, g_card = step(card_model, dev)
    m64 = copy.deepcopy(cpu_model).double()
    l64, g64_own = step(m64, torch.device("cpu"), torch.float64)
    with branches.replay():
        g64 = step(m64, torch.device("cpu"), torch.float64)[1]
    del m64
    print(f"[s2s-grad] front-end branches (leaky ReLU signs, max-pool argmaxes) where the card's step and the "
          f"f64 step part: {branches.flips}")
    front = front_end_params(cpu_model)
    for n in [n for n in g64 if n in front]:
        e_card, e_cpu = rel_err(g_card[n].cpu().double(), g64[n]), rel_err(g_cpu[n].double(), g64_own[n])
        print(f"[s2s-grad] {n} gradient vs f64, of its largest element: card {e_card:.3g} (against the f64 "
              f"step with its own branches {rel_err(g_card[n].cpu().double(), g64_own[n]):.3g}), CPU f32 "
              f"{e_cpu:.3g}")
    print(f"[s2s-grad] loss: card {l_card:.6f}, CPU {l_cpu:.6f}, f64 {l64:.6f} (card - CPU {l_card - l_cpu:.3g}, "
          f"card - f64 {l_card - l64:.3g}, CPU - f64 {l_cpu - l64:.3g})")
    worst, faults = 0.0, []
    for n, g in g_cpu.items():
        if g is None:  # the encoder's phoneme/word heads take no part in the SLU loss
            if g_card[n] is not None:
                faults.append(f"{n}: a card gradient where the CPU has none")
            continue
        ref = g64[n] if n in front else g.double()
        scale = g_cpu[KEY_WEIGHT].abs().max().item() if n == KEY_BIAS else ref.abs().max().item()
        e = (g_card[n].cpu().double() - ref).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, e)
        if not e <= STEP_GRAD_TOL:
            faults.append(f"{n}: off the {'f64' if n in front else 'CPU'} reference's by {e:.3g}")
    if not abs(l_card - l_cpu) <= STEP_LOSS_ATOL:
        faults.append(f"loss: card {l_card} vs CPU {l_cpu}")
    if faults:
        raise AssertionError("seq2seq train step, card vs CPU: " + "; ".join(faults))
    print(f"[s2s-grad] flagship seq2seq train step B=16, 4 s, U={S2S_U}, dropout 0.5, card vs CPU: loss "
          f"{l_card:.6f} vs {l_cpu:.6f} (atol {STEP_LOSS_ATOL}); every gradient within {worst:.3g} of its "
          f"largest element (limit {STEP_GRAD_TOL}), the front end's of the f64 reference's on the "
          f"card's front-end branches, the key bias's of the key weight's largest")
    del cpu_model, card_model, g_cpu, g_card, g64, g64_own

    # 9.3 the main path: Trainer.train over seeded batches of B = 64, then Trainer.test
    model = flagship_seq2seq_model(dev, seed=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_s2s_train_")
    try:
        model.config.folder = tmp
        model.config.decode_acc_from_epoch = 0
        trainer = Trainer(model, model.config, generator=torch.Generator().manual_seed(7))
        B = model.config.training_batch_size
        data = Batches(s2s_batches(rng, 3, B, model.Sy_intent))
        steps = len(data.loader)
        bigru_shared.launches = bigru_trainpool.launches = bigru_shared_bwd.launches = 0
        bigru_masked.launches = bigru_masked_bwd.launches = beam_decode.launches = 0
        acc, loss = trainer.train(data)
        torch.cuda.synchronize()
        launches = {"K1": bigru_shared.launches, "K2": bigru_trainpool.launches,
                    "K3": bigru_shared_bwd.launches, "K4f": bigru_masked.launches,
                    "K4b": bigru_masked_bwd.launches, "K7": beam_decode.launches}
        want = {"K1": 0, "K2": 4 * steps, "K3": 4 * steps, "K4f": steps, "K4b": steps, "K7": 0}
        if launches != want:
            raise AssertionError(f"seq2seq Trainer.train over {steps} steps launched {launches}; want 4 K2, "
                                 "4 K3, 1 K4f, 1 K4b and no K1 per step")
        if not (np.isfinite(loss) and acc == 0.0):
            raise AssertionError(f"seq2seq Trainer.train: loss {loss}, acc {acc}")
        with open(os.path.join(tmp, "training", "log.csv")) as f:
            header = f.readline().strip()
        if not header.startswith(",intent_loss,intent_acc,set,examples_per_sec,steps"):
            raise AssertionError(f"log.csv header {header!r}")
        print(f"[s2s-trainer] Trainer.train at all_real_seq2seq.cfg width, B={B}, 4 s, U={S2S_U}, {steps} "
              f"steps: loss {loss:.4f}; launches {launches}; log.csv {header}")
        one = Batches(data.loader[:1])
        plain_calls = []
        real_search = plain.beam_search
        plain.beam_search = lambda *args, **kw: plain_calls.append(1) or real_search(*args, **kw)
        try:
            beam_decode.launches = 0
            t_acc, t_loss = trainer.test(one)
            torch.cuda.synchronize()
        finally:
            plain.beam_search = real_search
        if beam_decode.launches != 1 or plain_calls or not (np.isfinite(t_loss) and 0.0 <= t_acc <= 1.0):
            raise AssertionError(f"seq2seq Trainer.test: {beam_decode.launches} K7 launches, {len(plain_calls)} "
                                 f"plain searches, loss {t_loss}, acc {t_acc}")
        print(f"[s2s-trainer] Trainer.test (decode_acc_from_epoch=0) on 1 batch of {B}: 1 K7 launch, no plain "
              f"search; loss {t_loss:.4f}, exact-match acc {t_acc:.3f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 9.4 timings: K4b against its plain version, bound and cuDNN; the warm train step
    params, x, n, out, dy = k4b_case(B, T, D, H, [T] * B)
    kern, pl = in_turns(lambda: bigru_masked_bwd_reference(params, x, out, n, dy),
                        lambda: bigru_masked_bwd(params, x, out, n, dy))
    lib = cudnn_gru_ms(D, T, B, H, dev, backward=True)
    rows = int(n.sum())  # the valid (t, b) rows: all of them on the train path
    # per valid row and direction: gi and gh recomputed, the dh chain, dX, dW_ih, dW_hh
    # (2 * 3H * (3D + 3H)) and the gate derivatives; in: x, out, dy, weights; out: dX and
    # the weight gradients
    w = (2 * rows * (2 * 3 * H * (3 * D + 3 * H) + 2 * GATE_OPS * H),
         4 * (2 * B * T * D + 4 * B * T * H + 2 * gru_weight_floats(D, H)))
    k4b_bound, k4b_by = bound(*w)
    print(f"[time] K4b seq2seq encoder layer B={B} T={T} D={D} H={H}: kernel {kern:.4f} ms, plain {pl:.3f} ms, "
          f"cuDNN nn.GRU backward {lib:.4f} ms, bound {k4b_bound:.4f} ms ({k4b_by}: {w[0] / 1e9:.2f} GFLOP, "
          f"{w[1] / 1e6:.2f} MB) on {card}")
    k4b_split = device_split(lambda: bigru_masked_bwd(params, x, out, n, dy), K4B_PHASES)
    print(f"[time] K4b seq2seq encoder layer B={B} T={T} by phase (profiler, device ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k4b_split.items())
          + f"; the chain {1e3 * k4b_split['chain'] / T:.3f} us a step on clusters of {bigru_cluster_size(B)} on "
          f"{card}")
    k4b_ab = bwd_cluster_ab("K4b", dev, card, rng, bwd_other, (SERVE_BATCH, 64))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.loader[0].items()}
    step_ms = cuda_ms(lambda: trainer.train_step(batch), reps=10, warmup=2)
    print(f"[time] warm seq2seq train step B={B}, 4 s, U={S2S_U} (forward, backward, masked Adam): median "
          f"{step_ms:.3f} ms of 10 (CUDA events) on {card}")
    profile_calls(lambda: trainer.train_step(batch), f"seq2seq train step B={B}, 4 s, U={S2S_U}", card,
                  reps=5, top=12)
    return {"name": "bigru_masked_bwd", "route": "cuda", "source": K4B_SOURCE, "replaces": K4B_REPLACES,
            "launches": launches["K4b"], "max_abs_err": k4b_err, "ms": kern, "plain_ms": pl,
            "bound_ms": k4b_bound, "bound_by": k4b_by, "library_ms": lib, "phase_ms": k4b_split,
            "ab_cluster": k4b_ab}


def phase_uni(dev, card: str, rng, bwd_other) -> list[dict]:
    """Phase 10: the flagship with every GRU layer unidirectional
    (``UNIDIRECTIONAL``), decode, serve and train. Returns K5f's and K5b's
    JSON entries; their launches are those of ``Trainer.train``;
    ``bwd_other`` is the ``bwd_other_c`` variant for ``[k5b-batch]``."""
    import numpy as np
    import torch

    from tpu_slu_torch.models.flagship import TRAIN_CFG, UNIDIRECTIONAL, flagship_model
    from tpu_slu_torch.ops.bigru_masked import bigru_masked, bigru_masked_bwd
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.ops.gru1 import (gru1, gru1_bwd, gru1_bwd_reference, gru1_cluster_size, gru1_fwd,
                                         gru1_reference)
    from tpu_slu_torch.serving import IntentServer
    from tpu_slu_torch.training import Trainer

    H = 128
    others = {"K1": bigru_shared, "K2": bigru_trainpool, "K3": bigru_shared_bwd, "K4f": bigru_masked,
              "K4b": bigru_masked_bwd}

    def zero() -> None:
        """Set every GRU kernel's launch count to 0, just before a run that reads them."""
        gru1.launches = gru1_bwd.launches = 0
        for f in others.values():
            f.launches = 0

    def counts() -> dict:
        return {"K5f": gru1.launches, "K5b": gru1_bwd.launches, **{k: f.launches for k, f in others.items()}}

    def layer_case(B, T, D, Hc, lengths):
        params, parts = k1_case(rng, 1, D, T, B, Hc, dev)
        n = None if lengths is None else torch.from_numpy(np.asarray(lengths, np.int64)).to(dev)
        return {"fwd": params["fwd"]}, parts[0].transpose(0, 1).contiguous(), n

    # 10.1 K5f and K5b against their plain versions: the five layer shapes at B = 16
    # (decode) and 64 (train), B = 8 with mixed lengths (0 and 1 among them), an odd small shape
    cases = []
    for name, D, T in UNI_SHAPES:
        mixed = rng.integers(2, T + 1, SERVE_BATCH)
        mixed[:3] = T, 0, 1
        cases += [(name, 16, T, D, H, None), (name, 64, T, D, H, None), (name, SERVE_BATCH, T, D, H, mixed.tolist())]
    cases.append(("odd small", 5, 7, 12, 16, [7, 0, 1, 3, 6]))
    k5f_err = k5b_err = 0.0
    for name, B, T, D, Hc, lengths in cases:
        params, x, n = layer_case(B, T, D, Hc, lengths)
        zero()
        with torch.inference_mode():
            out = gru1_fwd(params, x, n)
        dy = torch.from_numpy(rng.standard_normal((B, T, Hc)).astype(np.float32)).to(dev)
        dx, grads = gru1_bwd(params, x, out, n, dy)
        torch.cuda.synchronize()
        assert counts() == {"K5f": 1, "K5b": 1, **{k: 0 for k in others}}, counts()
        ref = gru1_reference(params, x, n)
        e = rel_err(out, ref)
        k5f_err = max(k5f_err, (out - ref).abs().max().item())
        if out.shape != ref.shape or not e <= ATOL:
            raise AssertionError(f"K5f {name} B={B} T={T}: off its plain version by {e:.3g} of the largest "
                                 f"element (limit {ATOL})")
        rdx, rgrads = gru1_bwd_reference(params, x, out, n, dy)
        worst = 0.0
        for what, g, r in [("dX", dx, rdx)] + [(k, grads["fwd"][k], rgrads["fwd"][k]) for k in grads["fwd"]]:
            worst = max(worst, rel_err(g, r))
            k5b_err = max(k5b_err, (g - r).abs().max().item())
            if g.shape != r.shape or not rel_err(g, r) <= GRAD_TOL:
                raise AssertionError(f"K5b {name} B={B} T={T}: {what} off its plain version by {rel_err(g, r):.3g} "
                                     f"of its largest element (limit {GRAD_TOL})")
        if n is not None:
            tail = torch.arange(T, device=dev)[None, :] >= n[:, None]
            if not ((out[tail] == 0).all() and (dx[tail] == 0).all()):
                raise AssertionError(f"K5f/K5b {name} B={B} T={T}: an output or dX past a row's length is not 0")
        print(f"[k5f] {name:11s} B={B:2d} T={T:3d} D={D:3d} H={Hc:3d} "
              f"{'lengths ' + str(lengths) if lengths is not None else 'every row T'}: max abs err "
              f"{(out - ref).abs().max().item():.3g} (rel {e:.3g}); [k5b] dX, dW, db within {worst:.3g} of each "
              f"largest element{'; zeros past each length' if lengths is not None else ''}")
    print(f"[k5f] within {ATOL} of the largest element, max abs err {k5f_err:.3g}; [k5b] within {GRAD_TOL}, max abs "
          f"err {k5b_err:.3g}")

    # 10.2 decode at the input's shape, card against the CPU
    cpu_model = flagship_model("cpu", **UNIDIRECTIONAL)
    model = copy.deepcopy(cpu_model).to(dev)
    x_dec = (0.1 * np.random.default_rng(4).standard_normal((16, 4 * 16000))).astype(np.float32)
    decode_launches = 0
    for B in (1, 16):
        zero()
        decoded = model.decode_intents(x_dec[:B])
        torch.cuda.synchronize()
        launched = counts()
        decode_launches += launched["K5f"]
        if launched != {"K5f": 5, "K5b": 0, **{k: 0 for k in others}}:
            raise AssertionError(f"uni decode B={B} launched {launched}; want 5 K5f and nothing else")
        logits, preds = model.predict_intents(x_dec[:B])
        ref, ref_preds = cpu_model.predict_intents(x_dec[:B])
        err = (logits.cpu() - ref).abs().max().item()
        if not (torch.isfinite(logits).all() and err <= LOGIT_ATOL):
            raise AssertionError(f"uni decode B={B}: card vs CPU logits max abs err {err:.3g} > {LOGIT_ATOL}")
        print(f"[uni] unidirectional flagship decode_intents B={B}: 5 K5f launches, no K1 or K4f; logits card vs "
              f"CPU max abs err {err:.3g} (atol {LOGIT_ATOL}); predictions equal: "
              f"{bool((preds.cpu() == ref_preds).all())}; first {decoded[0]}")

    # 10.3 length-exact decode of (8, 4 s bucket) against each example's exact-shape decode
    n_samples = rng.integers(16000, 64001, SERVE_BATCH)
    n_samples[0] = 64000
    waves = [(0.1 * rng.standard_normal(int(t))).astype(np.float32) for t in n_samples]
    xb = np.zeros((SERVE_BATCH, 64000), np.float32)
    for i, w in enumerate(waves):
        xb[i, :len(w)] = w
    zero()
    logits, preds = model.predict_intents(xb, lengths=n_samples)
    torch.cuda.synchronize()
    if counts() != {"K5f": 5, "K5b": 0, **{k: 0 for k in others}}:
        raise AssertionError(f"uni length-exact decode launched {counts()}; want 5 K5f and nothing else")
    worst = 0.0
    for i, w in enumerate(waves):
        alone, alone_preds = model.predict_intents(w)
        e = (logits[i] - alone[0]).abs().max().item()
        worst = max(worst, e)
        if not (torch.isfinite(logits[i]).all() and e <= EXACT_LOGIT_ATOL and torch.equal(preds[i], alone_preds[0])):
            raise AssertionError(f"uni length-exact row {i} ({len(w)} samples): logits off its exact-shape decode "
                                 f"by {e:.3g} (atol {EXACT_LOGIT_ATOL}) or predictions differ")
    print(f"[uni] predict_intents(lengths=) at ({SERVE_BATCH}, 64000), lengths {n_samples.tolist()}: 5 K5f launches, "
          f"no K4f or K1; each row within {worst:.3g} of its exact-shape decode (atol {EXACT_LOGIT_ATOL})")

    # 10.4 the serve path: an IntentServer answering phase 7's traffic
    reqs = [(0.1 * rng.standard_normal(int(t))).astype(np.float32) for t in rng.integers(16000, 64001, 32)]
    server = IntentServer(model, max_batch=SERVE_BATCH)
    try:
        server.warmup()
        zero()
        graphs = graph_counts(model)
        answers, sizes = serve_requests(server, reqs)
        served = counts()
        captured, replayed = (b - a for a, b in zip(graphs, graph_counts(model)))
    finally:
        server.close()
    calls = sum(sizes.values())
    if (replayed != calls or served != {"K5f": 5 * captured, "K5b": 0, **{k: 0 for k in others}}
            or sum(k * v for k, v in sizes.items()) != 32):
        raise AssertionError(f"served uni run: {calls} device calls ({sizes}), {replayed} graph replays, "
                             f"{captured} captures, launched {served}; want a replay a call and 5 K5f a capture")
    for i, got, _ in answers:
        want = model.decode_intents(reqs[i])[0]
        if got != want:
            raise AssertionError(f"served uni request {i} ({len(reqs[i])} samples): {got}, exact-shape {want}")
    lat = sorted(ms for *_, ms in answers)
    print(f"[serve] unidirectional IntentServer(max_batch={SERVE_BATCH}): 32 requests of 1.0-4.0 s from 8 threads in "
          f"{calls} device calls ({sizes}), each a CUDA graph's replay ({captured} captured in the run), "
          f"{served['K5f']} K5f launches and no other GRU kernel; every answer equals "
          f"its exact-shape decode; p50 {lat[len(lat) // 2]:.3f} ms, p90 {lat[int(0.9 * len(lat))]:.3f} ms (host "
          f"clock) on {card}")

    # 10.5 the train path: one step card vs CPU, then Trainer.train at B = 64
    step_vs_cpu(dev, rng, "uni-step", **UNIDIRECTIONAL)
    train_model = flagship_model(dev, cfg=TRAIN_CFG, seed=1, **UNIDIRECTIONAL)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_uni_")
    try:
        train_model.config.folder = tmp
        trainer = Trainer(train_model, train_model.config, generator=torch.Generator().manual_seed(7))
        B = train_model.config.training_batch_size
        data = Batches(synthetic_batches(rng, 3, B, train_model.values_per_slot))
        steps = len(data.loader)
        zero()
        acc, loss = trainer.train(data)
        torch.cuda.synchronize()
        launches = counts()
        if launches != {"K5f": 5 * steps, "K5b": 5 * steps, **{k: 0 for k in others}}:
            raise AssertionError(f"uni Trainer.train over {steps} steps launched {launches}; want 5 K5f and 5 K5b "
                                 "a step and no other GRU kernel")
        if not (np.isfinite(loss) and np.isfinite(acc)):
            raise AssertionError(f"uni Trainer.train: loss {loss}, acc {acc}")
        print(f"[uni-trainer] Trainer.train at no_pretraining.cfg width, unidirectional, B={B}, {steps} steps: loss "
              f"{loss:.4f} acc {acc:.3f}; launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10.6 timings: K5f at B = 16 (and B = 8 with mixed lengths), K5b at B = 64, per layer
    # and summed, against their plain versions, their bounds and cuDNN as a yardstick
    tot = {k: [0.0, 0.0, 0.0] for k in ("k5f", "k5f masked", "k5b")}  # kernel, plain, cuDNN
    work = {k: [0.0, 0.0] for k in tot}  # FLOPs, bytes
    for name, D, T in UNI_SHAPES:
        rows = []
        params, x, _ = layer_case(16, T, D, H, None)
        with torch.inference_mode():
            a, b = in_turns(lambda: gru1_reference(params, x), lambda: gru1_fwd(params, x))
        w = gru_fwd_work(16 * T, D, H, 16 * T * D, 16 * T * H, dirs=1)
        rows.append(("k5f", 16, a, b, cudnn_gru_ms(D, T, 16, H, dev, bidirectional=False), w))
        lengths = rng.integers(1, T + 1, SERVE_BATCH)
        lengths[0], lengths[-1] = T, 0
        params, x, n = layer_case(SERVE_BATCH, T, D, H, lengths)
        with torch.inference_mode():
            a, b = in_turns(lambda: gru1_reference(params, x, n), lambda: gru1_fwd(params, x, n))
        valid = int(lengths.sum())
        w = gru_fwd_work(valid, D, H, valid * D, SERVE_BATCH * T * H, dirs=1)
        rows.append(("k5f masked", SERVE_BATCH, a, b,
                     cudnn_gru_ms(D, T, SERVE_BATCH, H, dev, lengths=lengths.tolist(), bidirectional=False), w))
        params, x, _ = layer_case(64, T, D, H, None)
        with torch.inference_mode():
            out = gru1_fwd(params, x)
        dy = torch.from_numpy(rng.standard_normal((64, T, H)).astype(np.float32)).to(dev)
        a, b = in_turns(lambda: gru1_bwd_reference(params, x, out, None, dy), lambda: gru1_bwd(params, x, out, None, dy))
        # per row: gi and gh recomputed, the dh chain, dX, dW_ih, dW_hh (2 * 3H * (3D + 3H)) and the
        # gate derivatives; in: x, out, dy, weights; out: dX and the weight gradients
        w = (64 * T * (2 * 3 * H * (3 * D + 3 * H) + 2 * GATE_OPS * H),
             4 * (2 * 64 * T * D + 2 * 64 * T * H + 2 * gru_weight_floats(D, H, dirs=1)))
        rows.append(("k5b", 64, a, b, cudnn_gru_ms(D, T, 64, H, dev, backward=True, bidirectional=False), w))
        for what, B, a, b, lib, w in rows:
            tot[what] = [tot[what][0] + a, tot[what][1] + b, tot[what][2] + lib]
            work[what] = [work[what][0] + w[0], work[what][1] + w[1]]
            yard = {"k5f": "cuDNN nn.GRU", "k5f masked": "cuDNN nn.GRU on packed rows",
                    "k5b": "cuDNN nn.GRU backward"}[what]
            print(f"[time] {what.upper().replace(' MASKED', ' masked'):10s} {name:11s} B={B:2d} T={T:3d} D={D:3d}: "
                  f"kernel {a:.4f} ms, plain {b:.3f} ms, {yard} {lib:.4f} ms, bound {bound(*w)[0]:.4f} ms "
                  f"({bound(*w)[1]})")
    bounds = {k: bound(*w) for k, w in work.items()}
    steps = sum(T for *_, T in UNI_SHAPES)  # K5f's serial steps over the five layers (each tile has a full row)
    for what, (a, b, lib) in tot.items():
        per_step = f", {1e3 * a / steps:.3f} us a step" if what.startswith("k5f") else ""
        print(f"[time] {what} five layers: kernel {a:.4f} ms{per_step}, plain {b:.3f} ms, cuDNN {lib:.4f} ms, "
              f"bound {bounds[what][0]:.4f} ms ({bounds[what][1]}) on {card}")
    # K5b's five layers at B = 64 by phase, and on clusters of 2 and of 4
    k5b_cases = []
    for _, D, T in UNI_SHAPES:
        params, x, _ = layer_case(64, T, D, H, None)
        with torch.inference_mode():
            out = gru1_fwd(params, x)
        k5b_cases.append((params, x, out, torch.from_numpy(rng.standard_normal((64, T, H)).astype(np.float32)).to(dev)))
    k5b_split = device_split(lambda: [gru1_bwd(p, x, o, None, d) for p, x, o, d in k5b_cases], K5B_PHASES)
    print(f"[time] K5b five layers B=64 by phase (profiler, device ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in k5b_split.items())
          + f"; the chain {1e3 * k5b_split['chain'] / steps:.3f} us a step on clusters of {gru1_cluster_size(64)} "
          f"on {card}")
    k5b_ab = bwd_cluster_ab("K5b", dev, card, rng, bwd_other, (64,))

    # 10.7 K5f by batch, each at the cluster size the kernel takes there (4 CTAs while every row gets a
    # cluster of its own in one wave of the SMs, else 2): the five layers back to back, two turns, at
    # B = 16, at the served B = 8 with mixed lengths and at the train step's B = 64
    cluster_by_batch = {}
    for B, masked in ((16, False), (SERVE_BATCH, True), (64, False)):
        cases = []
        for name, D, T in UNI_SHAPES:
            lengths = None
            if masked:
                lengths = rng.integers(1, T + 1, B)
                lengths[0], lengths[-1] = T, 0
            cases.append(layer_case(B, T, D, H, lengths))

        def five():
            with torch.inference_mode():
                for params, x, n in cases:
                    gru1_fwd(params, x, n)

        turns = [cuda_ms(five, reps=10, warmup=2) for _ in range(2)]
        tag = f"B={B}{' masked' if masked else ''}"
        cluster_by_batch[tag] = {"C": gru1_cluster_size(B), "ms": turns}
        print(f"[k5f-batch] K5f five layers {tag}, clusters of {cluster_by_batch[tag]['C']}: turns "
              f"{turns[0]:.4f}, {turns[1]:.4f} ms ({1e3 * statistics.mean(turns) / steps:.3f} us a step) on {card}")
    for B in (1, 16):
        xd = torch.from_numpy(x_dec[:B]).to(dev)
        ms = cuda_ms(lambda: model.predict_intents(xd), reps=30, warmup=5)
        print(f"[time] warm unidirectional predict_intents B={B:2d}, 4 s: median {ms:.3f} ms of 30 (CUDA events) "
              f"on {card}")
    B = train_model.config.training_batch_size
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.loader[0].items()}
    step_ms = cuda_ms(lambda: trainer.train_step(batch), reps=10, warmup=2)
    print(f"[time] warm unidirectional train step B={B}, 4 s (forward, backward, masked Adam): median "
          f"{step_ms:.3f} ms of 10 (CUDA events) on {card}")
    profile_calls(lambda: trainer.train_step(batch), f"unidirectional train step B={B}, 4 s", card, reps=5, top=12)
    return [
        {"name": "gru1_fwd", "route": "cuda", "source": K5F_SOURCE, "replaces": K5F_REPLACES,
         "launches": launches["K5f"], "launches_decode": decode_launches, "launches_served": served["K5f"],
         "max_abs_err": k5f_err, "ms": tot["k5f"][0], "plain_ms": tot["k5f"][1], "bound_ms": bounds["k5f"][0],
         "us_per_step": 1e3 * tot["k5f"][0] / steps, "cluster_by_batch": cluster_by_batch,
         "bound_by": bounds["k5f"][1], "library_ms": tot["k5f"][2], "masked_ms": tot["k5f masked"][0],
         "masked_library_ms": tot["k5f masked"][2]},
        {"name": "gru1_bwd", "route": "cuda", "source": K5B_SOURCE, "replaces": K5B_REPLACES,
         "launches": launches["K5b"], "max_abs_err": k5b_err, "ms": tot["k5b"][0], "plain_ms": tot["k5b"][1],
         "bound_ms": bounds["k5b"][0], "bound_by": bounds["k5b"][1], "library_ms": tot["k5b"][2],
         "phase_ms": k5b_split, "ab_cluster": k5b_ab},
    ]


def ab_turns(routes, B_list, fn_of, timer=None) -> dict:
    """Same-process A/B of two routes in turns (first, second, second, first)
    at each B: ``fn_of(route, B)`` gives the call to time, ``timer(fn)``
    its ms a call (default: the median of 20 calls, CUDA events). Returns
    {(B, route): [the two turns' ms]}."""
    timer = timer or (lambda fn: cuda_ms(fn, reps=20, warmup=3))
    first, second = routes
    out = {}
    for B in B_list:
        fns = {r: fn_of(r, B) for r in routes}
        for r in (first, second, second, first):
            out.setdefault((B, r), []).append(timer(fns[r]))
    return out


def faster(ab: dict, routes, B_list) -> str | None:
    """The route whose mean of its turns is below the other's at every B, else None."""
    a, b = routes
    wins = {statistics.mean(ab[B, a]) < statistics.mean(ab[B, b]) for B in B_list}
    return a if wins == {True} else b if wins == {False} else None


def phase_routes(dev, card: str, rng, k8_main: int) -> list[dict]:
    """Phase 11: K8 (the fused sinc front end) and K6 (K1's row-stacked
    layout), the two routes of the exact-shape eval path. Returns their
    JSON entries: K8's launches are ``k8_main``, those of phase 5's decode
    on the default route; K6's are those of the flagship decode through
    both (11.5)."""
    import numpy as np
    import torch

    from tpu_slu_torch.models.encoder import DEFAULT_FRONTEND, DEFAULT_GRU_LAYOUT, apply_stack
    from tpu_slu_torch.models.flagship import flagship_model
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_shared import bigru_cluster_size, bigru_shared, bigru_shared_rowstack_reference
    from tpu_slu_torch.ops.frontend_fused import (PLAN_ARGS, frontend_plan, sinc_frontend_fused,
                                                  sinc_frontend_reference)
    from tpu_slu_torch.ops.sinc import mel_init, sinc_filters

    flagship_kw = dict(filt_dim=401, fs=16000, stride=80, padding=200, pool=2, act="leaky_relu")

    def k8_case(B, T, F):
        b1, band = (torch.from_numpy(a).to(dev) for a in mel_init(F, 16000))
        x = torch.from_numpy((0.1 * rng.standard_normal((B, T))).astype(np.float32)).to(dev)
        return b1, band, x

    # 11.1 K8 against its plain version (the cuDNN conv, |.|, ceil max pool, act)
    k8_err = 0.0
    small_kw = dict(filt_dim=31, fs=16000, stride=10, padding=15, pool=2)
    for name, B, T, F, kw in [("flagship 4 s", 1, 64000, 80, flagship_kw), ("flagship 4 s", 8, 64000, 80, flagship_kw),
                              ("flagship 4 s", 16, 64000, 80, flagship_kw),
                              ("flagship 3.3 s", 16, 52800, 80, flagship_kw),
                              ("flagship 4 s relu", 16, 64000, 80, {**flagship_kw, "act": "relu"}),
                              ("flagship 4 s", 128, 64000, 80, flagship_kw), ("flagship 1 s", 300, 16000, 80, flagship_kw),
                              ("ASR test 2.25 s", 64, ASR_T, 80, flagship_kw),
                              ("small", 3, 1600, 16, small_kw), ("small ragged", 3, 1555, 16, small_kw)]:
        b1, band, x = k8_case(B, T, F)
        before = sinc_frontend_fused.launches
        with torch.inference_mode():
            got = sinc_frontend_fused(b1, band, x, **kw)
            torch.cuda.synchronize()
            ref = sinc_frontend_reference(b1, band, x, **kw)
        if sinc_frontend_fused.launches != before + 1:
            raise AssertionError(f"K8 {name} B={B}: launches +{sinc_frontend_fused.launches - before}, want 1")
        e = rel_err(got, ref)
        k8_err = max(k8_err, (got - ref).abs().max().item())
        if got.shape != ref.shape or not e <= CONV_RTOL:
            raise AssertionError(f"K8 {name} B={B} T={T}: off its plain version by {e:.3g} of the largest output "
                                 f"(limit {CONV_RTOL})")
        print(f"[k8] {name:17s} B={B:3d} T={T:5d} F={F} K={kw['filt_dim']} S={kw['stride']} pool={kw['pool']}: "
              f"out {tuple(got.shape)}, max abs err {(got - ref).abs().max().item():.3g} (rel {e:.3g}, limit "
              f"{CONV_RTOL})")

    # 11.2 K8's device time at 4 s, by CUDA graph replay (both routes also compute the filter
    # bank, ~20 small launches whose host time CUDA events around a call would charge): the
    # kernel alone (its entry point on a precomputed filter bank, on the wrapper's plan), its
    # route with the filter bank, its plain version (the composed route), one cuDNN conv call
    # alone (TF32 off; without |.|, pool and act) and the bound. Each is timed with one call
    # a replay (the numbers of the kernels line) and amortized over 10 calls a replay, which
    # spreads the replay's own launch (several us) over the calls
    lib_k = _build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k8_ms = {}
    for B in (1, 16, 128):
        b1, band, x = k8_case(B, 64000, 80)
        filt = sinc_filters(b1, band, 401, 16000).contiguous()
        filt4 = filt[:, None, None, :]
        x4 = x[:, None, None, :]
        out = torch.empty((B, 80, 400), device=dev)
        plan = frontend_plan(B, 64000, 80, 401, 80, 200, 2, sms)

        def kernel_alone():
            _build.check(lib_k.tsl_sinc_frontend_fwd(
                x.data_ptr(), filt.data_ptr(), out.data_ptr(), B, 64000, 80, 401, 80, 200, 2, 1,
                *(plan[k] for k in PLAN_ARGS), torch.cuda.current_stream(dev).cuda_stream), "K8")

        fns = {"kernel": kernel_alone,
               "route": lambda: sinc_frontend_fused(b1, band, x, **flagship_kw),
               "plain": lambda: sinc_frontend_reference(b1, band, x, **flagship_kw),
               "cudnn": lambda: torch.cudnn_convolution(x4, filt4, (0, 200), (1, 80), (1, 1), 1, False, False,
                                                        False)}
        with torch.inference_mode():
            t = {(k, calls): graph_ms(fn, calls=calls) for calls in (1, 10) for k, fn in fns.items()}
            prof = device_ms(fns["route"], name="sinc_frontend_kernel")
            events = cuda_ms(fns["route"], reps=20, warmup=3)
        t_out, t_pool = 800, 400
        w = (2.0 * B * t_out * 80 * 401, 4.0 * (B * 64000 + 80 * 401 + 2 * 80 + B * t_pool * 80))
        k8_ms[B] = dict(ms=t["kernel", 1], plain=t["plain", 1], lib=t["cudnn", 1], ms10=t["kernel", 10],
                        lib10=t["cudnn", 10], prof=prof)
        k8_ms[B]["bound"], k8_ms[B]["by"] = bound(*w)
        print(f"[time] K8 flagship B={B:3d} 4 s, plan: items of {plan['rows']} conv rows x {plan['ftile']} filters "
              f"({plan['nft']} filter tiles), taps in {plan['ksplit']} groups, {plan['grid']} CTAs of "
              f"{plan['threads']} threads, {plan['smem']} bytes of shared memory, {B * plan['nrt'] * plan['nft']} items")
        for calls in (1, 10):
            print(f"[time] K8 flagship B={B:3d} 4 s, device time (graph replay, {calls} call{'s' * (calls > 1)} a "
                  f"replay): kernel {t['kernel', calls]:.5f} ms, with the filter bank {t['route', calls]:.4f} ms; "
                  f"plain (filter bank, cuDNN conv, |.|, pool, act) {t['plain', calls]:.4f} ms; cuDNN conv alone "
                  f"{t['cudnn', calls]:.5f} ms; bound {k8_ms[B]['bound']:.5f} ms ({k8_ms[B]['by']}: "
                  f"{w[0] / 1e9:.3f} GFLOP, {w[1] / 1e6:.2f} MB), {k8_ms[B]['bound'] / t['kernel', calls]:.1%} of "
                  f"it reached, on {card}")
        print(f"[time] K8 flagship B={B:3d} 4 s: kernel {prof:.5f} ms by torch.profiler; the route "
              f"{events:.4f} ms by CUDA events around the call, on {card}")

    # 11.3 the A/B that sets the front end's default: the composed route (P) against
    # K8 (C) over the front end's five specs, then the whole warm decode, in turns P, C, C, P
    model = flagship_model(dev)
    enc = model.pretrained_model
    specs = enc.arch.phoneme_layers[:5]
    assert [s.kind for s in specs] == ["sinc", "abs", "pool", "act", "dropout"], specs
    waves = {B: torch.from_numpy((0.1 * rng.standard_normal((B, 64000))).astype(np.float32)).to(dev)
             for B in (1, 16, 128)}

    def front(route, B):
        x3 = waves[B][:, None, :]

        def run():
            with torch.inference_mode():
                return apply_stack(enc.phoneme_layers, specs, x3, frontend=route)
        return run

    def decode(attr):
        def fn_of(route, B):
            def run():
                setattr(enc, attr, route)
                return model.predict_intents(waves[B])
            return run
        return fn_of

    fronts = ("composed", "fused")
    ab_front = ab_turns(fronts, (1, 16, 128), front, timer=graph_ms)
    ab_front_dec = ab_turns(fronts, (1, 16), decode("frontend"), timer=device_ms)
    ab_front_wall = ab_turns(fronts, (1, 16), decode("frontend"))
    ab_front_host = ab_turns(fronts, (1, 16), front, timer=host_ms)
    enc.frontend = DEFAULT_FRONTEND
    for what, ab, Bs in (("front end alone, device ms (graph replay)", ab_front, (1, 16, 128)),
                         ("front end alone, host ms to enqueue it", ab_front_host, (1, 16)),
                         ("warm predict_intents, device ms", ab_front_dec, (1, 16)),
                         ("warm predict_intents, CUDA events", ab_front_wall, (1, 16))):
        for B in Bs:
            print(f"[ab-frontend] {what}, B={B:3d} 4 s, in turns P, C, C, P: composed "
                  f"{ab[B, 'composed'][0]:.4f}, fused (K8) {ab[B, 'fused'][0]:.4f}, {ab[B, 'fused'][1]:.4f}, "
                  f"composed {ab[B, 'composed'][1]:.4f} on {card}")
    print(f"[ab-frontend] faster at B=1 and 16 in this run: front end alone "
          f"{faster(ab_front, fronts, (1, 16)) or 'neither at both'}, warm decode (device) "
          f"{faster(ab_front_dec, fronts, (1, 16)) or 'neither at both'}; default in models/encoder.py: "
          f"{DEFAULT_FRONTEND}")

    # 11.4 K6 against its plain version and K1 at the five flagship layer shapes, B = 1
    # and 16, pool 1 and 2, avg and max; the A/B against K1 (P) in turns P, C, C, P
    layouts = ("split", "rowstack")
    k6_err = 0.0
    ab_layer = {}  # (B, name, pool, method) -> {(1, layout): [ms, ms]}
    for B in (1, 16):
        for name, d, n_parts, T, _ in FLAGSHIP_LAYERS:
            params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
            for pool, method in ((1, "avg"), (2, "avg"), (2, "max")):
                before = bigru_shared.launches, bigru_shared.launches_rowstack
                got = bigru_shared(params, parts, pool=pool, pool_method=method, layout="rowstack")[:2]
                torch.cuda.synchronize()
                if (bigru_shared.launches, bigru_shared.launches_rowstack) != (before[0], before[1] + 1):
                    raise AssertionError(f"K6 {name} B={B}: not one K6 launch and no K1")
                ref = bigru_shared_rowstack_reference(params, parts, pool=pool, pool_method=method)
                k1 = bigru_shared(params, parts, pool=pool, pool_method=method)[:2]
                err = max((g - r).abs().max().item() for g, r in zip(got, ref))
                k1_diff = max((g - k).abs().max().item() for g, k in zip(got, k1))
                k6_err = max(k6_err, err)
                if not all(torch.allclose(g, r, atol=ATOL, rtol=RTOL) for g, r in zip(got, ref)):
                    raise AssertionError(f"K6 {name} B={B} pool={pool}/{method}: off its plain version by {err:.3g}")
                if not k1_diff <= ATOL:
                    raise AssertionError(f"K6 {name} B={B} pool={pool}/{method}: off K1 by {k1_diff:.3g}")

                def layer(lay, _, pool=pool, method=method, params=params, parts=parts):
                    return lambda: bigru_shared(params, parts, pool=pool, pool_method=method, layout=lay)
                t = ab_layer[B, name, pool, method] = ab_turns(layouts, (1,), layer,
                                                               timer=lambda fn: cuda_ms(fn, reps=10, warmup=3))
                print(f"[k6] {name:11s} B={B:2d} D={n_parts * d:3d} T={T:3d} pool={pool}/{method}, clusters of "
                      f"{bigru_cluster_size(B)}: max abs err "
                      f"{err:.3g} vs plain, {k1_diff:.3g} vs K1; [ab-layout] ms in turns P, C, C, P: K1 "
                      f"{t[1, 'split'][0]:.4f}, K6 {t[1, 'rowstack'][0]:.4f}, {t[1, 'rowstack'][1]:.4f}, K1 "
                      f"{t[1, 'split'][1]:.4f}")
    # the five layers at their decode pools (avg), summed turn by turn
    ab_five = {(B, lay): [sum(ab_layer[B, name, pool, "avg"][1, lay][i] for name, _, _, _, pool in FLAGSHIP_LAYERS)
                          for i in range(2)] for B in (1, 16) for lay in layouts}
    ab_layout_dec = ab_turns(layouts, (1, 16), decode("gru_layout"), timer=device_ms)
    ab_layout_wall = ab_turns(layouts, (1, 16), decode("gru_layout"))
    enc.gru_layout = DEFAULT_GRU_LAYOUT
    for what, ab in (("five layers at their decode pools, CUDA events", ab_five),
                     ("warm predict_intents, device ms", ab_layout_dec),
                     ("warm predict_intents, CUDA events", ab_layout_wall)):
        for B in (1, 16):
            print(f"[ab-layout] {what}, B={B:2d} 4 s, in turns P, C, C, P: K1 {ab[B, 'split'][0]:.4f}, "
                  f"K6 {ab[B, 'rowstack'][0]:.4f}, {ab[B, 'rowstack'][1]:.4f}, K1 {ab[B, 'split'][1]:.4f} on {card}")
    print(f"[ab-layout] faster at B=1 and 16 in this run: five layers "
          f"{faster(ab_five, layouts, (1, 16)) or 'neither at both'}, warm decode (device) "
          f"{faster(ab_layout_dec, layouts, (1, 16)) or 'neither at both'}; default in models/encoder.py: "
          f"{DEFAULT_GRU_LAYOUT}")

    # K6's time at B = 16 over the five layers: the kernel, its plain version, cuDNN
    # nn.GRU unpooled (K1's yardstick) and the bound (K1's)
    k6_tot = [0.0, 0.0, 0.0]  # kernel, plain, cuDNN
    k6_work = [0.0, 0.0]
    for name, d, n_parts, T, pool in FLAGSHIP_LAYERS:
        params, parts = k1_case(rng, n_parts, d, T, 16, 128, dev)
        kern, plain_ms = in_turns(lambda: bigru_shared_rowstack_reference(params, parts, pool=pool),
                                  lambda: bigru_shared(params, parts, pool=pool, layout="rowstack"))
        D = n_parts * d
        lib = cudnn_gru_ms(D, T, 16, 128, dev)
        w = gru_fwd_work(T * 16, D, 128, T * 16 * D, 2 * -(-T // pool) * 16 * 128)
        k6_tot = [k6_tot[0] + kern, k6_tot[1] + plain_ms, k6_tot[2] + lib]
        k6_work = [k6_work[0] + w[0], k6_work[1] + w[1]]
        print(f"[time] K6 {name:11s} B=16 D={D:3d} T={T:3d} pool={pool}: kernel {kern:.4f} ms, plain "
              f"{plain_ms:.3f} ms, cuDNN nn.GRU {lib:.4f} ms, bound {bound(*w)[0]:.4f} ms")
    k6_bound = bound(*k6_work)
    print(f"[time] K6 five flagship layers B=16: kernel {k6_tot[0]:.4f} ms, plain {k6_tot[1]:.3f} ms, cuDNN "
          f"nn.GRU {k6_tot[2]:.4f} ms, bound {k6_bound[0]:.4f} ms ({k6_bound[1]}), {k6_bound[0] / k6_tot[0]:.1%} "
          f"of it reached, on {card}")

    # 11.5 the main path of this phase: the flagship decode at B = 1 and 16 through K8
    # and K6, counts set to 0 just before and read just after; logits against the CPU
    cpu_model = flagship_model("cpu")
    for m in (cpu_model, model):
        m.pretrained_model.frontend, m.pretrained_model.gru_layout = "fused", "rowstack"
    x = (0.1 * np.random.default_rng(5).standard_normal((16, 4 * 16000))).astype(np.float32)
    sinc_frontend_fused.launches = bigru_shared.launches = bigru_shared.launches_rowstack = 0
    decoded = {B: model.decode_intents(x[:B]) for B in (1, 16)}
    torch.cuda.synchronize()
    main = {"K8": sinc_frontend_fused.launches, "K6": bigru_shared.launches_rowstack, "K1": bigru_shared.launches}
    if main != {"K8": 2, "K6": 10, "K1": 0}:
        raise AssertionError(f"flagship decode through K8 and K6 at B=1 and 16 launched {main}; want 1 K8 and 5 K6 "
                             "a call and no K1")
    for B in (1, 16):
        logits, preds = model.predict_intents(x[:B])
        ref, ref_preds = cpu_model.predict_intents(x[:B])
        err = (logits.cpu() - ref).abs().max().item()
        if not (logits.shape == (B, 24) and torch.isfinite(logits).all() and err <= LOGIT_ATOL):
            raise AssertionError(f"flagship B={B} through K8 and K6: card vs CPU logits max abs err {err:.3g} > "
                                 f"{LOGIT_ATOL}")
        print(f"[routes] flagship decode_intents B={B:2d} through K8 and K6 -> {decoded[B][0]}; logits card vs CPU "
              f"max abs err {err:.3g} (atol {LOGIT_ATOL}); predictions equal: {bool((preds.cpu() == ref_preds).all())}")
    print(f"[routes] launches of the two decodes: {main}")
    return [
        {"name": "sinc_frontend_fused", "route": "cuda", "source": K8_SOURCE, "replaces": K8_REPLACES,
         "launches": k8_main, "launches_routes": main["K8"], "max_abs_err": k8_err, "ms": k8_ms[16]["ms"],
         "plain_ms": k8_ms[16]["plain"], "bound_ms": k8_ms[16]["bound"], "bound_by": k8_ms[16]["by"],
         "library_ms": k8_ms[16]["lib"],
         **{f"{k}_b{B}": k8_ms[B][v] for B in (1, 128) for k, v in (("ms", "ms"), ("plain_ms", "plain"),
                                                                    ("library_ms", "lib"))},
         # amortized: 10 calls a graph replay; and the kernel's own time by torch.profiler
         **{f"{k}_b{B}": k8_ms[B][v] for B in (1, 16, 128) for k, v in (("ms_10_calls", "ms10"),
                                                                        ("library_ms_10_calls", "lib10"),
                                                                        ("ms_profiler", "prof"))},
         "ab_frontend_device": {f"{r} B={B}": v for (B, r), v in ab_front.items()},
         "ab_frontend_decode_device": {f"{r} B={B}": v for (B, r), v in ab_front_dec.items()},
         "ab_frontend_decode_wall": {f"{r} B={B}": v for (B, r), v in ab_front_wall.items()},
         "ab_frontend_host": {f"{r} B={B}": v for (B, r), v in ab_front_host.items()},
         "default": DEFAULT_FRONTEND},
        {"name": "bigru_shared_fwd_rs", "route": "cuda", "source": K6_SOURCE, "replaces": K6_REPLACES,
         "launches": main["K6"], "max_abs_err": k6_err, "ms": k6_tot[0], "plain_ms": k6_tot[1],
         "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "library_ms": k6_tot[2],
         "ab_layout_five_layers": {f"{r} B={B}": v for (B, r), v in ab_five.items()},
         "ab_layout_decode_device": {f"{r} B={B}": v for (B, r), v in ab_layout_dec.items()},
         "default": DEFAULT_GRU_LAYOUT},
    ]


# the ASR step of experiments/no_unfreezing.cfg: pretraining_type 2 (phoneme + word), 42 phonemes, 10,000
# words, crops of pretraining_length_mean = 2.25 s
ASR_T = 36000
ASR_PHONES = ["AA", "IY", "K", "T", "S", "N", "sil"]
ASR_WORDS = ["turn", "on", "the", "lights", "music", "kitchen", ""]
FSC_SLOTS = {"action": ["activate", "deactivate", "increase"], "object": ["lights", "music", "heat"],
             "location": ["kitchen", "bedroom", "none"]}
# the CLI leg's cuts of the flagship cfg: one epoch of each, batches of 8, and the tree of write_cli_tree
CLI_CUTS = {"pretraining_num_epochs": 1, "training_num_epochs": 1, "pretraining_batch_size": 8,
            "training_batch_size": 8}


def asr_shapes(T: int = ASR_T) -> list[tuple[str, int, int, int]]:
    """The four encoder bi-GRU layers of an ASR batch of ``T`` samples, as
    ``ENC_SHAPES`` gives them at 4 s: the sinc conv (401 taps, stride 80,
    padding 200) and its ceil max pool 2, then a ceil avg pool 2 after each
    layer (the length-keeping convs between change no T)."""
    t = -(-((T + 2 * 200 - 401) // 80 + 1) // 2)
    out = []
    for name, d, n_parts, _ in ENC_SHAPES:
        out.append((name, d, n_parts, t))
        t = -(-t // 2)
    return out


def hold_gru_layer(rng, dev, name: str, d: int, n_parts: int, T: int, B: int) -> dict:
    """K1, K2 and K3 at one bi-GRU layer's shape against their plain
    versions, with phases 3 and 6's limits, as the train and test passes
    run them: an encoder layer K1 with its avg pool 2, K2 at dropout 0.5
    and pool 2 (its zero pattern equal) and K3 fused on K2's outputs; the
    intent layer (``INTENT_SHAPE``, no pool) K1 and K3 plain on K1's
    outputs. Returns each kernel's largest abs error, and K3's largest
    error over its tensor's largest element as ``"K3 rel"``."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops.bigru_shared import (
        _shift_hp,
        bigru_shared,
        bigru_shared_bwd,
        bigru_shared_bwd_reference,
        bigru_shared_reference,
        bigru_trainpool,
        bigru_trainpool_reference,
    )

    def close(got, ref):
        return all(g.shape == r.shape and torch.allclose(g, r, atol=ATOL, rtol=RTOL) for g, r in zip(got, ref))

    intent = name == INTENT_SHAPE[0]
    params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
    got = bigru_shared(params, parts, pool=1 if intent else 2)[:2]
    ref = bigru_shared_reference(params, parts, pool=1 if intent else 2)
    err = {"K1": max((g - r).abs().max().item() for g, r in zip(got, ref)), "K2": 0.0}
    if not close(got, ref):
        raise AssertionError(f"K1 {name} T={T} B={B}: off its plain version by {err['K1']:.3g}")
    if intent:
        hp_f, hp_b = _shift_hp(*got)
        out, kw = got[0], {}
    else:
        kw = {"pool": 2, "drop_p": 0.5, "seed": int(rng.integers(2**32))}
        got = bigru_trainpool(params, parts, **kw)
        ref = bigru_trainpool_reference(params, parts, **kw)
        err["K2"] = max((g - r).abs().max().item() for g, r in zip(got, ref))
        if not (close(got, ref) and all(same_zeros(g, r) for g, r in zip(got[2:], ref[2:]))):
            raise AssertionError(f"K2 {name} T={T} B={B}: off its plain version ({err['K2']:.3g}) or its "
                                 "zero pattern")
        hp_f, hp_b, out = got[0], got[1], got[2]
    dy = [torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32)).to(dev) for _ in range(2)]
    dxs, grads = bigru_shared_bwd(params, parts, hp_f, hp_b, *dy, **kw)
    rdxs, rgrads = bigru_shared_bwd_reference(params, parts, hp_f, hp_b, *dy, **kw)
    pairs = list(zip(dxs, rdxs)) + [(grads[dd][n], rgrads[dd][n]) for dd in grads for n in grads[dd]]
    err["K3"] = max((g - r).abs().max().item() for g, r in pairs)
    err["K3 rel"] = max(rel_err(g, r) for g, r in pairs)
    if not (all(g.shape == r.shape for g, r in pairs) and err["K3 rel"] <= GRAD_TOL):
        raise AssertionError(f"K3 {name} T={T} B={B}: off its plain version by {err['K3 rel']:.3g} of the largest")
    return err


def asr_batches(rng, n: int, B: int, T: int, num_phonemes: int, vocabulary_size: int, phone_ds: int,
                word_ds: int) -> list[dict]:
    """Seeded waveforms and frame labels in the loader's ASR batch format:
    ``y_phoneme``/``y_word`` of ``ceil(T / ds)`` frames, about a fifth of
    them -1 (ignored); the last two rows of each batch are batch padding
    (zero waves, length 0, weight 0, every label -1)."""
    import numpy as np

    tp, tw = -(-T // phone_ds), -(-T // word_ds)
    out = []
    for _ in range(n):
        x = (0.1 * rng.standard_normal((B, T))).astype(np.float32)
        yp = rng.integers(0, num_phonemes, (B, tp)).astype(np.int32)
        yw = rng.integers(0, vocabulary_size, (B, tw)).astype(np.int32)
        yp[rng.random((B, tp)) < 0.2] = -1
        yw[rng.random((B, tw)) < 0.2] = -1
        w = np.ones(B, np.float32)
        lengths = np.full(B, T, np.int32)
        pad = slice(B - 2, B)
        x[pad], yp[pad], yw[pad], w[pad], lengths[pad] = 0.0, -1, -1, 0.0, 0
        out.append({"x": x, "y_phoneme": yp, "y_word": yw, "w": w, "len": lengths})
    return out


def write_cli_tree(root: str, rng) -> tuple[str, str]:
    """A tiny FSC-style SLU tree (12 train, 4 valid and 4 test rows of 1-2 s,
    an empty synthetic split; the train rows hold every slot value, as the
    slot vocabulary is the train split's) and LibriSpeech-style ASR tree (4 aligned
    utterances of 1.5-3 s a split, phones with stress digits and silence, and
    unaligned words), written with the port's own ``write_wav`` and
    ``write_textgrid``; returns (slu_path, asr_path)."""
    import numpy as np

    from tpu_slu_torch.data.audio import write_wav
    from tpu_slu_torch.data.textgrid import write_textgrid

    fs = 16000
    slu, asr = os.path.join(root, "fsc"), os.path.join(root, "librispeech")
    os.makedirs(os.path.join(slu, "data"))
    os.makedirs(os.path.join(slu, "wavs"))
    cols = ["path", "speakerId", "transcription", *FSC_SLOTS]
    for split, n in (("train", 12), ("valid", 4), ("test", 4)):
        lines = [",".join(cols)]
        for i in range(n):
            slots = [vals[i] if split == "train" and i < len(vals) else vals[int(rng.integers(len(vals)))]
                     for vals in FSC_SLOTS.values()]
            rel = f"wavs/{split}_{i}.wav"
            wave = 0.1 * rng.standard_normal(int(fs * rng.uniform(1.0, 2.0)))
            write_wav(os.path.join(slu, rel), wave, fs)
            lines.append(",".join([rel, f"spk{i % 3}", " ".join(slots), *slots]))
        with open(os.path.join(slu, "data", f"{split}_data.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(slu, "data", "synthetic_data.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
    for split in ("train-clean-100", "dev-clean", "test-clean"):
        for kind in ("text", "audio"):
            os.makedirs(os.path.join(asr, kind, split, "1", "2"))
        for i in range(4):
            dur = float(rng.uniform(1.5, 3.0))
            bounds = np.linspace(0.0, dur, 7)
            phones, words = [], []
            for a, b in zip(bounds[:-1], bounds[1:]):
                p = ASR_PHONES[int(rng.integers(len(ASR_PHONES)))]
                phones.append((float(a), float(b), p if p == "sil" else p + str(int(rng.integers(3)))))
                words.append((float(a), float(b), ASR_WORDS[int(rng.integers(len(ASR_WORDS)))]))
            stem = os.path.join(split, "1", "2", f"utt{i}")
            write_textgrid(os.path.join(asr, "text", stem + ".TextGrid"), {"words": words, "phones": phones}, dur)
            write_wav(os.path.join(asr, "audio", stem + ".wav"), 0.1 * rng.standard_normal(int(fs * dur)), fs)
    return slu, asr


def write_cli_cfg(path: str, template: str, **values) -> None:
    """``template`` (a cfg file) with the ``key=value`` lines of ``values``
    replaced; raises on a key the template does not set."""
    with open(template) as f:
        lines = f.read().splitlines()
    for key, value in values.items():
        hits = [i for i, line in enumerate(lines) if line.split("=")[0].strip() == key]
        if len(hits) != 1:
            raise KeyError(f"{template} sets {key!r} {len(hits)} times")
        lines[hits[0]] = f"{key}={value}"
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def asr_step_vs_cpu(dev, config, batch: dict) -> None:
    """One ASR train step (dropout on) of seeded random weights on ``batch``,
    card against the CPU plain path, with phase 6's holds: the loss within
    ``STEP_LOSS_ATOL``, every gradient within ``GRAD_TOL`` of its largest
    element, the front end's (``front_end_params``) against an f64 step on
    the card's front-end branches."""
    import torch

    from tpu_slu_torch.models.encoder import PretrainedModel, encoder_loss

    cpu_model = PretrainedModel(config, generator=torch.Generator().manual_seed(3)).train()
    card_model = copy.deepcopy(cpu_model).to(dev)
    B = len(batch["w"])

    def step(model, where, dtype=torch.float32):
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        pl, wl, pa, wa = encoder_loss(model, b["x"].to(dtype), b["y_phoneme"].long(), b["y_word"].long(),
                                      train=True, generator=torch.Generator().manual_seed(5),
                                      weights=b["w"].to(dtype))
        (pl + wl).backward()
        return (pl + wl).item(), {n: p.grad for n, p in model.named_parameters()}

    l_cpu, g_cpu = step(cpu_model, torch.device("cpu"))
    branches = FrontEndBranches()
    with branches.record():
        l_card, g_card = step(card_model, dev)
    m64 = copy.deepcopy(cpu_model).double()
    g64_own = step(m64, torch.device("cpu"), torch.float64)[1]
    with branches.replay():
        g64 = {n: g for n, g in step(m64, torch.device("cpu"), torch.float64)[1].items()
               if n in front_end_params(cpu_model)}
    if not abs(l_card - l_cpu) <= STEP_LOSS_ATOL:
        raise AssertionError(f"ASR step B={B}: loss card {l_card} vs CPU {l_cpu}")
    worst = 0.0
    for n, g in g_cpu.items():
        e = rel_err(g_card[n].cpu().double(), g64[n]) if n in g64 else rel_err(g_card[n].cpu(), g)
        worst = max(worst, e)
        if not e <= GRAD_TOL:
            raise AssertionError(f"ASR step B={B}: gradient of {n} off the {'f64' if n in g64 else 'CPU'} "
                                 f"reference's by {e:.3g} of its largest")
    for n, r in g64.items():
        print(f"[asr] B={B} {n} gradient vs f64 on the card's branches, of its largest element: card "
              f"{rel_err(g_card[n].cpu().double(), r):.3g}; CPU f32 vs f64 on its own "
              f"{rel_err(g_cpu[n].double(), g64_own[n]):.3g}")
    print(f"[asr] train step B={B}, 2.25 s, 10k words, card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} (atol "
          f"{STEP_LOSS_ATOL}); every gradient within {worst:.3g} of its largest element (limit {GRAD_TOL}; the "
          f"front end's against the f64 step on the card's branches, {branches.flips} branches parted)")


def asr_eval_vs_cpu(model, batch: dict) -> str:
    """The test pass's four values (``encoder_loss`` in eval mode) and the
    posteriors of ``model`` (on the card, eval mode) on ``batch``, against a
    CPU copy's plain path: the logits within ``LOGIT_ATOL``, the losses
    within ``STEP_LOSS_ATOL``, each accuracy within the share of its valid
    frames whose argmax the two sides part on. Returns what it held."""
    import torch

    from tpu_slu_torch.models.encoder import encoder_loss

    def run(enc):
        b = {k: torch.from_numpy(v).to(enc.device) for k, v in batch.items()}
        with torch.no_grad():
            values = encoder_loss(enc, b["x"], b["y_phoneme"].long(), b["y_word"].long(), weights=b["w"])
            return [v.item() for v in values], [p.cpu() for p in enc.compute_posteriors(b["x"])]

    (card, card_post), (cpu, cpu_post) = run(model.eval()), run(copy.deepcopy(model).cpu().eval())
    w = torch.from_numpy(batch["w"])
    notes = []
    for i, (what, y) in enumerate((("phoneme", batch["y_phoneme"]), ("word", batch["y_word"]))):
        g, r = card_post[i], cpu_post[i]
        err = (g - r).abs().max().item()
        if g.shape != r.shape or not err <= LOGIT_ATOL:
            raise AssertionError(f"ASR test pass: {what} logits {tuple(g.shape)} card vs CPU max abs err {err:.3g} "
                                 f"> {LOGIT_ATOL}")
        t = min(g.shape[1], y.shape[1])
        valid = (torch.from_numpy(y[:, :t]) != -1) & (w[:, None] > 0)
        flips = int(((g[:, :t].argmax(-1) != r[:, :t].argmax(-1)) & valid).sum())
        loss_err, acc_err = abs(card[i] - cpu[i]), abs(card[2 + i] - cpu[2 + i])
        if not (loss_err <= STEP_LOSS_ATOL and acc_err <= flips / max(int(valid.sum()), 1) + 1e-6):
            raise AssertionError(f"ASR test pass: {what} loss, acc card {card[i]}, {card[2 + i]} vs CPU {cpu[i]}, "
                                 f"{cpu[2 + i]} ({flips} argmax flips)")
        notes.append(f"{what} logits {tuple(g.shape)} max abs err {err:.3g} (atol {LOGIT_ATOL}), loss "
                     f"{card[i]:.6f} vs {cpu[i]:.6f} (atol {STEP_LOSS_ATOL}), acc {card[2 + i]:.6f} vs "
                     f"{cpu[2 + i]:.6f} ({flips} argmax flips)")
    return "; ".join(notes)


def phase_asr(dev, card: str, rng) -> dict:
    """Phase 12: ASR pre-training at the width of ``no_unfreezing.cfg``
    (``pretraining_type`` 2, 42 phonemes, 10,000 words), then the path on
    to a served model. Returns, by kernel name, the launches of the ASR
    Trainer's train and test passes (12.3), its main path, and the largest
    errors of K1, K2 and K3 at its shapes (12.1)."""
    import ast

    import numpy as np
    import torch

    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG, FLAGSHIP_VOCAB
    from tpu_slu_torch.models.slu import Model
    from tpu_slu_torch.ops.bigru_masked import bigru_masked
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused
    from tpu_slu_torch.serving import load_trained_model
    from tpu_slu_torch.training import Trainer

    def asr_config(folder):
        config = read_config(FLAGSHIP_CFG, make_dirs=False)
        config.folder, config.num_phonemes = folder, 42
        assert (config.pretraining_type, config.vocabulary_size) == (2, 10000)
        return config

    def batches(n, B):
        c = asr_config("")
        return asr_batches(rng, n, B, ASR_T, 42, c.vocabulary_size, c.phone_downsample_factor,
                           c.word_downsample_factor)

    # 12.1 the main path's GRU kernels at its own shapes (B = 64, the four encoder layers at 2.25 s)
    # against their plain versions, with phases 3 and 6's holds: K1 (the test pass, avg pool 2), K2
    # (dropout 0.5, pool 2) and K3 fused on K2's outputs; K8 at (64, 2.25 s) is held in phase 11.1
    B_main = asr_config("").pretraining_batch_size
    errs = dict.fromkeys(("K1", "K2", "K3"), 0.0)
    for name, d, n_parts, T in asr_shapes():
        e = hold_gru_layer(rng, dev, name, d, n_parts, T, B_main)
        errs = {k: max(v, e[k]) for k, v in errs.items()}
        print(f"[asr] {name:10s} T={T:3d} B={B_main} D={n_parts * d:3d}: K1 and K2 within atol {ATOL} rtol "
              f"{RTOL} (K2's zero pattern equal), K3's dX, dW, db within {e['K3 rel']:.3g} of each largest "
              f"(limit {GRAD_TOL})")
    print(f"[asr] the path's GRU kernels at its shapes: max abs err K1 {errs['K1']:.3g}, K2 {errs['K2']:.3g}, "
          f"K3 {errs['K3']:.3g}")

    # 12.2 one ASR train step on 2.25 s at B = 16 and at the main path's B = 64, card against the CPU
    for B_step in (16, B_main):
        asr_step_vs_cpu(dev, asr_config(""), batches(1, B_step)[0])

    # 12.3 the main path: Trainer(PretrainedModel).train over B = 64 batches, then Trainer.test
    tmp = tempfile.mkdtemp(prefix="chip_smoke_asr_")
    try:
        config = asr_config(tmp)
        model = PretrainedModel(config, generator=torch.Generator().manual_seed(1)).to(dev)
        trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
        data = Batches(batches(3, config.pretraining_batch_size))
        counters = {"K1": bigru_shared, "K2": bigru_trainpool, "K3": bigru_shared_bwd, "K4f": bigru_masked,
                    "K8": sinc_frontend_fused}
        for c in counters.values():
            c.launches = 0
        result = trainer.train(data)
        torch.cuda.synchronize()
        train_launches = {k: c.launches for k, c in counters.items()}
        steps = len(data.loader)
        if train_launches != {"K1": 0, "K2": 4 * steps, "K3": 4 * steps, "K4f": 0, "K8": 0}:
            raise AssertionError(f"ASR Trainer.train over {steps} steps launched {train_launches}; want 4 K2 "
                                 "and 4 K3 a step and nothing else")
        if not all(np.isfinite(result)):
            raise AssertionError(f"ASR Trainer.train: {result}")
        with open(os.path.join(tmp, "pretraining", "log.csv")) as f:
            header = f.readline().strip()
        if not header.startswith(",phone_loss,phone_acc,word_loss,word_acc,set,examples_per_sec,steps"):
            raise AssertionError(f"ASR log.csv header {header!r}")
        for c in counters.values():
            c.launches = 0
        tested = trainer.test(data)
        torch.cuda.synchronize()
        test_launches = {k: c.launches for k, c in counters.items()}
        if test_launches != {"K1": 4 * steps, "K2": 0, "K3": 0, "K4f": 0, "K8": steps}:
            raise AssertionError(f"ASR Trainer.test over {steps} batches launched {test_launches}; want 1 K8 "
                                 "and 4 K1 a batch and nothing else")
        if not all(np.isfinite(tested)):
            raise AssertionError(f"ASR Trainer.test: {tested}")
        held = asr_eval_vs_cpu(model, data.loader[0])
        print(f"[asr-trainer] Trainer(PretrainedModel).train at no_unfreezing.cfg width, B={len(data.loader[0]['w'])}"
              f", 2.25 s, {steps} steps with -1 labels and 2 weight-0 rows a batch: (phone_acc, phone_loss, "
              f"word_acc, word_loss) {tuple(round(v, 4) for v in result)}; launches {train_launches}; "
              f"Trainer.test {tuple(round(v, 4) for v in tested)}, launches {test_launches}; log.csv {header}")
        print(f"[asr-test] the test pass on its first batch (B={len(data.loader[0]['w'])}, 2.25 s: K8 and 4 K1 on "
              f"the card) against the CPU plain path on the same weights: {held}")

        # 12.4 save, an SLU Model on the saved encoder, one SLU epoch, save, serve
        trainer.save_checkpoint()
        slu_config = asr_config(tmp)
        Model.attach_vocab(slu_config, FLAGSHIP_VOCAB)
        slu = Model(slu_config, seed=2).to(dev)
        trained, loaded = model.state_dict(), slu.pretrained_model.state_dict()
        if list(trained) != list(loaded) or not all(torch.equal(trained[k], loaded[k]) for k in trained):
            raise AssertionError("Model(config) did not load pretraining/model_state.npz bit for bit")
        slu_trainer = Trainer(slu, slu_config, generator=torch.Generator().manual_seed(8))
        slu_data = Batches(synthetic_batches(rng, 2, 16, slu.values_per_slot))
        acc, loss = slu_trainer.train(slu_data)
        slu_trainer.save_checkpoint()
        served = load_trained_model(asr_config(tmp), device=dev)
        x16 = slu_data.loader[0]["x"]
        want, got = slu.decode_intents(x16), served.decode_intents(x16)
        if got != want:
            raise AssertionError(f"load_trained_model decodes {got[:2]}... where the trained model decodes "
                                 f"{want[:2]}...")
        print(f"[asr-serve] Model(config) loaded pretraining/model_state.npz bit-equal to the trained encoder; "
              f"one SLU epoch (loss {loss:.4f}), save_checkpoint, load_trained_model: decode_intents at B=16 "
              f"equal to the in-memory model's ({want[0]}, ...)")

        # 12.6 the warm ASR step at B = 64 and its profile
        batch = trainer._to_device(data.loader[0])
        times = sorted(cuda_times(lambda: trainer.train_step(batch), reps=10, warmup=2))
        print(f"[time] warm ASR train step B=64, 2.25 s, 10k words (forward, backward, Adam): median "
              f"{statistics.median(times):.3f} ms of 10 (CUDA events; min {times[0]:.3f}, max {times[-1]:.3f}) "
              f"on {card}")
        profile_calls(lambda: trainer.train_step(batch), "ASR train step B=64, 2.25 s", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 12.5 the CLI end to end on the card, in subprocesses
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        slu_path, asr_path = write_cli_tree(tmp, rng)
        folder, cfg = os.path.join(tmp, "exp"), os.path.join(tmp, "exp.cfg")
        write_cli_cfg(cfg, FLAGSHIP_CFG, folder=folder, asr_path=asr_path, slu_path=slu_path, **CLI_CUTS)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

        def cli(*args):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "tpu_slu_torch.cli", *args, "--config_path", cfg],
                                 cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                raise AssertionError(f"cli {' '.join(args)} exited {out.returncode}: {out.stderr[-2000:]}")
            return out.stdout, time.perf_counter() - t0

        took = {}
        for leg in (("--pretrain",), ("--train",), ("--train", "--restart")):
            out, took[" ".join(leg)] = cli(*leg)
            if "Could not" in out or (leg[-1] == "--restart" and "No previous model" in out):
                raise AssertionError(f"cli {' '.join(leg)}: {out[-1500:]}")
        wav = os.path.join(slu_path, "wavs", "test_0.wav")
        out, took["--decode"] = cli("--decode", "--wav", wav)
        decoded = ast.literal_eval(out.strip().splitlines()[-1])
        with open(os.path.join(folder, "training", "vocab.json")) as f:
            vocab = json.load(f)
        if len(decoded) != 3 or not all(v in vocab["Sy_intent"][s] for s, v in zip(vocab["Sy_intent"], decoded)):
            raise AssertionError(f"cli --decode printed {decoded}")
        files = {sub: sorted(os.listdir(os.path.join(folder, sub))) for sub in ("pretraining", "training")}
        want_files = {"pretraining": ["log.csv", "model_state.npz", "phonemes.txt", "trainer_state.npz",
                                      "words.txt"],
                      "training": ["log.csv", "model_state.npz", "trainer_state.npz", "vocab.json"]}
        if files != want_files:
            raise AssertionError(f"cli wrote {files}, want {want_files}")
        with np.load(os.path.join(folder, "training", "trainer_state.npz")) as f:
            epoch = int(f["epoch"])
        rows = {}
        for sub in files:
            with open(os.path.join(folder, sub, "log.csv")) as f:
                rows[sub] = len(f.read().splitlines()) - 1
        if epoch != 2 or rows != {"pretraining": 2, "training": 3}:
            raise AssertionError(f"after --train --restart: epoch {epoch} (want 2), log.csv rows {rows}")
        print(f"[asr-cli] python -m tpu_slu_torch.cli on the card, no_unfreezing.cfg cut to "
              f"{CLI_CUTS} on a tree of 12/4/4 FSC-style rows and 4 aligned utterances a split: --pretrain, "
              f"--train, --train --restart (epoch read back, 2 saved), --decode -> {decoded}; wrote {files}; "
              f"log.csv rows {rows}; seconds a leg {({k: round(v, 1) for k, v in took.items()})}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"bigru_shared_fwd": {"launches_asr_test": test_launches["K1"], "max_abs_err_asr": errs["K1"]},
            "bigru_trainpool_fwd": {"launches_asr_train": train_launches["K2"], "max_abs_err_asr": errs["K2"]},
            "bigru_shared_bwd": {"launches_asr_train": train_launches["K3"], "max_abs_err_asr": errs["K3"]},
            "sinc_frontend_fused": {"launches_asr_test": test_launches["K8"]}}


# -- phase 13: data-parallel training and evaluation, and the first-epoch trace ----------

# dropout off where a data-parallel step is held against the one-process step: a rank's
# rows get other masks than the same rows of one batch (the hash takes the local row)
DP_NO_DROPOUT = {"phone_rnn_drop": [0.0, 0.0], "word_rnn_drop": [0.0, 0.0], "intent_rnn_drop": [0.0]}
DP_B = 64  # the global batch of [dp-world1] and [dp-2rank]; each of the two ranks takes 32 rows
DP_TEST_N, DP_TEST_B = 32, 8  # [dp-test]: utterances, and the batch of a rank and of the one-process test


def step_kernel(name: str) -> str | None:
    """The hand-written kernel of the fixed-slot train step that a traced
    kernel ``name`` is, by the one launch each wrapper call makes: K2's and
    K1's recurrence (``gru_cluster_kernel`` with and without its TRAIN flag,
    the fourth template argument), K3's chain (``gru_cluster_bwd_kernel``
    with its SPLIT flag, the fourth); else None."""
    if "gru_cluster_bwd_kernel<" in name:
        args = name.split("gru_cluster_bwd_kernel<", 1)[1].split(">", 1)[0].split(",")
        return "K3" if len(args) > 3 and args[3].strip() in ("true", "1", "(bool)1") else None
    if "gru_cluster_kernel<" in name:
        train = name.split("gru_cluster_kernel<", 1)[1].split(">", 1)[0].split(",")[3].strip()
        return "K2" if train in ("true", "1") else "K1"
    return None


def dp_test_data(rng, labels: list, n: int = DP_TEST_N):
    """``n`` seeded utterances of 1.0-4.0 s and label strings of 14
    characters, as (wave, label ids) items. Every label has one length: the
    seq2seq loss pads a batch's targets to its longest, so a rank's batch
    would otherwise differ from the same rows in a larger batch."""
    import numpy as np

    sos, eos = labels.index("<sos>"), labels.index("<eos>")
    chars = [i for i, c in enumerate(labels) if len(c) == 1 and c.isprintable()]
    return [((0.1 * rng.standard_normal(int(rng.integers(16000, 64001)))).astype(np.float32),
             [sos] + [chars[int(i)] for i in rng.integers(0, len(chars), 14)] + [eos]) for _ in range(n)]


def dp_test_set(items, labels: list, B: int):
    """``items`` as a seq2seq test set in the loader's format (``BatchLoader``,
    the shard of the process group when one is up), every batch padded to
    4 s: the loss runs the encoder unmasked, so a rank's batch padded to a
    shorter bucket than another's would change its rows."""
    import numpy as np

    from tpu_slu_torch.data.datasets import CollateWavsSLU
    from tpu_slu_torch.data.loader import BatchLoader

    collate = CollateWavsSLU(labels, True, B)

    def one_bucket(chunk):
        b = collate(chunk)
        return {**b, "x": np.pad(b["x"], ((0, 0), (0, 4 * 16000 - b["x"].shape[1])))}

    return Batches(BatchLoader(list(enumerate(items)), B, lambda c: {**one_bucket([it for _, it in c]),
                                                                       "i": np.array([i for i, _ in c])},
                               shuffle=False))


def dp_models(dev, seed: int) -> dict:
    """The three models of phase 13's rank runs, each with its config, on
    ``dev``: the fixed-slot and ASR models of ``no_unfreezing.cfg`` at
    dropout 0 and the seq2seq model of ``all_real_seq2seq.cfg``, from ``seed``."""
    import torch

    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG, flagship_model, flagship_seq2seq_model

    fixed = flagship_model(dev, seed=seed, **DP_NO_DROPOUT)
    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    config.num_phonemes = 42
    for k, v in DP_NO_DROPOUT.items():
        setattr(config, k, v)
    asr = PretrainedModel(config, generator=torch.Generator().manual_seed(seed)).to(dev)
    s2s = flagship_seq2seq_model(dev, seed=seed)
    return {"fixed": (fixed, fixed.config), "asr": (asr, config), "s2s": (s2s, s2s.config)}


def dp_step(trainer, batch: dict, dev) -> dict:
    """One ``train_step`` on a host batch, with its counts summed over the
    ranks as ``Trainer.train`` gives them: its values, the gradients the
    optimizer took (summed over the ranks) and the parameters after it, on
    the host."""
    import torch

    from tpu_slu_torch import parallel

    totals = parallel.host_all_reduce(trainer.counts(batch)) if trainer.world > 1 else None
    out = trainer.train_step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, totals)
    return {"values": [float(v) for v in out],
            "grads": {n: None if p.grad is None else p.grad.detach().cpu()
                      for n, p in trainer.model.named_parameters()},
            "params": {n: p.detach().cpu().clone() for n, p in trainer.model.named_parameters()}}


def dp_test_run(trainer, items, labels: list, B: int) -> dict:
    """``Trainer.test`` of the seq2seq model over ``items`` (this process's
    shard), with the strings each batch decoded, by item index, and the
    launches of K1, K8, K4f and K7 it made."""
    import torch

    from tpu_slu_torch.ops.beam_fused import beam_decode
    from tpu_slu_torch.ops.bigru_masked import bigru_masked
    from tpu_slu_torch.ops.bigru_shared import bigru_shared
    from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused

    model = trainer.model
    data = dp_test_set(items, labels, B)
    decoded, decode = [], model.decode_intents

    def recording(*a, **kw):
        out = decode(*a, **kw)
        decoded.extend(out)
        return out

    counters = (bigru_shared, sinc_frontend_fused, bigru_masked, beam_decode)
    for c in counters:
        c.launches = 0
    model.decode_intents = recording
    graphs = graph_counts(model)
    try:
        acc, loss = trainer.test(data)
    finally:
        del model.decode_intents
    captured, replayed = (b - a for a, b in zip(graphs, graph_counts(model)))
    torch.cuda.synchronize()
    # a batch decodes all its rows; its real rows come first
    strings, k = {}, 0
    for b in data.loader:
        n = int(b["w"].sum())
        strings.update(zip(b["i"][:n].tolist(), decoded[k:k + n]))
        k += len(b["w"])
    return {"acc": acc, "loss": loss, "strings": strings,
            "launches": dict(zip(("K1", "K8", "K4f", "K7"), (c.launches for c in counters))),
            "batches": len(data.loader), "captured": captured, "replayed": replayed}


def start_ranks(flag: str, args_path: str, world: int, tmp: str) -> list:
    """``world`` ranks of this script (``python3 chip_smoke.py FLAG ARGS``) on
    the one card, rank r's output in ``<tmp>/rank<r>.log``."""
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": "0"}
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, args_path],
                                      cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait_ranks(procs: list, tmp: str, what: str, timeout: float = 300.0) -> list[dict]:
    """Each rank's ``<tmp>/rank<r>.pt`` once all have exited 0; raise, with
    the ends of their logs, if one failed or the time ran out (the others
    are killed)."""
    import torch

    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        logs = "".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:] for r in range(len(procs)))
        raise AssertionError(f"[{what}] a rank failed: {[p.returncode for p in procs]}\n{logs}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(len(procs))]
    if any(rk["modules"] for rk in ranks):
        raise AssertionError(f"[{what}] a rank loaded modules of JAX or of the JAX package: {ranks[0]['modules']}")
    return ranks


def dp_rank(args_path: str) -> None:
    """One rank of ``[dp-2rank]`` and ``[dp-test]`` (``python3 chip_smoke.py
    --dp-rank ARGS``, started by ``phase_dp``): gloo on the one card's CUDA
    tensors (NCCL refuses two ranks on one GPU). One step of the fixed-slot
    and the ASR Trainer on its 32 rows of the 64-row batches, then a
    data-parallel ``Trainer.test`` of the seq2seq model; the results go to
    ``<out>/rank<r>.pt``."""
    import datetime

    sys.path.insert(0, HERE)
    import torch

    from tpu_slu_torch import parallel
    from tpu_slu_torch.training import Trainer

    with open(args_path) as f:
        args = json.load(f)
    dev = parallel.init_from_env("cuda:0", backend="gloo", init_method="file://" + args["rdv"],
                                 timeout=datetime.timedelta(seconds=300))
    try:
        r = parallel.rank()
        inputs = torch.load(args["inputs"], weights_only=False)
        models = dp_models(dev, seed=10 + r)  # rank 0's weights are loaded, then broadcast by the Trainer
        for what, (model, config) in models.items():
            if r == 0:
                model.load_state_dict(inputs[what]["state"])
            config.folder, config.decode_acc_from_epoch = os.path.join(args["out"], f"{what}{r}"), 0
        out, half = {}, DP_B // parallel.world()
        for what in ("fixed", "asr"):
            model, config = models[what]
            trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
            out[what] = dp_step(trainer, {k: v[r * half:(r + 1) * half] for k, v in inputs[what]["batch"].items()},
                                dev)
        s2s, config = models["s2s"]
        out["s2s"] = dp_test_run(Trainer(s2s, config), inputs["s2s"]["items"], s2s.Sy_intent, DP_TEST_B)
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_slu"))
        torch.save(out, os.path.join(args["out"], f"rank{r}.pt"))
        parallel.barrier()
    finally:
        parallel.destroy()


def grads_close(got: dict, want: dict, lr: float) -> tuple[float, float, int]:
    """(the worst gradient error over its tensor's largest element, the
    worst parameter error where the first Adam step's sign is settled, the
    count of elements where it is not): an element whose one-process
    gradient lies within ``STEP_GRAD_TOL`` of its tensor's largest may take
    the other sign under f32 noise and move by up to 2 lr."""
    worst_g, worst_p, unsettled = 0.0, 0.0, 0
    for n, g in want["grads"].items():
        if g is None:
            assert got["grads"][n] is None, n
            continue
        worst_g = max(worst_g, rel_err(got["grads"][n], g))
        settled = g.abs() > STEP_GRAD_TOL * g.abs().max()
        unsettled += int((~settled).sum())
        d = (got["params"][n] - want["params"][n]).abs()
        worst_p = max(worst_p, d[settled].max().item() if settled.any() else 0.0)
        if not (d <= 2 * lr + STEP_PARAM_ATOL).all():
            raise AssertionError(f"{n}: a parameter moved by more than one Adam step from the one-process step's")
    return worst_g, worst_p, unsettled


def phase_dp(dev, card: str, rng) -> dict:
    """Phase 13: data-parallel training and evaluation, and the first-epoch
    trace. Returns, by kernel name, the launches of the data-parallel step
    and test."""
    import numpy as np
    import torch

    from tpu_slu_torch import parallel
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG, flagship_model
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.training import Trainer

    counters = {"K1": bigru_shared, "K2": bigru_trainpool, "K3": bigru_shared_bwd}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    deterministic = torch.backends.cudnn.deterministic
    try:
        # 13.0 [dp-kernels]: K1, K2 and K3 at the batches a rank gives them in this phase, against
        # their plain versions: B = 8 ([dp-test]) and 32 ([dp-2rank]), at the flagship's five layer
        # shapes on 4 s and the ASR encoder's four on 2.25 s; K8 at (8, 4 s) is held in phase 11.1
        errs = dict.fromkeys(("K1", "K2", "K3", "K3 rel"), 0.0)
        for shapes in (ENC_SHAPES + [INTENT_SHAPE], asr_shapes()):
            for B in (DP_TEST_B, DP_B // 2):
                for name, d, n_parts, T in shapes:
                    e = hold_gru_layer(rng, dev, name, d, n_parts, T, B)
                    errs = {k: max(v, e[k]) for k, v in errs.items()}
        print(f"[dp-kernels] K1, K2 and K3 at B={DP_TEST_B} and {DP_B // 2}, the flagship's five layers on 4 s "
              f"and the ASR encoder's four on 2.25 s: K1 and K2 within atol {ATOL} rtol {RTOL} (K2's zero "
              f"pattern equal), max abs err K1 {errs['K1']:.3g}, K2 {errs['K2']:.3g}; K3's dX, dW, db within "
              f"{errs['K3 rel']:.3g} of each largest (limit {GRAD_TOL}), max abs err {errs['K3']:.3g}")

        # 13.1 [dp-world1]: three steps of a Trainer made under an NCCL group of one rank against
        # the same three steps of a Trainer made before the group, bit for bit; cuDNN's deterministic
        # algorithms for all, and two one-process runs first, which must agree to the bit
        torch.backends.cudnn.deterministic = True
        base = flagship_model("cpu", seed=3)
        base.config.folder = tmp
        data = synthetic_batches(rng, 3, DP_B, base.values_per_slot)
        trainers = {}
        for side in ("plain", "again", "dp"):
            if side == "dp":
                os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(free_port()))
                if parallel.init_from_env(dev) != torch.device("cuda", 0):
                    raise AssertionError("init_from_env did not give rank 0 the card")
            trainer = Trainer(copy.deepcopy(base).to(dev), base.config, generator=torch.Generator().manual_seed(7))
            assert trainer.world == 1 and torch.distributed.is_initialized() == (side == "dp")
            for c in counters.values():
                c.launches = 0
            trainer.train(Batches(data))
            torch.cuda.synchronize()
            dp_launched = {k: c.launches for k, c in counters.items()}
            if dp_launched != {"K1": 3, "K2": 12, "K3": 15}:
                raise AssertionError(f"[dp-world1] {side}: three steps launched {dp_launched}; want 1 K1, 4 K2, "
                                     "5 K3 a step")
            trainers[side] = trainer
        backend = torch.distributed.get_backend()
        plain = trainers["plain"]
        for side in ("again", "dp"):
            other = trainers[side]
            for (n, p), q in zip(plain.model.named_parameters(), other.model.parameters()):
                if not torch.equal(p, q):
                    raise AssertionError(f"[dp-world1] {n}: the {side} run's parameters differ from the "
                                         "one-process run's")
            for k, v in plain.optimizer.export_flat().items():
                if not np.array_equal(v, other.optimizer.export_flat()[k]):
                    raise AssertionError(f"[dp-world1] the {side} run's Adam {k} differs")
        dp = trainers["dp"]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data[0].items()}
        turns = [cuda_ms(lambda t=t: t.train_step(batch), reps=10, warmup=2) for t in (plain, dp, dp, plain)]
        (wall_p, kern_p), (wall_c, kern_c) = (kernel_table(lambda t=t: t.train_step(batch)) for t in (plain, dp))
        busy_p, busy_c = (sum(ms for _, ms in k.values()) for k in (kern_p, kern_c))
        n_p, n_c = (sum(n for n, _ in k.values()) for k in (kern_p, kern_c))
        # launches a step are means over the traced steps: a kernel differs when they part by one or more
        added = {}
        for name in set(kern_c) | set(kern_p):
            (n1, ms1), (n0, ms0) = kern_c.get(name, (0, 0)), kern_p.get(name, (0, 0))
            if round(n1 - n0):
                added[name] = (n1 - n0, ms1 - ms0)
        print(f"[profile] the train step B={DP_B}, a group of one rank / no group (10 warm steps each): traced wall "
              f"{wall_c:.3f} / {wall_p:.3f} ms, device busy {busy_c:.4f} / {busy_p:.4f} ms, idle share "
              f"{1 - busy_c / wall_c:.3f} / {1 - busy_p / wall_p:.3f}, {n_c:.0f} / {n_p:.0f} kernel launches a step; "
              f"kernels whose launches a step differ by one or more (group side minus no group): "
              + ("; ".join(f"{n:+.0f} {k[:70]} ({ms:+.4f} ms)" for k, (n, ms) in added.items()) or "none")
              + f", on {card}")
        print(f"[dp-world1] {backend} world 1 (init_from_env), no_unfreezing.cfg fixed-slot model, B={DP_B} on "
              f"4 s: three Trainer steps under the group (one rank: no broadcast, no gradient all-reduce) equal "
              f"three steps of a Trainer made without one bit for bit, parameters and Adam state (cuDNN "
              f"deterministic for both); launches "
              f"{dp_launched} in 3 steps; warm step in turns P, C, C, P: "
              f"{', '.join(f'{t:.3f}' for t in turns)} ms (median of 10, CUDA events) on {card}; a second "
              f"one-process run equal to the first bit for bit too")
        parallel.destroy()
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k)
        torch.backends.cudnn.deterministic = deterministic

        # 13.2 the one-process references of [dp-2rank] and [dp-test], and the ranks' inputs
        models = dp_models("cpu", seed=1)
        (fixed, _), (asr, asr_cfg), (s2s, _) = models.values()
        # one weight-0 row among rank 1's rows; the ASR batch's last two rows are padding (rank 1's)
        fixed_batch = synthetic_batches(rng, 1, DP_B, fixed.values_per_slot)[0]
        fixed_batch["w"][DP_B - 5] = 0.0
        asr_batch = asr_batches(rng, 1, DP_B, ASR_T, 42, asr_cfg.vocabulary_size, asr_cfg.phone_downsample_factor,
                                asr_cfg.word_downsample_factor)[0]
        items = dp_test_data(rng, s2s.Sy_intent)
        inputs = {"fixed": {"state": fixed.state_dict(), "batch": fixed_batch},
                  "asr": {"state": asr.state_dict(), "batch": asr_batch},
                  "s2s": {"state": s2s.state_dict(), "items": items}}
        inputs_path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, inputs_path)
        args = {"out": tmp, "rdv": os.path.join(tmp, "rendezvous"), "inputs": inputs_path}
        args_path = os.path.join(tmp, "args.json")
        with open(args_path, "w") as f:
            json.dump(args, f)
        t0 = time.perf_counter()
        procs = start_ranks("--dp-rank", args_path, 2, tmp)
        single = {}
        for what, (model, config) in models.items():
            model.to(dev)
            config.folder, config.decode_acc_from_epoch = os.path.join(tmp, what), 0
            trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
            single[what] = (dp_test_run(trainer, items, s2s.Sy_intent, DP_TEST_B) if what == "s2s"
                            else dp_step(trainer, inputs[what]["batch"], dev))
        ranks = wait_ranks(procs, tmp, "dp-2rank")
        took = time.perf_counter() - t0

        # 13.3 [dp-2rank]: each rank's step against the one-process B=64 step, the ranks bit-equal
        for what in ("fixed", "asr"):
            a, b = ranks[0][what], ranks[1][what]
            for key in ("grads", "params"):
                for n, v in a[key].items():
                    if not (v is None and b[key][n] is None or torch.equal(v, b[key][n])):
                        raise AssertionError(f"[dp-2rank] {what}: the ranks' {key} of {n} differ")
            lr = (asr_cfg.pretraining_lr if what == "asr" else fixed.config.training_lr)
            g_err, p_err, unsettled = grads_close(a, single[what], lr)
            # the values are each rank's shares of the global batch's: they sum to the one-process values
            shares = [x + y for x, y in zip(a["values"], b["values"])]
            v_err = max(abs(x - y) for x, y in zip(shares, single[what]["values"]))
            if not (g_err <= STEP_GRAD_TOL and p_err <= STEP_PARAM_ATOL and v_err <= STEP_LOSS_ATOL):
                raise AssertionError(f"[dp-2rank] {what}: gradients {g_err:.3g} (limit {STEP_GRAD_TOL}), "
                                     f"parameters {p_err:.3g} (limit {STEP_PARAM_ATOL}), values {v_err:.3g} "
                                     f"(limit {STEP_LOSS_ATOL}) off the one-process step")
            batch, half = inputs[what]["batch"], DP_B // 2
            w = [float(batch["w"][r * half:(r + 1) * half].sum()) for r in range(2)]
            frames = ([int((batch["y_phoneme"][r * half:(r + 1) * half] != -1).sum()) for r in range(2)]
                      if what == "asr" else None)
            print(f"[dp-2rank] {what} ({'ASR pretraining_type 2, 2.25 s' if what == 'asr' else 'fixed-slot, 4 s'}), "
                  f"2 ranks on the one card over gloo on CUDA tensors (NCCL refuses two ranks on one GPU), "
                  f"{half} of the {DP_B} rows each (weights {w}{'; valid phoneme frames ' + str(frames) if frames else ''}): "
                  f"the ranks' gradients and parameters bit-equal; against the one-process B={DP_B} step, every "
                  f"gradient within {g_err:.3g} of its tensor's largest element (limit {STEP_GRAD_TOL}), the "
                  f"parameters within {p_err:.3g} where the first Adam step's sign is settled (limit "
                  f"{STEP_PARAM_ATOL}; {unsettled} elements with a gradient within {STEP_GRAD_TOL} of the "
                  f"largest are held to one step), the ranks' shares summing to the step's values within "
                  f"{v_err:.3g} (limit {STEP_LOSS_ATOL})")

        # 13.4 [dp-test]: the data-parallel test against the one-process test
        want = single["s2s"]
        got = [rk["s2s"] for rk in ranks]
        strings = {**got[0]["strings"], **got[1]["strings"]}
        if strings != want["strings"] or len(strings) != DP_TEST_N:
            raise AssertionError("[dp-test] the ranks decoded other strings than the one process")
        for g in got:
            if g["acc"] != want["acc"] or not abs(g["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]):
                raise AssertionError(f"[dp-test] acc {g['acc']} loss {float(g['loss'])!r} against {want['acc']} "
                                     f"{float(want['loss'])!r}")
            # each batch's decode replays its padded shape's CUDA graph; K7 runs eagerly in a capture's warm pass
            if not (g["launches"]["K4f"] > 0 and g["replayed"] == g["batches"]
                    and g["launches"]["K7"] == g["captured"] > 0):
                raise AssertionError(f"[dp-test] a rank launched {g['launches']} over {g['batches']} batches, "
                                     f"{g['replayed']} graph replays, {g['captured']} captures")
        print(f"[dp-test] all_real_seq2seq.cfg model, Trainer.test at decode_acc_from_epoch 0 on {DP_TEST_N} "
              f"utterances of 1.0-4.0 s, {DP_TEST_B} a batch on each of 2 ranks (gloo, one card) and in one "
              f"process: loss {float(got[0]['loss'])!r} against {float(want['loss'])!r} (limit 1e-5 relative), acc "
              f"{got[0]['acc']}, all {len(strings)} decoded strings equal; launches a rank "
              f"{[g['launches'] for g in got]} over {got[0]['batches']} batches, each decode a CUDA graph's "
              f"replay ({[g['captured'] for g in got]} captured; one process: {want['launches']}); the two "
              f"ranks and the references took {took:.1f} s")

        # 13.5 [profile-dir]: epoch 0 of Trainer.train under profile_dir, its trace against the counters
        model = flagship_model(dev, seed=4)
        model.config.folder = os.path.join(tmp, "profiled")
        model.config.profile_dir = os.path.join(tmp, "profile")
        trainer = Trainer(model, model.config)
        data = Batches(synthetic_batches(rng, 2, DP_B, model.values_per_slot))
        for c in counters.values():
            c.launches = 0
        trainer.train(data)
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in counters.items()}
        trace = os.path.join(model.config.profile_dir, "rank0.train.pt.trace.json")
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        seen = {k: 0 for k in counters}
        for e in events:
            k = step_kernel(e["name"])
            if k:
                seen[k] += 1
        if seen != launched or not all(launched.values()):
            raise AssertionError(f"[profile-dir] the trace's kernels {seen} against the launch counters {launched}")
        trainer.train(data)
        files = os.listdir(model.config.profile_dir)
        if files != ["rank0.train.pt.trace.json"]:
            raise AssertionError(f"[profile-dir] after epoch 1: {files}")
        print(f"[profile-dir] epoch 0 of Trainer.train (no_unfreezing.cfg, B={DP_B}, 2 steps) under "
              f"profile_dir: {os.path.basename(trace)}, {len(events)} CUDA kernel events; the hand-written "
              f"kernels of the step by name {seen} equal the launch counters {launched}; epoch 1 wrote no trace")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        parallel.destroy()
        shutil.rmtree(tmp, ignore_errors=True)
    step = {k: v // 3 for k, v in dp_launched.items()}
    test = got[0]["launches"]
    return {"bigru_shared_fwd": {"launches_dp_step": step["K1"], "launches_dp_test": test["K1"]},
            "bigru_trainpool_fwd": {"launches_dp_step": step["K2"]},
            "bigru_shared_bwd": {"launches_dp_step": step["K3"]},
            "bigru_masked_fwd": {"launches_dp_test": test["K4f"]},
            "beam_decode": {"launches_dp_test": test["K7"]},
            "sinc_frontend_fused": {"launches_dp_test": test["K8"]}}


# compute_dtype=bfloat16: K1, K2 and K3 on bf16 streams (phase 14)
BF16_RATIO = 0.25  # bf16 kernel vs plain: at most this share of the plain version's bf16-vs-f32 gap (Frobenius)
BF16_ULPS = 2.0**-6  # ... and within 4 bf16 ulps of the plain result's largest element
BF16_LOSS_RTOL = 1e-3  # one bf16 train step, card vs CPU: the loss
BF16_NUDGE = 2.0**-22  # the noise floor's step: each sample moved by this share of itself (4 f32 ulps)
BF16_FLOOR = 2.0  # one bf16 ASR train step, card vs CPU: its gradient within this many times the noise floor
BF16_STEP_FAR = 0.5  # one bf16 fixed-slot step, card vs CPU: its gradient within this relative distance
BF16_SOURCES = {"K1": (K1_SOURCE, K1_REPLACES, "bigru_shared_fwd_bf16"),
                "K2": (K2_SOURCE, K2_REPLACES, "bigru_trainpool_fwd_bf16"),
                "K3": (K3_SOURCE, K3_REPLACES, "bigru_shared_bwd_bf16")}


def bf16_hold(what: str, got, ref, ref32) -> float:
    """``got`` (a bf16 kernel's output) against ``ref`` (its plain version
    at bf16), the yardstick ``ref32`` (the plain version on f32 copies of
    the same inputs): the relative Frobenius distance at most ``BF16_RATIO``
    of the bf16-vs-f32 gap, and within ``BF16_ULPS`` of the largest element.
    Returns the ratio of the distances."""
    g, r, r32 = (t.detach().double().cpu() for t in (got, ref, ref32))
    if g.shape != r.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(g.shape)} against {ref.dtype} {tuple(r.shape)}")
    gap = ((r - r32).norm() / r32.norm().clamp_min(1e-30)).item()
    dist = ((g - r).norm() / r.norm().clamp_min(1e-30)).item()
    if not (gap > 0.0 and dist <= BF16_RATIO * gap and (g - r).abs().max().item() <= BF16_ULPS * r.abs().max().item()):
        raise AssertionError(f"{what}: {dist:.3g} from the plain version at bf16, whose gap to f32 is {gap:.3g} "
                             f"(limit {BF16_RATIO} of it); max abs {(g - r).abs().max().item():.3g} against the "
                             f"largest {r.abs().max().item():.3g}")
    return dist / gap


def bf16_layer(rng, dev, name: str, d: int, n_parts: int, T: int, B: int, kernels) -> dict:
    """The bf16 kernels of ``kernels`` (of "K1", "K2", "K3") at one bi-GRU
    layer's shape against their plain versions (``bf16_hold``), as the bf16
    train and test passes run them: an encoder layer K1 with its avg pool 2,
    K2 at dropout 0.5 and pool 2 (its zero pattern equal) and K3 fused on
    K2's plain outputs; the intent layer (``INTENT_SHAPE``) K1 unpooled and
    K3 plain on K1's plain outputs. Returns each kernel's largest ratio and
    largest abs error, and the layer's inputs for timing."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops.bigru_shared import (
        _shift_hp,
        bigru_shared,
        bigru_shared_bwd,
        bigru_shared_bwd_reference,
        bigru_shared_reference,
        bigru_trainpool,
        bigru_trainpool_reference,
    )

    bf = torch.bfloat16
    intent = name == INTENT_SHAPE[0]
    params, parts32 = k1_case(rng, n_parts, d, T, B, 128, dev)
    parts = tuple(p.to(bf) for p in parts32)
    parts32 = tuple(p.float() for p in parts)
    out = {"ratio": {}, "err": {}, "params": params, "parts": parts}

    def hold(k, pairs):
        pairs = list(pairs)
        out["ratio"][k] = max(bf16_hold(f"{k} bf16 {name} T={T} B={B} {w}", g, r, r32) for w, g, r, r32 in pairs)
        out["err"][k] = max((g.float() - r.float()).abs().max().item() for _, g, r, _ in pairs)

    pool = 1 if intent else 2
    out["pool"] = pool
    if "K1" in kernels:
        got = bigru_shared(params, parts, pool=pool)[:2]
        hold("K1", zip(("h_f", "h_b"), got, bigru_shared_reference(params, parts, pool=pool),
                       bigru_shared_reference(params, parts32, pool=pool)))
    if intent:
        h_f, h_b = bigru_shared_reference(params, parts)
        hp, hp32, kw, To = _shift_hp(h_f, h_b), _shift_hp(h_f.float(), h_b.float()), {}, T
    else:
        kw, To = {"pool": 2, "drop_p": 0.5, "seed": int(rng.integers(2**32))}, -(-T // 2)
        ref = bigru_trainpool_reference(params, parts, **kw)
        if "K2" in kernels:
            got = bigru_trainpool(params, parts, **kw)
            hold("K2", zip(("hp_f", "hp_b", "pooled_f", "pooled_b"), got, ref,
                           bigru_trainpool_reference(params, parts32, **kw)))
            if not all(same_zeros(g.float(), r.float()) for g, r in zip(got[2:], ref[2:])):
                raise AssertionError(f"K2 bf16 {name} T={T} B={B}: dropout zero pattern differs")
        hp, hp32 = ref[:2], tuple(h.float() for h in ref[:2])
    out["bwd"] = (hp, [torch.from_numpy(rng.standard_normal((To, B, 128)).astype(np.float32)).to(dev, bf)
                       for _ in range(2)], kw)
    if "K3" in kernels:
        dy = out["bwd"][1]
        dxs, grads = bigru_shared_bwd(params, parts, *hp, *dy, **kw)
        rdxs, rgrads = bigru_shared_bwd_reference(params, parts, *hp, *dy, **kw)
        r32dxs, r32grads = bigru_shared_bwd_reference(params, parts32, *hp32, *(t.float() for t in dy), **kw)
        pairs = [(f"dx{i}", g, r, r32) for i, (g, r, r32) in enumerate(zip(dxs, rdxs, r32dxs))]
        pairs += [(f"{dd}.{n}", grads[dd][n], rgrads[dd][n], r32grads[dd][n]) for dd in grads for n in grads[dd]]
        if not all(g.dtype == bf for _, g, *_ in pairs[:len(dxs)]) or any(
                g.dtype != torch.float32 for _, g, *_ in pairs[len(dxs):]):
            raise AssertionError(f"K3 bf16 {name}: dX must be bf16 and the weight gradients f32")
        hold("K3", pairs)
    torch.cuda.synchronize()
    return out


def bf16_layer_call(k: str, held: dict, which: str):
    """A call of kernel ``k`` ("K1", "K2", "K3") on a ``bf16_layer``'s inputs:
    ``which`` "bf16" (its bf16 parts and residuals), "f32" (f32 copies of
    them: the f32 kernel) or "plain" (the bf16 plain version)."""
    import torch

    from tpu_slu_torch.ops.bigru_shared import (
        bigru_shared,
        bigru_shared_bwd,
        bigru_shared_bwd_reference,
        bigru_shared_reference,
        bigru_trainpool,
        bigru_trainpool_reference,
    )

    params, parts = held["params"], held["parts"]
    hp, dy, kw = held["bwd"]
    if which == "f32":
        parts, hp, dy = (tuple(t.float() for t in ts) for ts in (parts, hp, dy))
    plain = which == "plain"
    if k == "K1":
        pool = held["pool"]
        fn = bigru_shared_reference if plain else bigru_shared
        return lambda: fn(params, parts, pool=pool)
    if k == "K2":
        fn = bigru_trainpool_reference if plain else bigru_trainpool
        return lambda: fn(params, parts, pool=2, drop_p=0.5, seed=11)
    fn = bigru_shared_bwd_reference if plain else bigru_shared_bwd
    return lambda: fn(params, parts, *hp, *dy, **kw)


def bf16_step_vs_cpu(dev, rng, kind: str, B: int = 16) -> dict:
    """One train step at ``compute_dtype=bfloat16`` (batch B), card against
    the CPU plain path from equal weights and equal dropout masks: the
    fixed-slot model of ``no_pretraining.cfg`` on 4 s (the intent layer's
    dropout 0, the encoder's 0.5), that model with every GRU layer
    unidirectional (``unidirectional``, K5f/K5b) or on ``gru_layout``
    "rowstack" (``rowstack``, K6), the seq2seq model of
    ``all_real_seq2seq.cfg`` on 4 s at U = ``S2S_U`` (dropout on; K4f/K4b),
    or the ASR model of ``no_unfreezing.cfg`` on 2.25 s (dropout on). The
    loss within ``BF16_LOSS_RTOL`` relative.

    The whole gradient (every parameter's, as one vector; each finite) is
    held by its relative Frobenius distance from the CPU's bf16 one against
    the noise floor of bf16 itself: the distance between two CPU bf16 steps
    whose inputs differ at the f32 level, every sample of the waveforms
    moved by ``BF16_NUDGE`` of itself and every weight by one f32 ulp, up or
    down at random. f32 differences of that size (the card's cuDNN convs and
    kernels sum in another order) round some values in every layer to the
    other bf16, and the bf16 recurrences spread them over 5 layers and 400
    steps, forward and backward: the two steps then part by about the
    bf16-vs-f32 gap itself (on an H100, PERF.md section 6), so a quarter of
    that gap (``BF16_RATIO``, the kernels' bound) cannot hold for a step.
    The limit is ``BF16_FLOOR`` times that floor, or ``BF16_RATIO`` of the
    gap where that is larger, for the ASR and the seq2seq step. The
    fixed-slot loss (all three fixed-slot kinds) takes a
    max over time, so its gradient is not continuous in the inputs: where
    bf16 noise moves a max to another frame the gradient jumps (on an H100,
    25.6 gaps from the CPU's with a floor of 5.2 in one of six seeded
    batches); its gradient is held only to ``BF16_STEP_FAR``, which a wrong
    kernel or route breaks, and its distance from the floor is reported.
    Each gradient alone is reported. Returns the whole gradient's distance
    and floor as shares of its gap, the largest gradient's, and the
    losses."""
    import numpy as np
    import torch

    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel, encoder_loss
    from tpu_slu_torch.models.flagship import (FLAGSHIP_CFG, TRAIN_CFG, UNIDIRECTIONAL, flagship_model,
                                               flagship_seq2seq_model)

    bf = torch.bfloat16
    fixed_slot = kind in ("fixed-slot", "unidirectional", "rowstack")
    if fixed_slot:
        cpu_model = flagship_model("cpu", cfg=TRAIN_CFG, intent_rnn_drop=[0.0],
                                   **(UNIDIRECTIONAL if kind == "unidirectional" else {})).train()
        if kind == "rowstack":
            cpu_model.pretrained_model.gru_layout = "rowstack"
        batch = synthetic_batches(rng, 1, B, cpu_model.values_per_slot)[0]
    elif kind == "seq2seq":
        cpu_model = flagship_seq2seq_model("cpu").train()
        batch = s2s_batches(rng, 1, B, cpu_model.Sy_intent)[0]
    else:
        config = read_config(FLAGSHIP_CFG, make_dirs=False)
        config.num_phonemes = 42
        cpu_model = PretrainedModel(config, generator=torch.Generator().manual_seed(3)).train()
        batch = asr_batches(rng, 1, B, ASR_T, 42, config.vocabulary_size, config.phone_downsample_factor,
                            config.word_downsample_factor)[0]
    card_model = copy.deepcopy(cpu_model).to(dev)
    sign = np.where(rng.random(batch["x"].shape) < 0.5, -1.0, 1.0)
    nudged = dict(batch, x=(batch["x"] * (1.0 + BF16_NUDGE * sign)).astype(np.float32))
    nudged_model = copy.deepcopy(cpu_model)
    with torch.no_grad():
        for p in nudged_model.parameters():
            up = torch.from_numpy(rng.random(tuple(p.shape)) < 0.5)
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))

    def step(model, where, dtype, b=batch):
        b = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
        model.zero_grad(set_to_none=True)
        gen = torch.Generator().manual_seed(5)
        if fixed_slot:
            loss, _ = model.loss(b["x"], b["y_intent"], train=True, weights=b["w"], lengths=b["len"],
                                 generator=gen, compute_dtype=dtype)
        elif kind == "seq2seq":
            loss, _ = model.loss(b["x"], b["y_intent"], train=True, weights=b["w"], lengths=b["len"],
                                 y_len=b["y_len"], generator=gen, compute_dtype=dtype)
        else:
            pl, wl, _, _ = encoder_loss(model, b["x"], b["y_phoneme"].long(), b["y_word"].long(), train=True,
                                        generator=gen, weights=b["w"], compute_dtype=dtype)
            loss = pl + wl
        if loss.dtype != torch.float32:
            raise AssertionError(f"bf16 {kind} step: the loss is {loss.dtype}")
        loss.backward()
        return loss.item(), {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()
                             if p.grad is not None}

    l_card, g_card = step(card_model, dev, bf)
    l_cpu, g_cpu = step(cpu_model, torch.device("cpu"), bf)
    l_nudge, g_nudge = step(nudged_model, torch.device("cpu"), bf, nudged)
    l32, g32 = step(cpu_model, torch.device("cpu"), None)
    if not abs(l_card - l_cpu) <= BF16_LOSS_RTOL * abs(l_cpu):
        raise AssertionError(f"bf16 {kind} step: loss card {l_card} vs CPU {l_cpu}")

    def dist(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    if set(g_card) != set(g_cpu) or not all(torch.isfinite(g).all() for g in g_card.values()):
        raise AssertionError(f"bf16 {kind} step: the card's gradients are not finite or not the CPU's parameters")
    ratio, floor = {}, {}  # each gradient's distance and noise floor, as shares of its bf16-vs-f32 gap
    for n, g in g_cpu.items():
        gap = max(dist(g, g32[n]), 1e-30)
        ratio[n], floor[n] = dist(g_card[n], g) / gap, dist(g_nudge[n], g) / gap
    names = sorted(g_cpu)

    def whole(g):
        return torch.cat([g[n].flatten() for n in names])

    gap, d, fl = dist(whole(g_cpu), whole(g32)), dist(whole(g_card), whole(g_cpu)), dist(whole(g_nudge), whole(g_cpu))
    limit = BF16_STEP_FAR if fixed_slot else max(BF16_RATIO * gap, BF16_FLOOR * fl)
    if not (gap > 0.0 and d <= limit):
        raise AssertionError(f"bf16 {kind} step: the gradient {d:.3g} from the CPU's bf16 one, whose gap to f32 is "
                             f"{gap:.3g} and noise floor {fl:.3g} (limit {limit:.3g})")
    worst = max(ratio, key=ratio.get)
    print(f"[bf16] {kind} train step B={B} at compute_dtype=bfloat16, card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} "
          f"(limit {BF16_LOSS_RTOL} relative; the CPU's f32 loss {l32:.6f}, its bf16 loss on the nudged inputs "
          f"{l_nudge:.6f}); the whole gradient {d:.3g} from the CPU's bf16 one (limit {limit:.3g}), {d / gap:.3g} of "
          f"its bf16-vs-f32 gap {gap:.3g}, the noise floor {fl / gap:.3g} of it; each gradient {min(ratio.values()):.3g}-{ratio[worst]:.3g} of its gap (the "
          f"largest {worst}), its floor {min(floor.values()):.3g}-{max(floor.values()):.3g}")
    return {"ratio": d / gap, "floor": fl / gap, "ratio_by_gradient": ratio[worst], "loss": (l_card, l_cpu, l32)}


CORE_BF16_SOURCE = "tpu_slu_torch/csrc/bigru_gemm.cuh"
CORE_BF16_REPLACES = "tpu_slu/ops/pallas_gru.py:85"  # _mxu: jnp.dot(bf16, bf16, preferred_element_type=f32)


def tc_bound_holds(what: str, got, ref64, K: int, scale64, extra64=0.0) -> float:
    """``got`` (a product of the tensor-core kernel) within (K + 2) 2^-23 of
    the f64 sum of |a_k b_k| (``scale64``; plus ``extra64``) of the f64
    product ``ref64`` of its bf16-rounded operands: the first-order bound of
    a K-term f32 sum, doubled for the tensor cores' truncation (the card
    tests' bound, ``tests/test_torch_cuda.py``). Returns the largest share
    of the bound used."""
    err = (got.double() - ref64).abs()
    bound = (K + 2) * 2.0**-23 * scale64 + extra64
    share = (err / bound.clamp_min(1e-30)).max().item()
    if not share <= 1.0:
        raise AssertionError(f"{what}: {share:.3g} of its bound from the f64 product of its bf16 operands")
    return share


def core_counts(bf16_launches: dict) -> dict:
    """The bf16 core's launches (``gemm_kernel_tc``) that the bf16 GRU
    kernels' launches make, by mode: each makes one projection (gi, and in
    a backward gh too), each backward (K3, K4b, K5b) one dX."""
    return {"proj": sum(bf16_launches.values()),
            "dX": sum(v for k, v in bf16_launches.items() if k in ("K3", "K4b", "K5b"))}


def core_trace(table: dict, reps: int = 3) -> dict:
    """The bf16 core's launches over ``reps`` traced calls in a
    ``kernel_table``, by mode: "proj" (``gemm_kernel_tc`` with B along k: gi
    and gh), "dX" (B along n), and "fma" the FMA core's bf16 products other
    than dW's (``gemm_kernel_mixed`` in a layout other than dW's <1, 1>),
    which must be none."""
    out = {"proj": 0, "dX": 0, "fma": 0}
    for key, (n, _) in table.items():
        mode = ("proj" if "gemm_kernel_tc<0, 0" in key else "dX" if "gemm_kernel_tc<0, 1" in key
                else "fma" if "gemm_kernel_mixed<" in key and "gemm_kernel_mixed<1, 1" not in key else None)
        if mode:
            out[mode] += round(reps * n)
    return out


def phase_bf16_core(dev, card: str, rng) -> dict:
    """Phase 14's first part, ``[bf16-core]``: the bf16 GEMM core on the
    tensor cores (``gemm_kernel_tc``) in each of its modes at the flagship's
    shapes against its plain version and an f64 product of its bf16
    operands, and timed beside it and one ``torch.mm`` a product on the
    same bf16 operands; the f32 core by mode beside f32 ``torch.mm``.
    Returns the kernels line's ``bigru_gemm_bf16`` entry (its main-path
    launches are counted in phase 14's trainers)."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops.bigru_gemm import (gemm_dw, gemm_dx, gemm_dx_bf16, gemm_dx_bf16_reference, gemm_proj,
                                              gemm_proj_bf16, gemm_proj_bf16_reference, gemm_proj_rs_bf16,
                                              gemm_proj_rs_bf16_reference, tc_launches)

    bf, H, N = torch.bfloat16, 128, 384

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    # K3's products at its five flagship layers, B = 64 on 4 s (K1's and K2's projections are the
    # same mode on the same shapes): gi and gh of both directions (phase 1) and dX (phase 3); K6's
    # row-stacked gi at its decode's five layers, B = 16
    modes = {"proj": [], "dx": [], "rs": []}
    for name, d, n_parts, T in ENC_SHAPES + [INTENT_SHAPE]:
        M, D = T * 64, d * n_parts
        parts = [f32(M, d).to(bf) for _ in range(n_parts)]
        hp = f32(M, H).to(bf)
        for _ in range(2):
            wih, bih, whh, bhh = f32(N, D, scale=0.1), f32(N, scale=0.1), f32(N, H, scale=0.1), f32(N, scale=0.1)
            modes["proj"].append((f"{name} gi", (parts[0], parts[1] if n_parts > 1 else None, wih, bih), D))
            modes["proj"].append((f"{name} gh", (hp, None, whh, bhh), H))
        dgi = f32(2, M, N)
        modes["dx"].append((f"{name} dX", (dgi, (f32(N, D, scale=0.1), f32(N, D, scale=0.1)), d), N))
    for name, d, n_parts, T, _ in FLAGSHIP_LAYERS:
        parts = [f32(T * 16, d).to(bf) for _ in range(n_parts)]
        ws, bs, folds = ([f32(N, d * n_parts, scale=0.1) for _ in range(2)], [f32(N, scale=0.1) for _ in range(2)],
                         [f32(N, scale=0.1) for _ in range(2)])
        modes["rs"].append((f"{name} K6 gi", (parts[0], parts[1] if n_parts > 1 else None, ws, bs, folds, T, 16),
                            d * n_parts))
    kernel = {"proj": gemm_proj_bf16, "dx": gemm_dx_bf16, "rs": gemm_proj_rs_bf16}
    plain = {"proj": gemm_proj_bf16_reference, "dx": gemm_dx_bf16_reference, "rs": gemm_proj_rs_bf16_reference}

    def cat(x1, x2):
        return x1 if x2 is None else torch.cat([x1, x2], 1)

    # each mode against the f64 product of its bf16 operands and its plain version
    errs, shares = {}, {}
    before = tc_launches()
    for mode, cases in modes.items():
        errs[mode] = shares[mode] = 0.0
        for what, args, K in cases:
            got = kernel[mode](*args)
            ref = plain[mode](*args)
            torch.cuda.synchronize()
            if mode == "proj":
                x, w, b = cat(*args[:2]).double(), args[2].to(bf).double(), args[3].double()
                share = tc_bound_holds(what, got, x @ w.t() + b, K, x.abs() @ w.abs().t() + b.abs())
            elif mode == "rs":
                x, (ws, bs, folds, T, B) = cat(*args[:2]).double(), args[2:]
                keep = (torch.arange(N, device=dev) < 2 * N // 3).double()
                share = 0.0
                for dd in range(2):
                    w, extra = ws[dd].to(bf).double(), bs[dd].double() + keep * folds[dd].double()
                    r64, s64 = (x @ w.t() + extra).view(T, B, N), (x.abs() @ w.abs().t() + extra.abs()).view(T, B, N)
                    if dd:
                        r64, s64 = r64.flip(0), s64.flip(0)
                    share = max(share, tc_bound_holds(what, got[:, dd * B:(dd + 1) * B], r64, K + 2, s64))
            else:
                a, ws, d1 = args
                exact = [a[i].to(bf).double() @ w.to(bf).double() for i, w in enumerate(ws)]
                spacing = 2.0**-7 * (exact[0].abs() + exact[1].abs() + (exact[0] + exact[1]).abs())
                scale = sum(a[i].to(bf).double().abs() @ w.to(bf).double().abs() for i, w in enumerate(ws))
                got, ref = torch.cat(got, 1), torch.cat(ref, 1)
                share = tc_bound_holds(what, got, exact[0] + exact[1], K, scale, spacing)
                same = (got == ref).double().mean().item()
                if same < 0.99:
                    raise AssertionError(f"{what}: {same:.4f} of dX's elements equal the plain version's, want 0.99")
            errs[mode] = max(errs[mode], (got.float() - ref.float()).abs().max().item())
            shares[mode] = max(shares[mode], share)
            again = kernel[mode](*args)
            again = torch.cat(again, 1) if mode == "dx" else again
            if not torch.equal(again, got):
                raise AssertionError(f"{what}: a second call differs from the first")
        print(f"[bf16-core] {mode}: {len(cases)} products against the f64 product of their bf16 operands, at most "
              f"{shares[mode]:.3g} of the bound (K + 2) 2^-23 sum|a||b|; max abs err against the plain version "
              f"{errs[mode]:.3g}; a second call equal bit for bit")
    torch.cuda.synchronize()
    if tc_launches() - before != 2 * sum(len(c) for c in modes.values()):
        raise AssertionError(f"[bf16-core] {tc_launches() - before} tensor-core launches for "
                             f"{2 * sum(len(c) for c in modes.values())} calls")

    # times: the kernel and its plain version in turns, one torch.matmul a product on the same bf16
    # operands (f32 out where this torch's mm takes out_dtype, else bf16), the bound
    a16, b16 = f32(64, 64).to(bf), f32(64, 64).to(bf)
    try:
        torch.mm(a16, b16, out_dtype=torch.float32)
        lib_out = "f32 (out_dtype=torch.float32)"

        def mm(a, b):
            return torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        lib_out = "bf16 (this torch's mm takes no out_dtype)"

        def mm(a, b):
            return torch.mm(a, b)
    entry = {"name": "bigru_gemm_bf16", "route": "cuda", "source": CORE_BF16_SOURCE, "replaces": CORE_BF16_REPLACES,
             "launches": None, "max_abs_err": max(errs.values()), "library_output": lib_out, "by_mode": {}}
    for mode, cases in modes.items():
        flops = nbytes = 0.0
        lib_args = []
        for _, args, K in cases:
            if mode == "dx":
                a, ws, _ = args
                M, D = a.shape[1], ws[0].shape[1]
                flops += 2 * 2 * M * N * D
                nbytes += 4 * (2 * M * N + 2 * N * D) + 2 * M * D
                lib_args.append((torch.cat([a[0], a[1]], 1).to(bf), torch.cat(list(ws), 0).to(bf)))
            else:
                x = cat(*args[:2])
                M = x.shape[0]
                nd = 2 if mode == "rs" else 1
                flops += nd * 2 * M * N * K
                nbytes += 2 * M * K + nd * (4 * (N * K + nd * N) + 4 * M * N)  # rs: the fold too
                for w in (args[2] if mode == "rs" else [args[2]]):
                    lib_args.append((x, w.to(bf).t().contiguous()))

        def run(fn=kernel[mode], cases=cases):
            for _, args, _ in cases:
                fn(*args)

        def lib(lib_args=lib_args):
            for a, b in lib_args:
                mm(a, b)

        k_ms, p_ms = in_turns(lambda: run(plain[mode]), run)
        l_ms = cuda_ms(lib, reps=10)
        b_ms, b_by = bound_bf16(flops, 0.0, nbytes)
        entry["by_mode"][mode] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                  "bound_by": b_by, "products": len(lib_args), "flops": flops, "bytes": nbytes,
                                  "max_abs_err": errs[mode], "max_bound_share": shares[mode]}
        print(f"[bf16-core] [time] {mode} ({len(cases)} calls, {len(lib_args)} products"
              f"{', K3 five layers B=64' if mode != 'rs' else ', K6 five layers B=16'}): kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.3f} ms, torch.mm {l_ms:.4f} ms ({lib_out}), bound {b_ms:.4f} ms ({b_by}), "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s, {nbytes / k_ms / 1e6:.0f} GB/s on {card}")
    # the f32 core (gemm_kernel) by mode on f32 copies of the same operands, and dW (f32 at either
    # dtype: at bf16 the same FMA loop on the parts widened, gemm_kernel_mixed), each beside one
    # torch.mm a product in f32 (TF32 off, torch's default) and its bound at the f32 peak
    f32_cases = {"proj": [(gemm_proj, (args[0].float(), None if args[1] is None else args[1].float(), *args[2:]))
                          for _, args, _ in modes["proj"]],
                 "dx": [(gemm_dx, args) for _, args, _ in modes["dx"]], "dw": []}
    for (_, (x1, x2, *_), _), (_, (hp, *_), _), (_, (dgi, *_), _) in zip(modes["proj"][::4], modes["proj"][1::4],
                                                                         modes["dx"]):
        for i in range(2):  # each direction's dW_ih and dW_hh, the gate gradients standing in for dgh
            f32_cases["dw"].append((gemm_dw, (dgi[i], x1.float(), None if x2 is None else x2.float())))
            f32_cases["dw"].append((gemm_dw, (dgi[i], hp.float(), None)))
    entry["f32_by_mode"] = {}
    for mode, cases in f32_cases.items():
        flops = nbytes = 0.0
        lib_args = []
        for fn, args in cases:
            if mode == "proj":
                x, w = cat(args[0], args[1]), args[2]
                lib_args.append((x, w.t()))
                flops += 2 * x.shape[0] * N * x.shape[1]
                nbytes += 4 * (x.numel() + w.numel() + N + x.shape[0] * N)
            elif mode == "dx":
                a, ws, _ = args
                lib_args.append((torch.cat([a[0], a[1]], 1), torch.cat(list(ws), 0)))
                flops += 2 * 2 * a.shape[1] * N * ws[0].shape[1]
                nbytes += 4 * (a.numel() + 2 * ws[0].numel() + a.shape[1] * ws[0].shape[1])
            else:
                a, x = args[0], cat(args[1], args[2])
                lib_args.append((a.t(), x))
                flops += 2 * a.shape[0] * N * x.shape[1]
                nbytes += 4 * (a.numel() + x.numel() + N * x.shape[1] + N)

        def run(cases=cases):
            for fn, args in cases:
                fn(*args)

        def lib(lib_args=lib_args):
            for a, b in lib_args:
                torch.mm(a, b)

        k_ms, l_ms = cuda_ms(run, reps=10), cuda_ms(lib, reps=10)
        b_ms, b_by = bound(flops, nbytes)
        entry["f32_by_mode"][mode] = {"ms": k_ms, "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                                      "products": len(cases)}
        print(f"[bf16-core] [time] f32 core {mode} ({len(cases)} calls, K3 five layers B=64): gemm_kernel "
              f"{k_ms:.4f} ms, torch.mm f32 {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{flops / k_ms / 1e9:.1f} TFLOP/s on {card}")

    # the kernels line's numbers: K3's bf16 products, gi/gh and dX, at its five layers
    k3 = [entry["by_mode"][m] for m in ("proj", "dx")]
    for key in ("ms", "plain_ms", "library_ms"):
        entry[key] = sum(m[key] for m in k3)
    entry["bound_ms"], entry["bound_by"] = bound_bf16(sum(m["flops"] for m in k3), 0.0, sum(m["bytes"] for m in k3))
    return entry


def phase_bf16(dev, card: str, rng, core: dict) -> list[dict]:
    """Phase 14: ``compute_dtype=bfloat16``. Returns the kernels line's
    entries of K1, K2 and K3's bf16 instantiations; sets ``core``'s (the
    ``bigru_gemm_bf16`` entry's) launches from the fixed-slot and ASR
    trainers' main paths."""
    import numpy as np
    import torch

    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG, TRAIN_CFG, flagship_model
    from tpu_slu_torch.ops.bigru_gemm import tc_launches, zero_tc_launches
    from tpu_slu_torch.ops.bigru_shared import (
        bigru_shared,
        bigru_shared_bwd,
        bigru_shared_bwd_reference,
        bigru_shared_reference,
        bigru_trainpool,
        bigru_trainpool_reference,
    )
    from tpu_slu_torch.training import Trainer

    bf = torch.bfloat16
    t_phase = time.perf_counter()
    # 14.1 the bf16 kernels against their plain versions: K1 at the five flagship layers (B = 16, 4 s),
    # K2 at the four encoder layers and K3 at the five (B = 64, 4 s), all three at the ASR encoder's
    # four (B = 64, 2.25 s)
    ratio, err = dict.fromkeys(("K1", "K2", "K3"), 0.0), dict.fromkeys(("K1", "K2", "K3"), 0.0)
    timed = {"K1": [], "K2": [], "K3": []}
    plan = [(16, ("K1",), [s[:4] for s in FLAGSHIP_LAYERS], "4 s", "K1"),
            (64, ("K2", "K3"), ENC_SHAPES + [INTENT_SHAPE], "4 s", "K23"),
            (64, ("K1", "K2", "K3"), asr_shapes(), "2.25 s", None)]
    for B, kernels, shapes, audio, keep in plan:
        for name, d, n_parts, T in shapes:
            held = bf16_layer(rng, dev, name, d, n_parts, T, B, [k for k in kernels if not (
                k == "K2" and name == INTENT_SHAPE[0])])
            for k, v in held["ratio"].items():
                ratio[k], err[k] = max(ratio[k], v), max(err[k], held["err"][k])
            if keep:
                for k in kernels:
                    if not (k == "K2" and name == INTENT_SHAPE[0]):
                        timed[k].append((name, d, n_parts, T, B, held))
            print(f"[bf16] {name:11s} T={T:3d} B={B:2d} ({audio}): "
                  + ", ".join(f"{k} {held['ratio'][k]:.3g}" for k in held["ratio"])
                  + f" of the plain version's bf16-vs-f32 gap (limit {BF16_RATIO}), within {BF16_ULPS:.4g} of "
                  "the largest element")
    print(f"[bf16] the bf16 kernels against their plain versions: largest share of the gap K1 {ratio['K1']:.3g}, "
          f"K2 {ratio['K2']:.3g}, K3 {ratio['K3']:.3g}; max abs err K1 {err['K1']:.3g}, K2 {err['K2']:.3g}, "
          f"K3 {err['K3']:.3g}")

    # 14.2 one bf16 train step of each model against the CPU
    steps = {kind: bf16_step_vs_cpu(dev, rng, kind) for kind in ("fixed-slot", "ASR")}

    # 14.3 the main path: Trainer.train at compute_dtype=bfloat16, fixed-slot and ASR, B = 64; the counts
    # of the bf16 instantiations set to 0 just before each and read just after
    counters = {"K1": bigru_shared, "K2": bigru_trainpool, "K3": bigru_shared_bwd}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        model = flagship_model(dev, cfg=TRAIN_CFG, seed=1)
        config = model.config
        config.folder, config.compute_dtype = os.path.join(tmp, "slu"), "bfloat16"
        trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
        data = Batches(synthetic_batches(rng, 3, config.training_batch_size, model.values_per_slot))
        for c in counters.values():
            c.launches = c.launches_bf16 = 0
        zero_tc_launches()
        acc, loss = trainer.train(data)
        torch.cuda.synchronize()
        launches = {k: (c.launches_bf16, c.launches) for k, c in counters.items()}
        tc = tc_launches()
        n = len(data.loader)
        if launches != {"K1": (n, n), "K2": (4 * n, 4 * n), "K3": (5 * n, 5 * n)} or not np.isfinite(loss):
            raise AssertionError(f"bf16 Trainer.train over {n} steps: (bf16, all) launches {launches}, loss {loss}")
        if tc != 15 * n:  # the bf16 core: 1 K1, 4 K2 and 5 K3 projections, 5 K3 dX a step
            raise AssertionError(f"bf16 Trainer.train over {n} steps: {tc} launches of the bf16 core, want {15 * n}")
        for c in counters.values():
            c.launches = c.launches_bf16 = 0
        t_acc, t_loss = trainer.test(data)
        test_launches = {k: (c.launches_bf16, c.launches) for k, c in counters.items()}
        if test_launches != {"K1": (5 * n, 5 * n), "K2": (0, 0), "K3": (0, 0)} or not np.isfinite(t_loss):
            raise AssertionError(f"bf16 Trainer.test over {n} batches: launches {test_launches}, loss {t_loss}")
        print(f"[bf16-trainer] Trainer.train at no_pretraining.cfg width and compute_dtype=bfloat16, "
              f"B={config.training_batch_size}, {n} steps: loss {loss:.4f} acc {acc:.3f}; (bf16, all) launches "
              f"{launches}, the bf16 core (gemm_kernel_tc) {tc}; Trainer.test loss {t_loss:.4f}, launches "
              f"{test_launches}")
        main_launches = {k: v[0] for k, v in launches.items()}
        core["launches"] = tc

        asr_cfg = read_config(FLAGSHIP_CFG, make_dirs=False)
        asr_cfg.folder, asr_cfg.num_phonemes, asr_cfg.compute_dtype = os.path.join(tmp, "asr"), 42, "bfloat16"
        asr_model = PretrainedModel(asr_cfg, generator=torch.Generator().manual_seed(1)).to(dev)
        asr_trainer = Trainer(asr_model, asr_cfg, generator=torch.Generator().manual_seed(7))
        asr_data = Batches(asr_batches(rng, 2, asr_cfg.pretraining_batch_size, ASR_T, 42, asr_cfg.vocabulary_size,
                                       asr_cfg.phone_downsample_factor, asr_cfg.word_downsample_factor))
        for c in counters.values():
            c.launches = c.launches_bf16 = 0
        zero_tc_launches()
        asr_out = asr_trainer.train(asr_data)
        torch.cuda.synchronize()
        asr_launches = {k: (c.launches_bf16, c.launches) for k, c in counters.items()}
        tc = tc_launches()
        n = len(asr_data.loader)
        if asr_launches != {"K1": (0, 0), "K2": (4 * n, 4 * n), "K3": (4 * n, 4 * n)} or not np.isfinite(asr_out[1]):
            raise AssertionError(f"bf16 ASR Trainer.train over {n} steps: launches {asr_launches}, {asr_out}")
        if tc != 12 * n:  # 4 K2 and 4 K3 projections, 4 K3 dX a step
            raise AssertionError(f"bf16 ASR Trainer.train over {n} steps: {tc} launches of the bf16 core, want {12 * n}")
        core["launches_asr_train"] = tc
        asr_test = asr_trainer.test(asr_data)
        print(f"[bf16-trainer] ASR Trainer.train at compute_dtype=bfloat16, B={asr_cfg.pretraining_batch_size}, "
              f"{n} steps: phone loss {asr_out[1]:.4f} word loss {asr_out[3]:.4f}; (bf16, all) launches "
              f"{asr_launches}, the bf16 core {tc}; Trainer.test phone loss {asr_test[1]:.4f}")

        # 14.4 the warm steps at bf16 beside f32, in turns f32, bf16, bf16, f32; each bf16 step's profile
        # names the bf16 instantiations of K1, K2 and K3 as often as their counters count
        f32_trainer = Trainer(model, copy.copy(config), generator=torch.Generator().manual_seed(7))
        f32_trainer.compute_dtype = None
        asr_f32 = Trainer(asr_model, copy.copy(asr_cfg), generator=torch.Generator().manual_seed(7))
        asr_f32.compute_dtype = None
        cases = {"fixed-slot": (f32_trainer, trainer, data.loader[0], 4.0),
                 "ASR": (asr_f32, asr_trainer, asr_data.loader[0], ASR_T / 16000)}
        step_times = {}
        for kind, (t32, t16, host_batch, secs) in cases.items():
            batch = t16._to_device(host_batch)
            times = {"f32": [], "bf16": []}
            for which in ("f32", "bf16", "bf16", "f32"):
                t = t32 if which == "f32" else t16
                times[which] += cuda_times(lambda: t.train_step(batch), reps=5, warmup=1)
            def reset():
                for c in counters.values():
                    c.launches = c.launches_bf16 = 0
                zero_tc_launches()

            def check(table):
                # kernel_table makes one warm call before it traces its reps
                want = {k: c.launches_bf16 * 3 // 4 for k, c in counters.items()}
                named = {f"{k}{' bf16' if bf16 else ''}": 0 for k in counters for bf16 in (True, False)}
                for key, (n, _) in table.items():
                    if step_kernel(key):
                        named[f"{step_kernel(key)}{' bf16' if 'bfloat16' in key else ''}"] += round(3 * n)
                got = {k: named[f"{k} bf16"] for k in counters}
                # the bf16 core: each counted launch in the trace, in its mode, and no FMA product but dW
                core_want, core_seen = core_counts(want), core_trace(table)
                if sum(core_counts({k: c.launches_bf16 for k, c in counters.items()}).values()) != tc_launches():
                    return f"the bf16 core's count {tc_launches()} is not its kernels' launches' share", False
                if got == want and not any(named[k] for k in counters) and core_seen == {**core_want, "fma": 0}:
                    return None
                return (f"bf16 instantiations {got}, f32 ones { {k: named[k] for k in counters} }, counted {want} "
                        f"over 3 steps; the bf16 core {core_seen}, counted {core_want}",
                        not any(named[k] for k in counters) and all(got[k] <= want[k] for k in got)
                        and not core_seen["fma"] and all(core_seen[m] <= core_want[m] for m in core_want))

            wall, table, traces = counted_trace(lambda: t16.train_step(batch), reset, check,
                                                f"bf16 {kind} step profile")
            got = {k: c.launches_bf16 * 3 // 4 for k, c in counters.items()}
            busy, n_launch = sum(ms for _, ms in table.values()), round(sum(n for n, _ in table.values()))
            wall32, table32 = kernel_table(lambda: t32.train_step(batch), reps=3)
            busy32, n32 = sum(ms for _, ms in table32.values()), round(sum(n for n, _ in table32.values()))
            step_times[kind] = {"bf16_ms": statistics.median(times["bf16"]), "f32_ms": statistics.median(times["f32"]),
                                "bf16_busy_ms": busy, "bf16_idle_share": 1 - busy / wall, "bf16_launches": n_launch,
                                "f32_busy_ms": busy32, "f32_idle_share": 1 - busy32 / wall32, "f32_launches": n32}
            st = step_times[kind]
            print(f"[time] warm {kind} train step B={t16.model.config.training_batch_size if kind == 'fixed-slot' else asr_cfg.pretraining_batch_size}"
                  f" on {secs:g} s, in turns f32, bf16, bf16, f32 (CUDA events, 5 a turn): bf16 median "
                  f"{st['bf16_ms']:.3f} ms, f32 {st['f32_ms']:.3f} ms; profiler: bf16 busy {busy:.3f} ms, idle share "
                  f"{st['bf16_idle_share']:.3f}, {n_launch} launches a step; f32 busy {busy32:.3f} ms, idle share "
                  f"{st['f32_idle_share']:.3f}, {n32} launches; the bf16 step's trace (of {traces} taken) names the "
                  f"bf16 K1, K2, K3 {got} times over 3 steps, as counted, and no f32 one, and the bf16 core "
                  f"(gemm_kernel_tc) {core_counts(got)} times by mode, as counted, with no FMA product but dW's, "
                  f"on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 14.5 K1 (five layers, B = 16), K2 (four, B = 64) and K3 (five, B = 64) at bf16 beside f32, in turns,
    # with the bf16 plain version, cuDNN's bf16 nn.GRU and the bf16 bound (their device time by the
    # profiler is tools/torch_cluster_ab.py --bf16's: in this long process the profiler drops events)
    entries = []
    for k, layers in timed.items():
        ms = {"bf16": 0.0, "f32": 0.0, "plain": 0.0, "lib": 0.0}
        work = [0.0, 0.0, 0.0]  # product FLOPs, gate FLOPs, bytes
        for name, d, n_parts, T, B, held in layers:
            D, H = n_parts * d, 128
            pool = 1 if name == INTENT_SHAPE[0] else 2
            if k == "K3":
                To = held["bwd"][1][0].shape[0]
                w = (2 * T * B * 2 * 3 * H * (3 * D + 3 * H), 2 * T * B * 2 * GATE_OPS * H,
                     2 * (2 * T * B * D + 2 * T * B * H + 2 * To * B * H) + 4 * 2 * gru_weight_floats(D, H))
            else:
                out = 2 * -(-T // pool) * B * H + (2 * T * B * H if k == "K2" else 0)
                w = gru_fwd_work(T * B, D, H, T * B * D, out, stream_bytes=2)
                w = (w[0] - 2 * T * B * GATE_OPS * H, 2 * T * B * GATE_OPS * H, w[1])
            lib = cudnn_gru_ms(D, T, B, H, dev, backward=k == "K3", dtype=bf)
            t = {"f32": [], "bf16": []}
            for which in ("f32", "bf16", "bf16", "f32"):
                t[which].append(cuda_ms(bf16_layer_call(k, held, which), reps=10, warmup=1))
            p_ms = cuda_ms(bf16_layer_call(k, held, "plain"), reps=1, warmup=0)
            for key, v in (("bf16", statistics.median(t["bf16"])), ("f32", statistics.median(t["f32"])),
                           ("plain", p_ms), ("lib", lib)):
                ms[key] += v
            work = [a + b for a, b in zip(work, w)]
            print(f"[time] {k} bf16 {name:11s} B={B} T={T:3d}: bf16 {statistics.median(t['bf16']):.4f} ms, f32 "
                  f"{statistics.median(t['f32']):.4f} ms (in turns), plain bf16 {p_ms:.3f} ms, cuDNN bf16 nn.GRU"
                  f"{' backward' if k == 'K3' else ''} {lib:.4f} ms, bound {bound_bf16(*w)[0]:.4f} ms "
                  f"({bound_bf16(*w)[1]})")
        b_ms, b_by = bound_bf16(*work)
        B = layers[0][4]
        print(f"[time] {k} at bf16, {len(layers)} flagship layers B={B}: kernel {ms['bf16']:.4f} ms beside f32 "
              f"{ms['f32']:.4f} ms (in turns, CUDA events around each call; their device time alone: "
              f"tools/torch_cluster_ab.py --bf16), plain bf16 {ms['plain']:.3f} ms, cuDNN bf16 nn.GRU "
              f"{ms['lib']:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {card}")
        source, replaces, name = BF16_SOURCES[k]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[k], "max_abs_err": err[k], "ms": ms["bf16"], "plain_ms": ms["plain"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": ms["lib"],
            "library_call": "cuDNN nn.GRU in bf16" + (", backward" if k == "K3" else ", unpooled") + ": the nearest "
                            "call, not the same rounding",
            "f32_ms": ms["f32"], "batch": B, "max_gap_ratio": ratio[k],
            "launches_asr_train": asr_launches[k][0]})
    # the bf16 steps, on the first entry: against the CPU (the largest gradient's distance and noise floor,
    # as shares of the bf16-vs-f32 gap) and beside f32 on the card
    entries[0].update({"step_ratio": {kind: v["ratio"] for kind, v in steps.items()},
                       "step_floor": {kind: v["floor"] for kind, v in steps.items()}, "steps": step_times})
    print(f"[bf16] phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# compute_dtype=bfloat16 for K4f, K4b, K5f, K5b and K6 (phase 14, second half)
BF16_MORE_SOURCES = {"K6": (K6_SOURCE, K6_REPLACES, "bigru_shared_fwd_rs_bf16"),
                     "K4f": (K4F_SOURCE, K4F_REPLACES, "bigru_masked_fwd_bf16"),
                     "K4b": (K4B_SOURCE, K4B_REPLACES, "bigru_masked_bwd_bf16"),
                     "K5f": (K5F_SOURCE, K5F_REPLACES, "gru1_fwd_bf16"),
                     "K5b": (K5B_SOURCE, K5B_REPLACES, "gru1_bwd_bf16")}
S2S_LAYER = ("s2s_encoder0", 256, 25)  # the seq2seq encoder layer: its input width and frames on 4 s


def bf16_more_case(rng, dev, k: str, name: str, D: int, T: int, B: int, *, n_parts: int = 1, pool: int = 1,
                   lengths=None) -> dict:
    """Kernel ``k`` (K6, K4f, K4b, K5f or K5b) at one layer shape, H = 128,
    on bf16 streams, held against its plain version at bf16 (``bf16_hold``;
    the yardstick the plain version on f32 copies of the same inputs): K6
    on ``n_parts`` parts with a ``pool``; K4f with ``lengths`` (B,) (None:
    every row T) and exact zeros past each; K4b (every row T) and K5b on
    their forward kernel's bf16 output and a seeded bf16 cotangent; K5f and
    K5b on every row T. Returns the largest ratio and abs error, the calls
    "bf16" (the bf16 wrapper), "f32" (the f32 kernel on the f32 copies) and
    "plain" (the bf16 plain version) on the same inputs, the work of
    ``bound_bf16`` and the cuDNN bf16 yardstick's keyword arguments."""
    import numpy as np
    import torch

    from tpu_slu_torch.ops.bigru_masked import (
        bigru_masked_bwd,
        bigru_masked_bwd_reference,
        bigru_masked_fwd,
        bigru_masked_reference,
    )
    from tpu_slu_torch.ops.bigru_shared import bigru_shared_fwd, bigru_shared_rowstack_reference
    from tpu_slu_torch.ops.gru1 import gru1_bwd, gru1_bwd_reference, gru1_fwd, gru1_reference

    bf, H = torch.bfloat16, 128
    params, parts32 = k1_case(rng, n_parts, D // n_parts, T, B, H, dev)
    ndir = 1 if k.startswith("K5") else 2
    if ndir == 1:
        params = {"fwd": params["fwd"]}
    lib = {"dtype": bf, "bidirectional": ndir == 2, "backward": k.endswith("b")}
    if k == "K6":
        ins = {"bf16": tuple(p.to(bf) for p in parts32)}
        ins["f32"] = tuple(p.float() for p in ins["bf16"])
        calls = {w: (lambda w=w: bigru_shared_fwd(params, ins[w], pool=pool, layout="rowstack")) for w in ins}
        calls["plain"] = lambda: bigru_shared_rowstack_reference(params, ins["bf16"], pool=pool)
        ref32 = bigru_shared_rowstack_reference(params, ins["f32"], pool=pool)
        rows, out_vals = T * B, 2 * -(-T // pool) * B * H
        w = gru_fwd_work(rows, D, H, rows * D, out_vals, stream_bytes=2)
    else:
        x16 = parts32[0].transpose(0, 1).contiguous().to(bf)
        n = None
        if ndir == 2:
            n = torch.from_numpy(np.asarray([T] * B if lengths is None else lengths, np.int64)).to(dev)
            lib["lengths"] = None if lengths is None else list(lengths)
        fwd, fwd_ref = (bigru_masked_fwd, bigru_masked_reference) if ndir == 2 else (gru1_fwd, gru1_reference)
        ins = {"bf16": (x16,), "f32": (x16.float(),)}
        rows = B * T if n is None else int(n.sum())
        if k.endswith("f"):
            calls = {w: (lambda w=w: fwd(params, ins[w][0], n)) for w in ins}
            calls["plain"] = lambda: fwd_ref(params, x16, n)
            ref32 = fwd_ref(params, ins["f32"][0], n)
            w = gru_fwd_work(rows, D, H, rows * D, B * T * ndir * H, dirs=ndir, stream_bytes=2)
        else:
            with torch.inference_mode():
                out = fwd(params, x16, n)
            dy = torch.from_numpy(rng.standard_normal((B, T, ndir * H)).astype(np.float32)).to(dev, bf)
            ins = {"bf16": (x16, out, dy), "f32": (x16.float(), out.float(), dy.float())}
            bwd, bwd_ref = (bigru_masked_bwd, bigru_masked_bwd_reference) if ndir == 2 else (gru1_bwd,
                                                                                            gru1_bwd_reference)
            calls = {w: (lambda w=w: bwd(params, ins[w][0], ins[w][1], n, ins[w][2])) for w in ins}
            calls["plain"] = lambda: bwd_ref(params, *ins["bf16"][:2], n, ins["bf16"][2])
            ref32 = bwd_ref(params, *ins["f32"][:2], n, ins["f32"][2])
            # per row and direction: gi and gh recomputed, the dh chain, dX, dW_ih, dW_hh (2 * 3H * (3D + 3H))
            # and the gate derivatives; in: x, out, dy (bf16), the weights; out: dX (bf16), the weight gradients
            w = (ndir * rows * (2 * 3 * H * (3 * D + 3 * H) + 2 * GATE_OPS * H),
                 2 * (2 * B * T * D + 2 * ndir * B * T * H) + 4 * 2 * gru_weight_floats(D, H, dirs=ndir))
    gates = ndir * rows * GATE_OPS * H * (2 if k.endswith("b") else 1)
    work = (w[0] - gates, gates, w[1])
    got, ref = calls["bf16"](), calls["plain"]()
    if k.endswith("b"):
        (got, grads), (ref, rgrads), (ref32, r32grads) = got, ref, ref32
        pairs = [("dx", got, ref, ref32)] + [(f"{d}.{p}", grads[d][p], rgrads[d][p], r32grads[d][p])
                                             for d in grads for p in grads[d]]
        if got.dtype != bf or any(g.dtype != torch.float32 for _, g, *_ in pairs[1:]):
            raise AssertionError(f"{k} bf16 {name}: dX must be bf16 and the weight gradients f32")
    else:
        pairs = [(f"out{i}", g, r, r32) for i, (g, r, r32) in
                 enumerate(zip(*((t,) if torch.is_tensor(t) else t for t in (got, ref, ref32))))]
    torch.cuda.synchronize()
    ratio = max(bf16_hold(f"{k} bf16 {name} T={T} B={B} {what}", g, r, r32) for what, g, r, r32 in pairs)
    err = max((g.float() - r.float()).abs().max().item() for _, g, r, _ in pairs)
    if lengths is not None:
        t = torch.arange(T, device=dev)[None, :]
        if not (pairs[0][1][t >= n[:, None]] == 0).all():
            raise AssertionError(f"{k} bf16 {name} T={T} B={B}: a frame past its row's length is not 0")
    return {"ratio": ratio, "err": err, "calls": calls, "work": work, "lib": lib, "shape": (name, D, T, B)}


def recurrence_of(name: str) -> tuple[str, bool] | None:
    """("forward" or "chain", whether its streams are bf16) of a traced
    kernel that is a GRU recurrence, the one launch each wrapper call of a
    recurrent kernel makes: the cluster recurrence (``gru_cluster_kernel``:
    K1, K2, K4f, K5f, K6), the backward one (``gru_cluster_bwd_kernel``:
    the chain of K3, K4b and K5b, bf16 by its third template argument);
    else None."""
    if "gru_cluster_bwd_kernel<" in name:
        bf = name.split("gru_cluster_bwd_kernel<", 1)[1].split(">", 1)[0].split(",")[2].strip()
        return "chain", bf in ("true", "1", "(bool)1")
    if "gru_cluster_kernel<" in name:
        return "forward", "bfloat16" in name
    return None


def phase_bf16_more(dev, card: str, rng, core: dict) -> tuple[list[dict], dict]:
    """Phase 14, second half: K6, K4f, K4b, K5f and K5b on bf16 streams.
    Returns the kernels line's entries of their bf16 instantiations, and the
    bf16 errors of each (largest share of the gap, max abs error) by the
    name of its f32 entry; sets ``core``'s launches on the three trainers'
    main paths."""
    import numpy as np
    import torch

    from tpu_slu_torch.models.flagship import TRAIN_CFG, UNIDIRECTIONAL, flagship_model, flagship_seq2seq_model
    from tpu_slu_torch.ops.bigru_gemm import tc_launches, zero_tc_launches
    from tpu_slu_torch.ops.bigru_masked import bigru_masked, bigru_masked_bwd
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.ops.gru1 import gru1, gru1_bwd
    from tpu_slu_torch.training import Trainer

    t_phase = time.perf_counter()
    # 14.6 the bf16 kernels against their plain versions: K6 at the five flagship layers (B = 16) and the
    # train intent layer (B = 64, unpooled); K4f at the served shape (B = 8, mixed lengths) and the seq2seq
    # encoder layer (B = 64, T = 25, D = 256), K4b at that layer; K5f and K5b at the unidirectional
    # flagship's five layers (B = 64); all on 4 s. The first set of each kernel is timed below
    s2s_name, s2s_D, s2s_T = S2S_LAYER
    served = []
    for _, d, n_parts, T, _ in FLAGSHIP_LAYERS:
        lengths = rng.integers(1, T + 1, SERVE_BATCH)
        lengths[0], lengths[-1] = T, 0
        served.append(lengths.tolist())
    plan = {
        "K6": ([(name, d * n, T, 16, {"n_parts": n, "pool": pool}) for name, d, n, T, pool in FLAGSHIP_LAYERS],
               [(f"{INTENT_SHAPE[0]} train", INTENT_SHAPE[1] * INTENT_SHAPE[2], INTENT_SHAPE[3], 64,
                 {"n_parts": INTENT_SHAPE[2]})]),
        "K4f": ([(name, d * n, T, SERVE_BATCH, {"lengths": m}) for (name, d, n, T, _), m in zip(FLAGSHIP_LAYERS, served)],
                [(s2s_name, s2s_D, s2s_T, 64, {})]),
        "K4b": ([(s2s_name, s2s_D, s2s_T, 64, {})], []),
        "K5f": ([(name, D, T, 64, {}) for name, D, T in UNI_SHAPES], []),
        "K5b": ([(name, D, T, 64, {}) for name, D, T in UNI_SHAPES], []),
    }
    held, errs = {k: [] for k in plan}, {}
    for k, (timed, extra) in plan.items():
        ratio, err = 0.0, 0.0
        for i, (name, D, T, B, kw) in enumerate(timed + extra):
            case = bf16_more_case(rng, dev, k, name, D, T, B, **kw)
            ratio, err = max(ratio, case["ratio"]), max(err, case["err"])
            if i < len(timed):
                held[k].append(case)
            else:
                del case["calls"]
            mixed = f", lengths {kw['lengths']}" if kw.get("lengths") else ""
            print(f"[bf16-{k.lower()}] {name:18s} D={D:3d} T={T:3d} B={B:2d}{mixed}: {case['ratio']:.3g} of the plain "
                  f"version's bf16-vs-f32 gap (limit {BF16_RATIO}), max abs err {case['err']:.3g}, within "
                  f"{BF16_ULPS:.4g} of the largest element")
        errs[k] = {"ratio": ratio, "err": err}
    print("[bf16] K6, K4f, K4b, K5f, K5b at bf16 against their plain versions: largest share of the gap "
          + ", ".join(f"{k} {v['ratio']:.3g}" for k, v in errs.items()) + "; max abs err "
          + ", ".join(f"{k} {v['err']:.3g}" for k, v in errs.items()))

    # 14.7 one bf16 train step against the CPU's: seq2seq (B = 64, U = S2S_U), unidirectional (B = 64),
    # the fixed-slot model on the row-stacked layout (B = 16)
    steps = {kind: bf16_step_vs_cpu(dev, rng, kind, B) for kind, B in
             (("seq2seq", 64), ("unidirectional", 64), ("rowstack", 16))}

    # 14.8 the main paths: Trainer.train and Trainer.test at compute_dtype=bfloat16 of the seq2seq,
    # the unidirectional and the row-stacked fixed-slot model, B = 64, each wrapper's counts set to 0
    # just before each and read just after
    counters = {"K1": bigru_shared, "K2": bigru_trainpool, "K3": bigru_shared_bwd, "K4f": bigru_masked,
                "K4b": bigru_masked_bwd, "K5f": gru1, "K5b": gru1_bwd}

    def zero():
        for c in counters.values():
            c.launches = c.launches_bf16 = 0
        bigru_shared.launches_rowstack = 0
        zero_tc_launches()

    def counts() -> dict:
        """(bf16 launches, all launches) of each kernel that launched; K1's
        and K6's bf16 launches share a counter, so a run takes one of them."""
        torch.cuda.synchronize()
        out = {k: (c.launches_bf16, c.launches) for k, c in counters.items()}
        if bigru_shared.launches_rowstack:
            if bigru_shared.launches:
                raise AssertionError("a bf16 run launched both K1 and K6")
            out["K6"] = (out.pop("K1")[0], bigru_shared.launches_rowstack)
        return {k: v for k, v in out.items() if v != (0, 0)}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_more_")
    trainers, main_launches = {}, {}
    try:
        kinds = {"seq2seq": flagship_seq2seq_model(dev, seed=1),
                 "unidirectional": flagship_model(dev, cfg=TRAIN_CFG, seed=1, **UNIDIRECTIONAL),
                 "rowstack": flagship_model(dev, cfg=TRAIN_CFG, seed=1)}
        kinds["rowstack"].pretrained_model.gru_layout = "rowstack"
        for kind, model in kinds.items():
            config = model.config
            config.folder, config.compute_dtype = os.path.join(tmp, kind), "bfloat16"
            trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
            B = config.training_batch_size
            data = Batches(s2s_batches(rng, 2, B, model.Sy_intent) if kind == "seq2seq"
                           else synthetic_batches(rng, 2, B, model.values_per_slot))
            n = len(data.loader)
            zero()
            _, loss = trainer.train(data)
            train_launches = counts()
            tc = tc_launches()
            if tc != 15 * n:  # every model here: 15 bf16 core launches a step (core_counts)
                raise AssertionError(f"bf16 {kind} Trainer.train over {n} steps: {tc} launches of the bf16 core, "
                                     f"want {15 * n}")
            core[f"launches_{kind}_train"] = tc
            zero()
            _, t_loss = trainer.test(data)
            test_launches = counts()
            want = {"seq2seq": ({"K2": (4 * n, 4 * n), "K3": (4 * n, 4 * n), "K4f": (n, n), "K4b": (n, n)},
                                {"K1": (4 * n, 4 * n), "K4f": (n, n)}),
                    "unidirectional": ({"K5f": (5 * n, 5 * n), "K5b": (5 * n, 5 * n)}, {"K5f": (5 * n, 5 * n)}),
                    "rowstack": ({"K6": (n, n), "K2": (4 * n, 4 * n), "K3": (5 * n, 5 * n)},
                                 {"K6": (5 * n, 5 * n)})}[kind]
            if (train_launches, test_launches) != want or not (np.isfinite(loss) and np.isfinite(t_loss)):
                raise AssertionError(f"bf16 {kind} Trainer over {n} batches: (bf16, all) launches train "
                                     f"{train_launches}, test {test_launches}, want {want}; losses {loss}, {t_loss}")
            print(f"[bf16-trainer] {kind} Trainer.train at compute_dtype=bfloat16, B={B}, 4 s, {n} steps: loss "
                  f"{loss:.4f}, (bf16, all) launches {train_launches}, the bf16 core {tc}; Trainer.test loss "
                  f"{t_loss:.4f}, launches {test_launches}")
            for k, (bf16_n, _) in train_launches.items():
                main_launches.setdefault(k, bf16_n)
            trainers[kind] = (trainer, data.loader[0])

        # 14.9 each warm step at bf16 beside its f32 twin, in turns f32, bf16, bf16, f32; the bf16 step's
        # trace holds as many bf16 recurrences (forward and chain) as the counters count, and no f32 one
        step_times = {}
        for kind, (t16, host_batch) in trainers.items():
            t32 = Trainer(t16.model, copy.copy(t16.model.config), generator=torch.Generator().manual_seed(7))
            t32.compute_dtype = None
            batch = t16._to_device(host_batch)
            times = {"f32": [], "bf16": []}
            for which in ("f32", "bf16", "bf16", "f32"):
                t = t32 if which == "f32" else t16
                times[which] += cuda_times(lambda: t.train_step(batch), reps=5, warmup=1)
            def counted():  # kernel_table makes one warm call before it traces its reps
                want = {"forward": sum(counters[k].launches_bf16 for k in ("K1", "K2", "K4f", "K5f")),
                        "chain": sum(counters[k].launches_bf16 for k in ("K3", "K4b", "K5b"))}
                return {k: v * 3 // 4 for k, v in want.items()}

            def check(table):
                want = counted()
                seen = {(r, b16): 0 for r in want for b16 in (True, False)}
                for key, (n, _) in table.items():
                    if recurrence_of(key):
                        seen[recurrence_of(key)] += round(3 * n)
                f32 = seen["forward", False] or seen["chain", False]
                # the bf16 core: each counted launch in the trace, in its mode, and no FMA product but dW
                bf16_n = {k: c.launches_bf16 for k, c in counters.items()}
                core_want = {m: v * 3 // 4 for m, v in core_counts(bf16_n).items()}
                core_seen = core_trace(table)
                if sum(core_counts(bf16_n).values()) != tc_launches():
                    return f"the bf16 core's count {tc_launches()} is not its kernels' launches' share", False
                if {r: seen[r, True] for r in want} == want and not f32 and core_seen == {**core_want, "fma": 0}:
                    return None
                return (f"recurrences (kind, bf16) {seen} over 3 steps, counted bf16 {want}; the bf16 core "
                        f"{core_seen}, counted {core_want}",
                        not f32 and all(seen[r, True] <= want[r] for r in want) and not core_seen["fma"]
                        and all(core_seen[m] <= core_want[m] for m in core_want))

            wall, table, traces = counted_trace(lambda: t16.train_step(batch), zero, check,
                                                f"bf16 {kind} step profile")
            want = counted()
            busy, n_launch = sum(ms for _, ms in table.values()), round(sum(n for n, _ in table.values()))
            wall32, table32 = kernel_table(lambda: t32.train_step(batch), reps=3)
            busy32, n32 = sum(ms for _, ms in table32.values()), round(sum(n for n, _ in table32.values()))
            st = step_times[kind] = {
                "bf16_ms": statistics.median(times["bf16"]), "f32_ms": statistics.median(times["f32"]),
                "bf16_busy_ms": busy, "bf16_idle_share": 1 - busy / wall, "bf16_launches": n_launch,
                "f32_busy_ms": busy32, "f32_idle_share": 1 - busy32 / wall32, "f32_launches": n32}
            print(f"[time] warm {kind} train step B={t16.model.config.training_batch_size} on 4 s, in turns f32, "
                  f"bf16, bf16, f32 (CUDA events, 5 a turn): bf16 median {st['bf16_ms']:.3f} ms, f32 "
                  f"{st['f32_ms']:.3f} ms; profiler: bf16 busy {busy:.3f} ms, idle share {st['bf16_idle_share']:.3f}, "
                  f"{n_launch} launches a step; f32 busy {busy32:.3f} ms, idle share {st['f32_idle_share']:.3f}, "
                  f"{n32} launches; the bf16 step's trace (of {traces} taken) holds {want} bf16 recurrences over 3 "
                  f"steps, as counted, and no f32 one, and the bf16 core as counted, with no FMA product but dW's, "
                  f"on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 14.10 each kernel's timed set at bf16 beside f32, in turns, with the bf16 plain version, cuDNN's bf16
    # nn.GRU and the bf16 bound (their device time by the profiler: tools/torch_cluster_ab.py --bf16)
    entries = []
    for k, cases in held.items():
        ms = {"bf16": 0.0, "f32": 0.0, "plain": 0.0, "lib": 0.0}
        work = [0.0, 0.0, 0.0]
        for case in cases:
            name, D, T, B = case["shape"]
            t = {"f32": [], "bf16": []}
            for which in ("f32", "bf16", "bf16", "f32"):
                t[which].append(cuda_ms(case["calls"][which], reps=10, warmup=1))
            p_ms = cuda_ms(case["calls"]["plain"], reps=1, warmup=0)
            lib = cudnn_gru_ms(D, T, B, 128, dev, **case["lib"])
            for key, v in (("bf16", statistics.median(t["bf16"])), ("f32", statistics.median(t["f32"])),
                           ("plain", p_ms), ("lib", lib)):
                ms[key] += v
            work = [a + b for a, b in zip(work, case["work"])]
            b_ms, b_by = bound_bf16(*case["work"])
            print(f"[time] {k} bf16 {name:11s} B={B} T={T:3d}: bf16 {statistics.median(t['bf16']):.4f} ms, f32 "
                  f"{statistics.median(t['f32']):.4f} ms (in turns), plain bf16 {p_ms:.3f} ms, cuDNN bf16 nn.GRU "
                  f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        b_ms, b_by = bound_bf16(*work)
        B = cases[0]["shape"][3]
        print(f"[time] {k} at bf16, {len(cases)} layer{'s' * (len(cases) > 1)} B={B}: kernel {ms['bf16']:.4f} ms beside "
              f"f32 {ms['f32']:.4f} ms (in turns, CUDA events around each call), plain bf16 {ms['plain']:.3f} ms, "
              f"cuDNN bf16 nn.GRU {ms['lib']:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {card}")
        source, replaces, name = BF16_MORE_SOURCES[k]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": main_launches[k], "max_abs_err": errs[k]["err"], "ms": ms["bf16"], "plain_ms": ms["plain"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": ms["lib"],
            "library_call": "cuDNN nn.GRU in bf16" + (", backward" if k.endswith("b") else "")
                            + (", one direction" if k.startswith("K5") else "") + ": the nearest call, not the "
                            "same rounding", "f32_ms": ms["f32"], "batch": B, "max_gap_ratio": errs[k]["ratio"]})
    entries[0].update({"step_ratio": {kind: v["ratio"] for kind, v in steps.items()},
                       "step_floor": {kind: v["floor"] for kind, v in steps.items()}, "steps": step_times})
    print(f"[bf16] phase 14's second half took {time.perf_counter() - t_phase:.1f} s")
    f32_names = {"K6": "bigru_shared_fwd_rs", "K4f": "bigru_masked_fwd", "K4b": "bigru_masked_bwd",
                 "K5f": "gru1_fwd", "K5b": "gru1_bwd"}
    return entries, {f32_names[k]: {"max_abs_err_bf16": v["err"], "max_gap_ratio_bf16": v["ratio"]}
                     for k, v in errs.items()}


# -- phase 15: model parallelism, a (data, model) grid of ranks with the vocab heads sharded --

MP = 2  # model_parallel of phase 15: the flagship's 42 phonemes and 10,000 words both divide it
MP_TEST_N = 2  # [mp-test]: batches of DP_B rows; a data index takes its rows of each
MP_TEST_RTOL = 1e-5  # [mp-test]: each of the four values against the one-process test


def mp_config(folder: str):
    """The ASR config of phase 15: ``no_unfreezing.cfg`` at ``pretraining_type``
    2 (its 10,000 words), 42 phonemes, dropout 0 (a data index's rows get
    other masks than the same rows of one batch)."""
    from tpu_slu_torch import read_config
    from tpu_slu_torch.models.flagship import FLAGSHIP_CFG

    config = read_config(FLAGSHIP_CFG, make_dirs=False)
    config.num_phonemes, config.pretraining_type, config.folder = 42, 2, folder
    for k, v in DP_NO_DROPOUT.items():
        setattr(config, k, v)
    return config


def mp_rows(batch: dict, grid) -> dict:
    """A data index's contiguous share of a host batch."""
    k = len(batch["w"]) // grid.data_size
    return {n: a[grid.data_index * k:(grid.data_index + 1) * k] for n, a in batch.items()}


def mp_rank(args_path: str) -> None:
    """One rank of phase 15 (``python3 chip_smoke.py --mp-rank ARGS``): gloo on
    the one card's CUDA tensors (NCCL refuses two ranks on one GPU), the ASR
    Trainer at ``model_parallel`` 2 from rank 0's weights. ``Trainer.test``
    on its data index's rows of the test batches (its K1 and K8 launches),
    then one step on its rows of the 64-row batch (its K2 and K3 launches;
    its values, the whole gradients and parameters, heads gathered), then
    the warm step timed twice (turns C, C of the phase's P, C, C, P) and
    traced (its wall, device busy time, launches and copies); the results go
    to ``<out>/rank<r>.pt``."""
    import datetime

    sys.path.insert(0, HERE)
    import torch

    from tpu_slu_torch import parallel
    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused
    from tpu_slu_torch.parallel.mesh import gather_rows
    from tpu_slu_torch.training import Trainer

    with open(args_path) as f:
        args = json.load(f)
    dev = parallel.init_from_env("cuda:0", backend="gloo", init_method="file://" + args["rdv"],
                                 timeout=datetime.timedelta(seconds=300))
    try:
        r = parallel.rank()
        inputs = torch.load(args["inputs"], weights_only=False)
        config = mp_config(os.path.join(args["out"], f"rank{r}"))
        config.model_parallel = MP
        model = PretrainedModel(config, generator=torch.Generator().manual_seed(10 + r)).to(dev)
        if r == 0:
            model.load_state_dict(inputs["state"])
        trainer = Trainer(model, config, generator=torch.Generator().manual_seed(7))
        g = trainer.grid
        out = {"grid": (g.data_index, g.model_index, g.data_size, g.model_parallel),
               "sharded": sorted(trainer.sharded)}

        bigru_shared.launches = sinc_frontend_fused.launches = 0
        test = Batches([mp_rows(b, g) for b in inputs["test"]])
        out["test"] = trainer.test(test)
        torch.cuda.synchronize()
        out["launches_test"] = {"K1": bigru_shared.launches, "K8": sinc_frontend_fused.launches}

        batch = mp_rows(inputs["batch"], g)
        totals = trainer.global_counts(trainer.counts(batch)) if g.data_size > 1 else None
        dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        bigru_trainpool.launches = bigru_shared_bwd.launches = 0
        values = trainer.train_step(dbatch, totals)
        torch.cuda.synchronize()
        out["launches_step"] = {"K2": bigru_trainpool.launches, "K3": bigru_shared_bwd.launches}
        out["values"] = [float(v) for v in values]
        out["grads"] = {n: None if p.grad is None else
                        (gather_rows(p.grad, g) if n in trainer.sharded else p.grad).detach().cpu()
                        for n, p in trainer.model.named_parameters()}
        out["params"] = {n: t.detach().cpu().clone() for n, t in trainer.full_state_dict().items()}
        out["rows"] = len(batch["w"])
        out["step_ms"] = [cuda_ms(lambda: trainer.train_step(dbatch, totals), reps=10, warmup=2) for _ in range(2)]
        wall, table = kernel_table(lambda: trainer.train_step(dbatch, totals), reps=5)
        out["profile"] = {"wall": wall, "busy": sum(ms for _, ms in table.values()),
                          "launches": sum(n for n, _ in table.values()),
                          "memcpy": sum(ms for k, (_, ms) in table.items() if "emcpy" in k)}
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_slu"))
        torch.save(out, os.path.join(args["out"], f"rank{r}.pt"))
        parallel.barrier()
    finally:
        parallel.destroy()


def phase_mp(dev, card: str, rng) -> dict:
    """Phase 15: ASR pre-training at ``model_parallel`` 2 on a 1x2 and a 2x2
    grid of ranks against one process. Returns, by kernel name, the launches
    of a rank's step and test batch."""
    import torch

    from tpu_slu_torch.models.encoder import PretrainedModel
    from tpu_slu_torch.ops.bigru_shared import bigru_shared, bigru_shared_bwd, bigru_trainpool
    from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused
    from tpu_slu_torch.training import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        # 15.0 [mp-kernels]: K1, K2 and K3 at the batches a rank gives them here (B = 64 and 32) at
        # the ASR encoder's four layer shapes on 2.25 s, against their plain versions
        errs = dict.fromkeys(("K1", "K2", "K3", "K3 rel"), 0.0)
        for B in (DP_B, DP_B // 2):
            for name, d, n_parts, T in asr_shapes():
                e = hold_gru_layer(rng, dev, name, d, n_parts, T, B)
                errs = {k: max(v, e[k]) for k, v in errs.items()}
        print(f"[mp-kernels] K1, K2 and K3 at B={DP_B} and {DP_B // 2}, the ASR encoder's four layers on "
              f"2.25 s: K1 and K2 within atol {ATOL} rtol {RTOL} (K2's zero pattern equal), max abs err K1 "
              f"{errs['K1']:.3g}, K2 {errs['K2']:.3g}; K3's dX, dW, db within {errs['K3 rel']:.3g} of each "
              f"largest (limit {GRAD_TOL}), max abs err {errs['K3']:.3g}")

        # 15.1 the inputs and the one-process references: the test pass first, then the step
        config = mp_config(os.path.join(tmp, "single"))
        model = PretrainedModel(config, generator=torch.Generator().manual_seed(1))
        shape = (ASR_T, 42, config.vocabulary_size, config.phone_downsample_factor, config.word_downsample_factor)
        inputs = {"state": model.state_dict(), "batch": asr_batches(rng, 1, DP_B, *shape)[0],
                  "test": asr_batches(rng, MP_TEST_N, DP_B, *shape)}
        inputs_path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, inputs_path)
        single = Trainer(model.to(dev), config, generator=torch.Generator().manual_seed(7))
        want_test = single.test(Batches(inputs["test"]))
        want = dp_step(single, inputs["batch"], dev)
        dbatch = {k: torch.from_numpy(v).to(dev) for k, v in inputs["batch"].items()}
        turns = {"P": [cuda_ms(lambda: single.train_step(dbatch), reps=10, warmup=2)]}

        launches = {}
        for world in (MP, 2 * MP):
            what = f"mp-{world // MP}x{MP}"
            out = os.path.join(tmp, what)
            os.makedirs(out)
            args = {"out": out, "rdv": os.path.join(out, "rendezvous"), "inputs": inputs_path}
            args_path = os.path.join(out, "args.json")
            with open(args_path, "w") as f:
                json.dump(args, f)
            t0 = time.perf_counter()
            ranks = wait_ranks(start_ranks("--mp-rank", args_path, world, out), out, what)
            took = time.perf_counter() - t0
            turns["P"].append(cuda_ms(lambda: single.train_step(dbatch), reps=10, warmup=2))
            turns[what] = [rk["step_ms"] for rk in ranks]

            # 15.2 [mp-1x2], [mp-2x2]: each rank's step against the one-process step, the ranks bit-equal
            D = world // MP
            grids = [rk["grid"] for rk in ranks]
            if grids != [(r // MP, r % MP, D, MP) for r in range(world)]:
                raise AssertionError(f"[{what}] grids {grids}")
            heads = {f"{h}.{n}" for h in ("phoneme_linear", "word_linear") for n in ("weight", "bias")}
            for rk in ranks:
                if set(rk["sharded"]) != heads or rk["launches_step"] != {"K2": 4, "K3": 4}:
                    raise AssertionError(f"[{what}] sharded {rk['sharded']}, step launches {rk['launches_step']}; "
                                         "want both heads and 4 K2, 4 K3")
                for key in ("grads", "params"):
                    for n, v in ranks[0][key].items():
                        if not (v is None and rk[key][n] is None or torch.equal(v, rk[key][n])):
                            raise AssertionError(f"[{what}] the ranks' {key} of {n} differ")
            g_err, p_err, unsettled = grads_close(ranks[0], want, config.pretraining_lr)
            # each data index's values are its shares of the global batch's
            shares = [sum(vals) for vals in zip(*(ranks[d * MP]["values"] for d in range(D)))]
            v_err = max(abs(x - y) for x, y in zip(shares, want["values"]))
            if not (g_err <= STEP_GRAD_TOL and p_err <= STEP_PARAM_ATOL and v_err <= STEP_LOSS_ATOL):
                raise AssertionError(f"[{what}] gradients {g_err:.3g} (limit {STEP_GRAD_TOL}), parameters "
                                     f"{p_err:.3g} (limit {STEP_PARAM_ATOL}), values {v_err:.3g} (limit "
                                     f"{STEP_LOSS_ATOL}) off the one-process step")
            print(f"[{what}] ASR pretraining_type 2, 2.25 s, no_unfreezing.cfg widths (42 phonemes, "
                  f"{config.vocabulary_size} words, both heads column-sharded over {MP}): {world} ranks on the one "
                  f"card over gloo on CUDA tensors (NCCL refuses two ranks on one GPU), a ({D}, {MP}) grid, "
                  f"{ranks[0]['rows']} of the {DP_B} rows a data index; the ranks' gradients and parameters "
                  f"(heads gathered) bit-equal; against the one-process B={DP_B} step every gradient within "
                  f"{g_err:.3g} of its tensor's largest element (limit {STEP_GRAD_TOL}), the parameters within "
                  f"{p_err:.3g} where the first Adam step's sign is settled (limit {STEP_PARAM_ATOL}; "
                  f"{unsettled} elements held to one step), the data indices' shares summing to the step's "
                  f"values within {v_err:.3g} (limit {STEP_LOSS_ATOL}); launches a rank's step "
                  f"{ranks[0]['launches_step']}; the ranks and their start took {took:.1f} s")

            # 15.3 [mp-test]: each rank's Trainer.test against the one-process test
            test_err = 0.0
            for rk in ranks:
                errs = [abs(g - w) for g, w in zip(rk["test"], want_test)]
                test_err = max(test_err, *errs)
                if not all(e <= MP_TEST_RTOL * abs(w) for e, w in zip(errs, want_test)):
                    raise AssertionError(f"[mp-test] {what}: {rk['test']} against {want_test}")
                if rk["launches_test"] != {"K1": 4 * MP_TEST_N, "K8": MP_TEST_N}:
                    raise AssertionError(f"[mp-test] {what}: launches {rk['launches_test']} over {MP_TEST_N} "
                                         "batches; want 4 K1 and 1 K8 a batch")
            print(f"[mp-test] {what}: Trainer.test on {MP_TEST_N} batches of {DP_B} rows, "
                  f"{DP_B // D} a data index: every rank's (phone_acc, phone_loss, word_acc, word_loss) "
                  f"{tuple(map(float, ranks[0]['test']))} against one process's {tuple(map(float, want_test))} "
                  f"within "
                  f"{test_err:.3g} (limit {MP_TEST_RTOL} relative); launches a rank {ranks[0]['launches_test']}")
            launches = {"step": ranks[0]["launches_step"], "test": ranks[0]["launches_test"]}
            prof = [rk["profile"] for rk in ranks]
            print(f"[profile] {what}: each rank's warm step (5 traced): wall "
                  + ", ".join(f"{q['wall']:.3f}" for q in prof) + " ms, device busy "
                  + ", ".join(f"{q['busy']:.4f}" for q in prof) + " ms (copies "
                  + ", ".join(f"{q['memcpy']:.4f}" for q in prof) + "), idle share "
                  + ", ".join(f"{1 - q['busy'] / q['wall']:.3f}" for q in prof)
                  + f", {prof[0]['launches']:.0f} device events a step; on {card}")
        print(f"[time] the warm ASR step at model_parallel {MP}, B={DP_B} on 2.25 s (median of 10, CUDA events) in "
              f"turns P, C, C, P: one process {', '.join(f'{t:.3f}' for t in turns['P'])} ms; each rank of the "
              + "; ".join(f"{w} grid (both its turns) " + ", ".join(f"[{a:.3f}, {b:.3f}]" for a, b in v)
                          for w, v in turns.items() if w != "P")
              + f" ms; the ranks share one card and reach each other through the host (gloo), so these are "
              f"not the times of a grid of GPUs; on {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"bigru_trainpool_fwd": {"launches_mp_step": launches["step"]["K2"]},
            "bigru_shared_bwd": {"launches_mp_step": launches["step"]["K3"]},
            "bigru_shared_fwd": {"launches_mp_test": launches["test"]["K1"] // MP_TEST_N},
            "sinc_frontend_fused": {"launches_mp_test": launches["test"]["K8"] // MP_TEST_N}}


def free_port() -> int:
    """A free TCP port on localhost, for the env:// rendezvous of a one-rank group."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "tpu_slu_torch")):
        raise SystemExit("chip_smoke.py: tpu_slu_torch/ is not beside this script; "
                         "run it from the root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is false; this runs only on a GPU")

    import torch.nn.functional as F

    from tpu_slu_torch import read_config
    from tpu_slu_torch.data.audio import read_wav
    from tpu_slu_torch.models.encoder import DEFAULT_FRONTEND, DEFAULT_GRU_LAYOUT
    from tpu_slu_torch.models.flagship import flagship_model
    from tpu_slu_torch.ops import _build
    from tpu_slu_torch.ops.bigru_shared import bigru_cluster_size, bigru_shared, bigru_shared_reference
    from tpu_slu_torch.ops.conv import conv1d
    from tpu_slu_torch.ops.frontend_fused import sinc_frontend_fused
    from tpu_slu_torch.ops.sinc import mel_init, sinc_filters
    from tpu_slu_torch.serving import load_trained_model

    # 1. environment
    dev = torch.device("cuda", 0)
    card = smi()
    print(f"[env] python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"[env] device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {card}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[env] nvcc: {nvcc}")
    print("[env] TF32 flags left at torch's defaults, as a user has them: the port runs its "
          "convs in cuDNN with TF32 off per call (checked below) and K1 in f32 CUDA code")

    # 2. build: the port's library, and the variants of the A/B and the trace beside it
    t0 = time.perf_counter()
    builds = {name: start_variant(name, *v) for name, v in VARIANTS.items()}
    lib_path = _build.build(verbose=True)
    _build.library()
    variants = {name: load_variant(name, *b) for name, b in builds.items()}
    print(f"[build] {os.path.relpath(lib_path, HERE)} and the variants {sorted(variants)} in "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. K1 against its plain version on the card
    rng = np.random.default_rng(0)
    max_err = 0.0
    n_cases = 0
    for n_parts, d in ((1, 60), (2, 128)):
        for T in (25, 21, 400):
            for B in (1, 16):
                for pool, method in ((1, "avg"), (2, "avg"), (2, "max")):
                    params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
                    before = bigru_shared.launches
                    h_f, h_b, pooled = bigru_shared(params, parts, pool=pool, pool_method=method)
                    torch.cuda.synchronize()
                    assert bigru_shared.launches == before + 1, "K1 launch counter did not advance"
                    assert pooled == (pool > 1)
                    r_f, r_b = bigru_shared_reference(params, parts, pool=pool, pool_method=method)
                    assert h_f.shape == r_f.shape == h_b.shape == r_b.shape, (h_f.shape, r_f.shape)
                    err = max((h_f - r_f).abs().max().item(), (h_b - r_b).abs().max().item())
                    rel = err / max(r_f.abs().max().item(), r_b.abs().max().item(), 1e-30)
                    max_err = max(max_err, err)
                    if not (torch.allclose(h_f, r_f, atol=ATOL, rtol=RTOL)
                            and torch.allclose(h_b, r_b, atol=ATOL, rtol=RTOL)):
                        raise AssertionError(
                            f"K1 disagrees with its plain version: parts={n_parts} D={n_parts * d} "
                            f"T={T} B={B} pool={pool}/{method}: max abs {err:.3g} rel {rel:.3g}")
                    n_cases += 1
                    print(f"[k1] parts={n_parts} D={n_parts * d:3d} T={T:3d} B={B:2d} "
                          f"pool={pool}/{method}: max abs err {err:.3g} (rel {rel:.3g})")
    print(f"[k1] {n_cases} cases within atol {ATOL} rtol {RTOL}; max abs err {max_err:.3g}")

    # the front end's convs are f32 on the card, whatever cudnn.allow_tf32 says
    b1, band = (torch.from_numpy(a) for a in mel_init(80, 16000))
    conv_cases = [("sinc 80x401/80", rng.standard_normal((16, 1, 4 * 16000)),
                   sinc_filters(b1, band, 401, 16000)[:, None, :].numpy(), 80, 200),
                  ("conv 60x80x5", rng.standard_normal((16, 80, 400)),
                   rng.uniform(-0.1, 0.1, (60, 80, 5)), 1, 2)]
    for name, xs, ws, stride, pad in conv_cases:
        xs, ws = torch.from_numpy(xs).float(), torch.from_numpy(ws).float()
        ref = F.conv1d(xs.double(), ws.double(), stride=stride, padding=pad)  # f64 on the CPU
        xd, wd = xs.to(dev), ws.to(dev)
        err = (conv1d(xd, wd, stride=stride, padding=pad).double().cpu() - ref).abs().max().item()
        lib_err = (F.conv1d(xd, wd, stride=stride, padding=pad).double().cpu() - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= CONV_RTOL * scale:
            raise AssertionError(f"{name}: port's conv1d on the card off the f64 reference by {err:.3g} "
                                 f"> {CONV_RTOL} x {scale:.3g}")
        print(f"[conv] {name}: port conv1d max abs err {err:.3g} vs f64 (limit {CONV_RTOL} x max "
              f"{scale:.3g}); F.conv1d at torch's TF32 default {lib_err:.3g}")
        # the gradients too: the port's conv1d, and torch.cudnn_convolution as it comes
        cot = torch.from_numpy(rng.standard_normal(tuple(ref.shape))).float()
        x64, w64 = xs.double().requires_grad_(), ws.double().requires_grad_()
        F.conv1d(x64, w64, stride=stride, padding=pad).backward(cot.double())
        errs = {}
        for how in ("port", "cudnn_convolution"):
            xg, wg = xd.clone().requires_grad_(), wd.clone().requires_grad_()
            if how == "port":
                out = conv1d(xg, wg, stride=stride, padding=pad)
            else:
                out = torch.cudnn_convolution(xg[:, :, None, :], wg[:, :, None, :], (0, pad), (1, stride),
                                              (1, 1), 1, False, False, False)[:, :, 0, :]
                if out.grad_fn is None:
                    raise AssertionError("torch.cudnn_convolution has no autograd formula here")
            out.backward(cot.to(dev))
            errs[how] = max(rel_err(g.grad.double().cpu(), r.grad) for g, r in ((xg, x64), (wg, w64)))
        if not errs["port"] <= CONV_RTOL:
            raise AssertionError(f"{name}: port's conv1d gradients off f64 by {errs['port']:.3g} of the "
                                 f"largest element > {CONV_RTOL}")
        print(f"[conv] {name}: input and weight gradients vs f64, of the largest element: port conv1d "
              f"{errs['port']:.3g} (limit {CONV_RTOL}); torch.cudnn_convolution(allow_tf32=False) at "
              f"torch's TF32 default {errs['cudnn_convolution']:.3g}")

    # 4. golden decode on the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        folder = os.path.join(tmp, "exp")
        with open(os.path.join(GOLDEN, "experiment.cfg.template")) as f:
            template = f.read()
        cfg_path = os.path.join(tmp, "exp.cfg")
        with open(cfg_path, "w") as f:
            f.write(template.replace("__GOLDEN_FOLDER__", folder))
        config = read_config(cfg_path)
        for name in ("model_state.npz", "vocab.json"):
            shutil.copyfile(os.path.join(GOLDEN, name), os.path.join(folder, "training", name))
        golden = load_trained_model(config, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(GOLDEN, "expected.json")) as f:
        expected = json.load(f)["expected"]
    enc = golden.pretrained_model
    for case in expected:
        wav, fs = read_wav(os.path.join(GOLDEN, case["wav"]))
        assert fs == 16000
        want = [case["action"], case["object"], case["location"]]
        for routes in (("composed", "split"), ("fused", "rowstack")):  # K1; K8 and K6
            enc.frontend, enc.gru_layout = routes
            before = sinc_frontend_fused.launches, bigru_shared.launches, bigru_shared.launches_rowstack
            decoded = golden.decode_intents(wav[None, :])[0]
            launched = tuple(a - b for a, b in zip(
                (sinc_frontend_fused.launches, bigru_shared.launches, bigru_shared.launches_rowstack), before))
            want_launches = (0, 5, 0) if routes[0] == "composed" else (1, 0, 5)
            if decoded != want or launched != want_launches:
                raise AssertionError(f"golden {case['wav']} through {routes}: decoded {decoded}, want {want}; "
                                     f"K8, K1, K6 launches {launched}, want {want_launches}")
            print(f"[golden] {case['wav']} through {routes[0]} / {routes[1]}: {decoded} exact, K8, K1, K6 "
                  f"launches +{launched}")
    enc.frontend, enc.gru_layout = DEFAULT_FRONTEND, DEFAULT_GRU_LAYOUT

    # 5. flagship slice at no_unfreezing.cfg widths, seeded random weights
    cpu_model = flagship_model("cpu")
    model = copy.deepcopy(cpu_model).to(dev)
    x = (0.1 * np.random.default_rng(1).standard_normal((16, 4 * 16000))).astype(np.float32)
    batches = {1: x[:1], 16: x}

    bigru_shared.launches = sinc_frontend_fused.launches = 0
    decoded = {B: model.decode_intents(xb) for B, xb in batches.items()}
    torch.cuda.synchronize()
    launches, k8_launches = bigru_shared.launches, sinc_frontend_fused.launches
    want_k8 = len(batches) if DEFAULT_FRONTEND == "fused" else 0
    if (launches, k8_launches) != (5 * len(batches), want_k8):
        raise AssertionError(f"flagship decode on the default route launched K1 {launches} and K8 {k8_launches} "
                             f"times, want {5 * len(batches)} and {want_k8}")
    vocab = model.Sy_intent
    for B, dec in decoded.items():
        assert len(dec) == B and all(len(d) == 3 for d in dec), dec
        assert all(v in vocab[s] for d in dec for s, v in zip(vocab, d)), dec
    print(f"[flagship] decode_intents B=1 -> {decoded[1]}; B=16 -> {len(decoded[16])} decodes; "
          f"K1 launches {launches}, K8 launches {k8_launches} (front end {DEFAULT_FRONTEND!r})")

    for B, xb in batches.items():
        logits, preds = model.predict_intents(xb)
        ref, ref_preds = cpu_model.predict_intents(xb)
        assert logits.shape == (B, 24) and torch.isfinite(logits).all()
        err = (logits.cpu() - ref).abs().max().item()
        if not err <= LOGIT_ATOL:
            raise AssertionError(f"flagship B={B}: card vs CPU logits max abs err {err:.3g} > {LOGIT_ATOL}")
        print(f"[flagship] B={B}: logits card vs CPU max abs err {err:.3g} (atol {LOGIT_ATOL}); "
              f"predictions equal: {bool((preds.cpu() == ref_preds).all())}")

    decode_ms = {}
    for B, xb in batches.items():
        xd = torch.from_numpy(xb).to(dev)
        decode_ms[B] = cuda_ms(lambda: model.predict_intents(xd), reps=30, warmup=5)
        print(f"[time] warm predict_intents B={B:2d}, 4 s audio: median {decode_ms[B]:.3f} ms "
              f"of 30 (CUDA events) on {card}")
    xd = torch.from_numpy(batches[16]).to(dev)
    profile_calls(lambda: model.predict_intents(xd), "fixed-slot predict_intents B=16, 4 s", card)

    # K1 alone at the five flagship layer shapes (input width, parts, T, pool)
    totals = {B: [0.0, 0.0, 0.0] for B in batches}  # kernel, plain, cuDNN nn.GRU
    k1_work = [0.0, 0.0]  # FLOPs and bytes at B = 16
    for B in batches:
        for name, d, n_parts, T, pool in FLAGSHIP_LAYERS:
            params, parts = k1_case(rng, n_parts, d, T, B, 128, dev)
            got = bigru_shared(params, parts, pool=pool)[:2]
            ref = bigru_shared_reference(params, parts, pool=pool)
            err = max((g - r).abs().max().item() for g, r in zip(got, ref))
            max_err = max(max_err, err)
            assert all(torch.allclose(g, r, atol=ATOL, rtol=RTOL) for g, r in zip(got, ref)), err
            k_ms, p_ms = in_turns(lambda: bigru_shared_reference(params, parts, pool=pool),
                                  lambda: bigru_shared(params, parts, pool=pool), rounds=3)
            D = n_parts * d
            lib_ms = cudnn_gru_ms(D, T, B, 128, dev)  # unpooled: cuDNN fuses no pool
            w = gru_fwd_work(T * B, D, 128, T * B * D, 2 * -(-T // pool) * B * 128)
            if B == 16:
                k1_work = [k1_work[0] + w[0], k1_work[1] + w[1]]
            for i, v in enumerate((k_ms, p_ms, lib_ms)):
                totals[B][i] += v
            print(f"[time] K1 {name:11s} B={B:2d} D={D:3d} T={T:3d} pool={pool}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.3f} ms, cuDNN nn.GRU {lib_ms:.4f} ms, bound {bound(*w)[0]:.4f} ms "
                  f"({bound(*w)[1]}), max abs err {err:.3g}")
        print(f"[time] K1 five flagship layers B={B:2d}: kernel {totals[B][0]:.4f} ms "
              f"({1e3 * totals[B][0] / K1_STEPS:.3f} us a step, clusters of {bigru_cluster_size(B)}), "
              f"plain {totals[B][1]:.3f} ms, cuDNN nn.GRU {totals[B][2]:.4f} ms on {card}")
    k1_bound, k1_by = bound(*k1_work)
    k1_ab = k1_cluster_ab(dev, card, rng, variants["k1_other_c"])

    # 6. flagship train step
    train_kernels, k1_train_launches = phase_train(dev, card, rng, variants["k2_other_c"], variants["k3_other_c"])

    # 7. length-exact decode and serving
    k4f = phase_serve(dev, card, rng, golden, expected, variants["k4f_other_c"])

    # 8. seq2seq decode and serving
    k7 = phase_seq2seq(dev, card, rng, variants["k7_trace"])

    # 9. seq2seq train step
    k4b = phase_s2s_train(dev, card, rng, variants["bwd_other_c"])

    # 10. unidirectional GRU layers: decode, serve and train
    uni = phase_uni(dev, card, rng, variants["bwd_other_c"])

    # 11. the exact-shape eval path's routes: K8 and K6
    routes = phase_routes(dev, card, rng, k8_launches)

    # 12. ASR pre-training, and on to a served model
    asr = phase_asr(dev, card, rng)

    # 13. data-parallel training and evaluation, and the first-epoch trace
    dp = phase_dp(dev, card, rng)

    # 14. compute_dtype=bfloat16: the bf16 GEMM core on the tensor cores; K1, K2 and K3 on bf16 streams,
    # then K6, K4f, K4b, K5f and K5b
    core = phase_bf16_core(dev, card, rng)
    bf16 = phase_bf16(dev, card, rng, core)
    bf16_more, bf16_errs = phase_bf16_more(dev, card, rng, core)

    # 15. model parallelism: a (data, model) grid of ranks, the vocab heads column-sharded
    mp = phase_mp(dev, card, rng)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_slu"))
    if loaded:
        raise AssertionError(f"the port loaded modules of JAX or of the JAX package: {loaded}")
    print(card)
    kernels = [{
        "name": "bigru_shared_fwd", "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": k1_train_launches, "launches_decode": launches, "max_abs_err": max_err,
        "ms": totals[16][0], "plain_ms": totals[16][1], "bound_ms": k1_bound, "bound_by": k1_by,
        "library_ms": totals[16][2], "us_per_step": 1e3 * totals[16][0] / K1_STEPS, "ms_b1": totals[1][0],
        "library_ms_b1": totals[1][2], "cluster_by_batch": {str(B): bigru_cluster_size(B) for B in (1, 16, 64)},
        "ab_cluster": k1_ab,
    }] + train_kernels + [k4f, k7, k4b] + uni + routes
    for entry in kernels:
        entry.update(asr.get(entry["name"], {}))
        entry.update(dp.get(entry["name"], {}))
        entry.update(mp.get(entry["name"], {}))
        entry.update(bf16_errs.get(entry["name"], {}))
    kernels += bf16 + bf16_more + [core]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(sys.argv[2])
    elif sys.argv[1:2] == ["--mp-rank"]:
        mp_rank(sys.argv[2])
    else:
        main()
