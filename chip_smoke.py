#!/usr/bin/env python3
"""Smoke test of zero_tpu_torch on one NVIDIA card: build the CUDA kernels,
hold them against their plain PyTorch versions, serve transformer-base
through ``python -m zero_tpu_torch.run --mode test`` (beam 4, then beam 1),
train it through ``python -m zero_tpu_torch.run --mode train``, train, serve
and score transformer_rpr (Shaw relative positions), transformer_rela (ReLA)
and transformer_aan (average attention) the same way, decode the test set
with an ensemble of transformer-base and transformer_rela (``--mode
ensemble``), train the deep config (configs/deep_transformer_fuse_l0drop.json:
20+6 layers, use_remat) as transformer_fuse, transformer_l0drop and
transformer_fixup and serve and score each, train, score and serve
transformer-base on sequences past 8192 tokens (the streaming-attention
kernels), train, serve and score the deep config with scan_layers,
transformer_moe, transformer_multilingual with ROBT
(configs/multilingual_robt_opus100.json) and transformer_clsr, decode an
ensemble of the last two, train, serve and score transformer_ibdecoder
(the pair beam search) and speech translation (transformer_afs on
configs/speech_afs_mustc.json, with CTC), train, serve and score the RNN
models rnnsearch, deepnmt and rnnsearch_deepatt and decode an ensemble of
two, check these paths against the CPU on small models, and run the host
side (the native tokeniser, forked tokeniser workers, the metric CLI).

  python3 chip_smoke.py                 # every phase (the smoke test)
  python3 chip_smoke.py --phases build,train_kernels   # a subset, no
                                        # summary lines
  python3 chip_smoke.py --phases build,kernels,long_kernels --package DIR
                                        # another checkout's decode kernels
                                        # (#10/#8; #9 in long_kernels), on
                                        # the same inputs

Phases (each prints one line or more; any failure raises and exits
non-zero):
  device     card name, power limit, TF32 off
  build      nvcc builds of csrc/{decode_attention,fused_attention,
             fused_attention_rpr,fused_ffn,streaming_attention}.cu (sm_90a),
             one process each, all at once; the ptxas register/shared-memory
             report and every kernel that spills registers; the count of
             tensor-core instructions (HGMMA, HMMA) in the SASS of the fused
             FFN, streaming, fused-attention and RPR libraries, whose wgmma
             (HGMMA) count must not be 0; the ptxas lines and spills of the
             tensor-core RPR forward (forward_tc under the Rpr policy)
  kernels    decode_attention (#10) and decode_pool_attention (#8, softmax
             and relu) at transformer-base beam-4 decode shapes (B=32
             sentences x beam 4, hidden 512, 8 heads, T = 64 + 50, every
             TIMES position), at long_train's serving shape (B=2, beam 4
             and beam 1, a full T=8192 cache: the split over positions) and
             at DECODE_CHECK_CASES (head depths 256, 12 and 40), fp32 and
             bf16, against their plain versions; device times (bf16 at
             both shapes, fp32 at the first) of kernel, plain version, and
             scaled_dot_product_attention as a yardstick, beside the
             memory bound and the splits taken
  train_kernels  fused_attention (forward, backward) at B=16, H=8, Dh=64:
             causal self-attention L=256, self-attention L=256 under a pad
             mask with an all-pad row, cross attention Lq=200 Lk=256 (both
             directions on the route forward_route picks: bf16 at Dh 64 the
             tensor-core #1 and #2, whose CUDA-core parents are timed on
             the same inputs as parent_ms; launch counts show which ran),
             checked also under the causal flag with an all-pad row (the
             fused mask rule: that row averages all Lk keys), at head
             depths 128, 32 and 80 on the tensor cores and 40 on the CUDA
             cores; and
             fused_ffn (forward, backward) at N=4096, 512->2048->512 (fp32
             and bf16) and N=12544, the train phase's largest stacked shape
             (bf16, the tensor-core kernels), checked also at N=54 and 72,
             64->128->64, and N=200, 48->80->48 (widths off the 128 x 128
             tiles); dropout 0 and 0.1, outputs and every gradient held
             against the plain versions; device times of kernel, plain
             version and a PyTorch yardstick (SDPA; F.linear/relu/F.linear)
             beside the bound; then tensor parallelism's launches, bf16
             at dropout 0.1: the tensor-core #1/#2 over heads 4-7 of 8
             (heads=(4, 8)) at the three shapes, #11/#12 over each half of
             the 2048 hidden columns (hidden=(offset, 2048)) at N=4096,
             output and gradients held against the plain versions on the
             same split and against the whole launch's heads or columns
             (the FFN halves' outputs and dx summed)
  serve      beam 4: random transformer-base weights from a seed saved
             through the port's saver, a synthetic 32768-token vocabulary
             and a 32-sentence test set; counts prove the decode went
             through decode_pool_attention and never a plain version
  serve      beam 1: the same through decode_attention
  reference  a small fp32 model decoded on the card (kernels) and on the
             CPU (plain versions): identical sequences, scores within 1e-4
  train      transformer-base (configs/transformer_base_wmt14.json: bf16,
             dropout 0.1, token_size 4096, update_cycle 4; at BASE_CUT's
             2+2 layers, as rpr_train, rela_train and aan_train, for the
             script's time) trained for
             TRAIN_STEPS steps on a synthetic corpus with both kernel flags
             on: ms/step, target tokens/s, loss and gnorm, model FLOPs and
             MFU; launch counts = 9 attention and 6 FFN forwards and
             backwards per microbatch (the attention the tensor-core #1
             and #2), no plain version; then the same
             steps with both flags off (the PyTorch composite), and
             --mode test and --mode score on the checkpoint the kernel run
             saved
  train_reference  a small fp32 model: train_fn loss and grads on the card
             (kernels) against the CPU (plain versions), dropout off,
             within 1e-4; dropout on, kernels against plain versions on
             the card from the same seed words, loss within 1e-5; the same
             model in bf16 (the tensor-core FFN kernels) against plain_ffn
             on the card, and (head depth 16: the tensor-core #1 and #2)
             against the plain attention on the card, dropout off and on:
             loss within 1e-2 relative, grads within 2e-2 of their scale
  converge   the copy task (a 12-word vocabulary, target = source;
             hidden 32, CONVERGE_STEPS steps, lr 3e-3) through --mode train
             with both flags on: final dev BLEU >= 0.95
  rpr_kernels  fused_attention's RPR variant (#3 forward, #4 backward) at
             the train_kernels shapes with max_relative_position 16, fp32
             and bf16, dropout 0 and 0.1: output and the five gradients (dq,
             dk, dv, dTk, dTv) held against fused_attention_rpr_ref, both
             directions on the route forward_route picks (bf16 at Dh 64: the
             tensor-core #3 and #4, launch counts show which ran); checked
             also (bf16) under the causal flag with an all-pad row at L=200,
             at head depths 128, 32, 80 (tensor cores) and 40 (CUDA cores),
             and at m=64 (129 buckets); device times of kernel, of the
             CUDA-core #3 and #4 on the same inputs (parent_ms), plain
             version, the composite the model runs with use_flash_attention
             off (_attn_core's one-hot form) and, as a floor, SDPA WITHOUT
             relative positions, beside the bound (the RPR terms counted);
             then #3/#4 over heads 4-7 of 8 at the causal shape, bf16 at
             dropout 0.1, against the plain version on the same heads and
             the whole launch's heads
  rpr_train  transformer_rpr (configs/transformer_rpr_rela.json at 2+2
             layers, 512/2048, 8 heads, m 16, bf16, token_size 4096,
             update_cycle 4) trained TRAIN_STEPS steps with
             use_flash_attention (and use_fused_ffn, which RPR ignores) on,
             then off: ms/step, tokens/s, MFU (RPR matmuls counted); RPR
             kernel launches = those the steps' own shapes predict (an
             attention over Lk > 2m keys; the tensor-core #3 and #4), no FFN
             kernel, no plain version;
             then --mode test (beam 4: the encoder runs the RPR forward
             kernel, the decoder no decode kernel, RPR keeps both off) and
             --mode score (the RPR forward kernel) of the checkpoint
  rpr_reference  a small fp32 transformer_rpr: train_fn loss and grads,
             tables included, card (kernels) against CPU (plain versions)
             within 1e-4; dropout on, kernels against plain versions on the
             card, loss within 1e-5; beam-4 decode card against CPU,
             identical sequences
  rela_train transformer_rela (configs/transformer_rpr_rela.json with
             model_name=transformer_rela: 2+2 layers, 512/2048, bf16,
             dropout 0.1) trained TRAIN_STEPS steps with
             use_flash_attention (and use_fused_ffn) on: ms/step, tokens/s,
             MFU; no kernel launch (ReLA keeps the composite attention and
             an unfused FFN, as in the JAX package); then --mode test at
             beam 4 (#8 in relu mode, once per decoder layer and step, no
             plain version), at beam 1 (no decode kernel: #10 has no relu
             mode) and --mode score (no kernel)
  rela_reference  a small fp32 transformer_rela: train_fn loss and grads
             card against CPU within 1e-4; beam 4 card (#8 relu) against
             CPU, identical sequences
  aan_train  transformer_aan (configs/transformer_aan_wmt14.json at 2+2,
             512/2048, bf16, dropout 0.1) trained TRAIN_STEPS steps with both
             kernel flags on (launches 3 each of #1/#2 and #11/#12 forwards
             and backwards per microbatch: the encoder; the AAN decoder's
             cross attention and FFN run the composite; no plain version),
             then off; then --mode test at beam 4 (the encoder's #1 and #11,
             no decode kernel: a running-sum cache) and --mode score
  aan_reference  a small fp32 transformer_aan: train_fn loss and grads card
             (the encoder's CUDA-core #1/#2, #11/#12) against CPU within
             1e-4; beam 4 card against CPU, identical sequences
  ensemble   --mode ensemble at beam 4 over the checkpoints train and
             rela_train saved (transformer-base and transformer_rela), on the
             32-sentence test set: #8 in softmax and in relu mode, once per
             decoder layer and step each; BLEU and sentences/s; then a small
             fp32 transformer + transformer_rela ensemble, card against CPU:
             identical sequences, scores within 1e-4
  deep_train configs/deep_transformer_fuse_l0drop.json (transformer_fuse;
             at DEEP_CUT's 2+3 layers, 20+6 as written, for the script's
             time; 512/2048, 8 heads,
             depth-scaled init, bf16, dropout 0.1, token_size 4096,
             update_cycle 4, use_remat) trained DEEP_STEPS steps with both
             kernel flags on: ms/step, tokens/s, MFU (model FLOPs: the
             recompute not counted), peak memory; launches per microbatch
             = 4 #1 and #11 (2 encoder layers, twice: the recompute), 2
             #2 and #12, the merged decoder none; then --mode test at beam
             4 (the encoder's #1 and #11, no decode kernel) and --mode
             score
  deep_memory  the same config MEMORY_STEPS steps each with use_remat off,
             then remat_policy nothing, dots and dots_all:
             torch.cuda.max_memory_allocated and the median step; launches
             checked (forwards twice a layer under remat)
  l0drop_train the same config as transformer_l0drop, DEEP_STEPS steps:
             launches per microbatch 28 #1, 14 #2, 16 #11, 8 #12; the
             expected-L0 penalty beside the loss; served at beam 4 (#8, 6
             a decode step) and beam 1 (#10), at l0_compact_ratio 0 and
             0.5, and scored; then one batch at those widths whose gates
             are forced closed on a row: finite loss and grads
  fixup_train the same widths as transformer_fixup, FIXUP_STEPS steps (no
             training kernel, as in the JAX package); --mode test at beam 4
             (#8) and --mode score (no kernel)
  deep_reference  small fp32 transformer_fuse, transformer_l0drop and
             transformer_fixup models with use_remat and dropout 0.1:
             train_fn loss (1e-5) and grads (1e-4) card against CPU on the
             same seed words; beam 4 card against CPU, identical
             sequences; in bf16 on the card (tensor-core kernels) the
             checkpointed run against the same layers without the
             checkpoint: grads within 1e-6 of their max (the gap printed)
  long_kernels  streaming attention (#5 forward, #6 dq, #7 dk/dv) against
             streaming_attention_ref at B*H=8, Lq=Lk=8320 causal; B=2, H=4,
             L=8320 under a pad mask with an all-pad row (whose dq and dk
             must be 0); cross Lq=256, Lk=16384; fp32 (the CUDA-core
             kernels) and bf16 (the tensor-core kernels; launch counts show
             which ran), dropout 0 and 0.1; in bf16 also lengths off the
             tensor-core tiles (causal 8259, cross 333 x 8259), head depths
             128, 32 and 80 (tensor cores) and 40, 256 (CUDA cores); device
             times of each kernel, of the CUDA-core #5, #6, #7 on the same
             inputs (what ran before, parent_ms), the plain version and
             SDPA (bf16) beside the bound; #5-#7 over heads 2-3 of 4 at
             the padded shape, bf16 at dropout 0.1, against the plain
             version on the same heads and the whole launch's heads; #5-#7
             as the ring's blocks (parallel/ring.py in threads of this
             process) over 2 and 4 blocks, fp32 and bf16, causal and
             padded, against the plain kernel-form ring at dropout 0.1 and
             the unsplit launch at 0; #1/#2 and #3/#4 over each half of
             the queries and #11/#12 over each half of a sequence's rows (bf16,
             dropout 0.1) against the whole launch's slice. And
             decode_cross_attention (#9, unwired as in the JAX package)
             against its plain version at B=32 beam 4 S=64 and B=4 beam 4
             S=16384, timed beside the composite of cross_attn_step and
             SDPA, and checked with a fully masked batch row (which
             averages all S positions) at 5 beams and at 1; fp32 and bf16
  long_train transformer-base (configs/transformer_base_wmt14.json at
             BASE_CUT's 2+2 with use_flash_attention and max_len/token_size
             16384, pad_seq_multiple 128; a constant learning rate 1e-3)
             trained LONG_STEPS steps on synthetic pairs of 8200-16000
             tokens a side, one pair per microbatch: ms/step, target
             tokens/s, MFU, peak memory; launches = 9 each of the
             tensor-core #5, #6 and #7 per microbatch, no CUDA-core kernel, no plain version; then
             --mode score and --mode test (beam 4) of the checkpoint on four
             long pairs at eval_batch_size 2: the tensor-core #5 in every
             forward, #8 in decoding
  long_reference  a small fp32 model with fa.MAX_LK lowered to 64 (so every
             attention streams): train_fn loss and grads card against CPU
             within 1e-4; dropout on, kernels against plain versions, loss
             within 1e-5; beam 4 card against CPU, identical sequences; then
             the model at head depth 64 (hidden 128, 2 heads) in bf16, the
             tensor-core #6/#7 against the plain version's backward on the
             card (the tensor-core forward #5 on both sides), dropout off
             and on: loss within 1e-2 relative, grads within 2e-2 of their
             scale
  scan_train configs/deep_transformer_fuse_l0drop.json as
             transformer_l0drop with scan_layers (each stack one module of
             [L, ...] tensors), both kernel flags on, SCAN_STEPS steps:
             ms/step, tokens/s, MFU, peak memory; launches per microbatch
             as unrolled (at DEEP_CUT's 2+3: 16 #1, 8 #2, 10 #11, 5
             #12); the stacked
             checkpoint restored in a fresh process (params, Adam state,
             EMA) equal to the file; --mode test at beam 4 (#8) and 1
             (#10), --mode score
  moe_train  configs/transformer_base_wmt14.json at 2+2 (MOE_EXTRA) as
             transformer_moe (8
             experts, top-1, capacity 1.25, einsum dispatch), both flags
             on, MOE_STEPS steps: no training kernel; moe_aux beside the
             loss, peak memory; MOE_TOP2_STEPS steps at top-2; one
             full-width fp32 batch through the einsum and the scatter
             dispatch, loss and grads within 1e-5 of their max (the gap
             printed); --mode test at beam 4 (#10), --mode score
  multilingual_train  configs/multilingual_robt_opus100.json (at
             ML_CUT's 1+1, 6+6 as written, for the script's time; 100
             languages, ROBT; the model computes in fp32 and ignores
             use_remat, as in the JAX package) plus both flags, ML_STEPS
             steps on tagged synthetic data (the 100 tags at ids 3-102):
             launches per microbatch 3 #1, 2 #2, 3 #11, 2 #12 (CUDA
             cores) and L_src - 1 #10 (ROBT's greedy decode); the
             main and back-translated losses, ms/step, peak memory; then
             ML_OFF_STEPS steps with robt=false (1 of each); --mode test at
             beam 4 on mixed tags (#10), --mode score
  clsr_train the multilingual config as transformer_clsr, robt=false,
             CLSR_STEPS steps: no training kernel; the budget loss, peak
             memory; --mode test at beam 4 (#10), --mode score; --mode
             ensemble of this checkpoint with multilingual_train's (#10 in
             both decoders)
  slice13_reference  small fp32 models card against CPU on the same seed
             words: scan_layers transformer and transformer_l0drop (use_remat),
             transformer_moe through both dispatches at top-1 and top-2,
             transformer_multilingual with ROBT (one intermediate language
             injected), transformer_clsr (one gate noise injected): loss
             within 1e-6 relative, grads within 1e-5 of their max,
             identical beam-4 sequences, exact launch counts; then the scan
             transformer in bf16 with use_remat against without: gap 0
  ib_train   configs/transformer_base_wmt14.json as transformer_ibdecoder
             (at BASE_CUT's 2+2, 6+6 as written; bf16, both kernel flags)
             IB_STEPS steps: ms/step,
             tokens/s, MFU (over the bf16 peak; the decoder computes in
             fp32, promoted by its fp32 positions as in the JAX package);
             launches per microbatch 3 tensor-core #1/#2 (encoder), 6
             CUDA-core #1/#2 (decoder self- and cross attention, the
             self-attention under the token-causal flag), 6 #11/#12;
             --mode test at beam 4 and 1 (the pair search: pair steps,
             sentences/s; the encoder's #1/#11, no decode kernel: the
             pair step attends over two positions) and --mode score
  speech_train  configs/speech_afs_mustc.json at 1+1+1 (6+6+6 as
             written, for the script's time; bf16,
             AFS tf, coarse CTC, use_flash_attention, the fused FFN off)
             SPEECH_STEPS steps on a synthetic corpus the phase writes
             (SPEECH_UTTERANCES .npy utterances of 300-2048 frames, 80
             mels; 32 16 kHz .wav files to serve, so read_wav and logmel
             run): loss, CTC term, AFS penalty, ms/step, target tokens/s
             and raw frames/s, MFU, peak memory; launches 8 tensor-core
             #1 and #2 a microbatch; --mode test at beam 4 and 1 at
             l0_compact_ratio 0.3 (the share of frames compacted away;
             the encoders' #1 and 2 #10 a decode step, the cross attention
             on the composite), --mode score (6 #1 a batch), --mode
             ensemble of the checkpoint with itself; then
             SPEECH_CONTEXT_STEPS steps with st_context (10 #1/#2)
  slice14_reference  small fp32 models card against CPU on the same seed
             words: transformer_ibdecoder with the kernel flags off and
             on; transformer_afs in modes tf (st_context) and t with
             coarse CTC and compaction at decode, one gate noise injected,
             and a noise that closes every gate of one row; loss within
             1e-6 relative, grads within 1e-5 of their max, identical
             beam-4 sequences, exact launch counts; the CTC port alone on
             an infeasible row (3 frames, 4 labels)
  rnn_train  rnnsearch at the default config's RNN widths (cell atr, the
             CAEncoder, hidden 1000, embed 620, 8 heads) with
             default_dtype=bfloat16 (the model computes in fp32, as in the
             JAX package), dropout 0.1, token_size 4096, update_cycle 4,
             both kernel flags on (ignored), RNN_STEPS steps: ms/step,
             target tokens/s, MFU over the fp32 peak (rnn_flops: matmul
             FLOPs at each step's stacked shape), peak memory; no launch of
             #1-#12 in training, --mode test at beam 4 and 1 and --mode
             score; then the CUDA launches of a microbatch at 4 x 8 x 8 and
             4 x 16 x 16 (torch.profiler), their slope a time step, and
             the dtypes computed in (fp32 only)
  deepnmt_train  deepnmt the same way, served at beam 4 (cell lstm, no
             CAEncoder, use_deep_att, layer_norm: the per-input LayerNorm
             runs; 2+2 layers, 6+6 by default, for the script's time);
             then --mode ensemble at beam 4 of rnn_train's and this
             checkpoint
  deepatt_train  rnnsearch_deepatt as deepnmt_train (cell gru; 2 encoder
             stacks and 2 decoder stages, 6+6 by default)
  rnn_reference  small fp32 models of the three (RNN_REFERENCE: all six
             cells, the CAEncoder on and off, use_deep_att, layer_norm,
             embed_size != hidden_size) with dropout 0.1, card against CPU
             on the same seed words: loss within 1e-6 relative, grads
             within 1e-5 of their max, identical beam-4 sequences, no
             kernel launch
  host       the native tokeniser (g++ into zero_tpu_torch/_build/) with
             HOST_WORKERS threads, the python path and process_num=
             HOST_WORKERS forked workers (train.py's dataset) over the
             8000-pair training corpus: identical ids, tokens/s of each,
             the native counter +1 exactly where the native path ran; the
             metric CLI (OTEM, UTEM, BLEU; detokenized BLEU) and the chrF
             script on rnn_train's beam-4 output
  dp_train   data parallelism across processes (zero_tpu_torch/parallel/):
             configs/transformer_base_wmt14.json at BASE_CUT's 2+2 (bf16,
             both kernel flags, dropout 0.1, update_cycle 4) DP_STEPS
             steps through --mode train, first as a world of one over NCCL
             (dist_coordinator=127.0.0.1:<port>: the gradient all-reduce
             runs), then as two ranks sharing the card, each a subprocess
             with its own gloo group (NCCL refuses two ranks on one
             device): ms/step, global target tokens/s, peak memory, the
             all-reduce's ms and bytes a step, the launches of #1/#2/#11/
             #12 per rank (checked as in train), a checksum of every
             rank's parameters (equal) and the dev BLEU of the final
             data-sharded eval on every rank (equal). Two gloo ranks on
             one card measure correctness, not NCCL bandwidth
  dp_reference  a small fp32 model on the card, kernels on: two gloo ranks
             (an all-pad row on one: unequal valid rows) against one
             process on the concatenated global batch, dropout off and on
             (the global-row draws): loss within 1e-6 relative, the summed
             grads and the parameters after one Adam step within 1e-5 of
             their max; then #1-#7 and #11/#12 (fp32 and bf16, both
             routes) against their plain versions at a row base of 3
             (rows 3-6 of a global batch of 8), dropout 0.1
  zero_train ZeRO (zero_stage 1, 2, 3) in the same two gloo ranks, one
             stage after another: dp_train's run with the EMA on, each
             stage's ms/step, every rank's bytes of parameters, moments
             and EMA against stage 0's (the moments and EMA from stage 1,
             the parameters at stage 3 at most ZERO_SHARE of them), peak
             memory, reduce-scatter and all-gather ms and bytes a step,
             the launches of #1/#2/#11/#12 a rank (checked as in train),
             equal checksums and BLEU on the ranks, the parameter
             checksums and step losses within ZERO_SAME of dp_train's;
             stage 3 writes the sharded checkpoint (sharded_checkpoint
             auto: a shard file a rank and the meta), a restart resumes
             from it reading each rank's own slices, and --mode test
             decodes it on one card (beam 4, #8)
  zero_reference  the small fp32 model, kernels on, dropout 0 and 0.1, EMA
             on: stages 1-3 on two ranks against stage 0 on two ranks,
             losses of two Adam steps within 1e-6 relative, moments,
             parameters and EMA after them within 1e-5 of their max
  moe_dp     transformer_moe as moe_train runs it (2+2, 8 experts), fp32,
             dropout 0.1: two gloo ranks (the all-pad row on one) against
             one process on the global batch, dp_reference's tolerances
             (the load-balance statistics and the expert FFN's dropout
             over the global batch)
  tp_train   tensor parallelism (mesh_model=2: mesh data 1 x model 2) in
             the same two gloo ranks: dp_train's run with the EMA on, each
             rank over its 4 heads and 1024 hidden columns (#1/#2/#11/#12
             launches a rank checked as in train), every rank's bytes of
             parameters, moments and EMA at most TP_SHARE of the whole
             state's, the model line's all-reduces a step (calls, bytes,
             ms), equal checksums and BLEU on the ranks (the dev eval on
             gathered weights), each step's loss within TP_SAME of
             dp_train's world of one (the same batches and seeds)
  tp_reference  the small fp32 transformer and transformer_rpr (the
             CUDA-core #1-#4 and #11/#12), dropout 0.1, at mesh_model=2 on
             the two ranks against one process (the group out of reach):
             loss within 1e-6 relative, each rank's part of the gradient
             and of the parameters after one Adam step within 1e-5 of
             their max; a kernel that dropped its head or column offset
             would draw another part's dropout masks
  ep_train   transformer_moe as moe_train runs it (fp32, dropout 0.1) at
             mesh_expert=2, 4 experts a rank, against one process: the
             same tolerances, the expert line's all-reduces counted
  sp_train   sequence parallelism (mesh_seq=2: mesh data 1 x seq 2):
             long_train's pairs (SP_CUT: 2+2, 2 microbatches a step; bf16,
             both kernel flags, attention dropout 0, the others 0.1)
             LONG_STEPS steps, first as a world of one in this process,
             then in the two gloo ranks, each on its block of every
             sequence: ms/step, tokens/s, peak memory a rank against the
             world of one's, the ring's shifts and the encoder's gather a
             step (calls, bytes, ms), the launches of #5-#7 (the ring's
             blocks: a causal ring skips those above the diagonal; the
             cross attention past 8192 keys) and #11/#12 a rank
             (sp_expected_launches), each step's loss within SP_SAME of
             the world of one's
  sp_reference  the small fp32 transformer (the CUDA-core #5-#7 as ring
             blocks, #1/#2 over a rank's queries, #11/#12 over its rows),
             transformer_rpr (plain ring blocks; the CUDA-core #3/#4 over
             a rank's queries in its cross-attention) and transformer_rela
             (plain ring blocks),
             attention dropout 0, relu and residual dropout 0.1, at
             mesh_seq=2 against one process: loss within 1e-6 relative,
             the gradients summed over the line and the parameters after
             one Adam step within 1e-5 of their max
Then the `kernels` JSON line, the script's total seconds, the nvidia-smi
name/power-limit line, and as the last line {"ok": true, "device": {...}}.
"""

import argparse
import collections
import contextlib
import functools
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "transformer_base_wmt14.json")
RPR_CONFIG = os.path.join(REPO, "configs", "transformer_rpr_rela.json")
SEED = 1234

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# transformer-base beam-4 decode shapes of the serve phase's longest batch
B, K, HIDDEN, HEADS, T = 32, 4, 512, 8, 64 + 50
TIMES = (0, 1, 57, T - 1)
# long_train's serving shape (--mode test at eval_batch_size 2; beam 4 for
# #8, beam 1 for #10) at a full 8192-position cache, where the split over
# positions takes effect; checked in fp32 and bf16, timed in bf16
LONG_DECODE_B, LONG_DECODE_T = 2, 8192
# checked, not timed: (B, beams, T, hidden, heads, time): Dh 256 (32 lanes
# of 16 bytes in bf16, two 16-byte loads a lane in fp32) and Dh 12 (24-byte
# bf16 slices take one element a load, 48-byte fp32 ones 16-byte loads),
# both split; Dh 40 (lane groups with idle lanes) at its last and first
# position
DECODE_CHECK_CASES = ((2, 4, 1100, 512, 2, 1099), (3, 1, 700, 48, 4, 650),
                      (2, 4, 40, 80, 2, 39), (2, 4, 40, 80, 2, 0))
# |kernel - plain| <= ATOL + RTOL * max|plain|. fp32: summation order only.
# bf16: the plain version rounds logits and weights to bf16 before the
# products (as the JAX package does); the kernel keeps them fp32.
TOLERANCE = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}
# training kernels: fp32 sums run in another order over up to 4096 rows
# (dW, dk/dv), so the relative part is 1e-4; bf16 as above
TRAIN_TOLERANCE = {torch.float32: (1e-5, 1e-4),
                   torch.bfloat16: (1e-2, 2e-2)}
TRAIN_STEPS = 2
# the test set that every serving, scoring and ensemble run decodes, one
# batch at eval_batch_size 32 (64 sentences, two batches, before the
# data-parallel phases came)
TEST_SENTENCES = 32
# the earlier phases run at a cut depth (the script's time budget):
# transformer-base's at 2+2 (6+6 as written, 3+3 until sequence
# parallelism came; IBDecoder too, MoE at 2+2), config 4's at 2+3 (20+6;
# scan_layers too; 2+6 until the multilingual config's tensor-parallel
# phase came), the multilingual config's at 1+1, config 5's at 1+1+1; the
# RNN phases at the default config's widths
BASE_CUT = ",num_encoder_layer=2,num_decoder_layer=2"
DEEP_CUT = ",num_encoder_layer=2,num_decoder_layer=3"
PEAK_BF16 = 989e12   # H100 SXM dense bf16, the MFU denominator
# the card spins this many cycles before each timed run (~0.25 s), so the
# host enqueues the whole run first and events time device work only
SLEEP_CYCLES = 500_000_000
L2_BYTES = 50 * 2 ** 20


def overrides(extra):
    """A ``--parameters`` string's values, parsed as the config parses
    them (numbers and booleans as JSON, the rest as strings)."""
    out = {}
    for kv in extra.split(","):
        if kv:
            key, value = kv.split("=", 1)
            try:
                out[key] = json.loads(value)
            except ValueError:
                out[key] = value
    return out


_STARTED = time.time()


def phase(label, **fields):
    """One phase line; ``at_s`` is the seconds since the script started
    (where the script's time goes)."""
    fields["at_s"] = round(time.time() - _STARTED, 1)
    print("phase %-9s %s" % (label, json.dumps(fields)), flush=True)


def device_ms(fn, arg_sets, iters):
    """Device time of one call, averaged over ``iters`` back-to-back calls
    that rotate through ``arg_sets`` (together larger than L2, so every
    call reads its inputs from device memory, as a decode step does)."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    enqueue_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    if enqueue_s * 1e3 > lead_ms():
        print("warning: host enqueue (%.1f ms) outlasted the lead (%.1f ms); "
              "%s times include host gaps" % (enqueue_s * 1e3, lead_ms(),
                                              fn.__name__))
    return ms


@functools.lru_cache(maxsize=None)
def lead_ms():
    """Device time of the spin that leads each timed run."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def copies(make, set_bytes):
    n = max(2, min(64, math.ceil(4 * L2_BYTES / set_bytes)))
    return [make() for _ in range(n)]


def bound(nbytes, flops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def tensor_core_sass(lib):
    """Counts of the tensor-core instructions in a built library's SASS
    (``cuobjdump -sass``): HGMMA (wgmma) and HMMA (mma.sync); None where the
    toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(r"\b%s\b" % op, sass))
            for op in ("HGMMA", "HMMA")}


def check(name, out, ref, dtype, tolerance=TOLERANCE):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    atol, rtol = tolerance[dtype]
    if not (math.isfinite(err) and err <= atol + rtol * scale):
        raise AssertionError("%s %s: max |kernel - plain| %.3g > %.3g + "
                             "%.3g * %.3g" % (name, dtype, err, atol, rtol,
                                              scale))
    return err


def dense_inputs(gen, dtype, b, t, hidden):
    """Random q [B, 1, hidden] and k, v [B, T, hidden] of #10 on the card."""
    return tuple(torch.randn(shape, generator=gen).to("cuda", dtype)
                 for shape in ((b, 1, hidden), (b, t, hidden),
                               (b, t, hidden)))


def pool_inputs(gen, dtype, b, beams, t, hidden):
    """Random q [B, beams, hidden] and pools k, v [B, beams, T, hidden] of
    #8 on the card, and a maker of ancestry rows [B, beams, T] whose column
    ``time`` is the identity."""
    qkv = tuple(torch.randn(shape, generator=gen).to("cuda", dtype)
                for shape in ((b, beams, hidden), (b, beams, t, hidden),
                              (b, beams, t, hidden)))

    def anc_at(time_):
        anc = torch.randint(0, beams, (b, beams, t), generator=gen,
                            dtype=torch.int32)
        anc[:, :, time_] = torch.arange(beams, dtype=torch.int32)
        return anc.to("cuda")

    return qkv, anc_at


def decode_checks(da, gen, dtype, b, beams, t, hidden, heads, times):
    """#10 and, at beams > 1, #8 (softmax and relu) against their plain
    versions at each position in ``times``; returns the largest error of
    each kernel."""
    dense = dense_inputs(gen, dtype, b, t, hidden)
    pool, anc_at = pool_inputs(gen, dtype, b, beams, t, hidden)
    errs = collections.defaultdict(float)
    for time_ in times:
        label = "decode_attention[B%d,T%d,hidden%d,heads%d,time%d]" % (
            b, t, hidden, heads, time_)
        errs["decode_attention"] = max(errs["decode_attention"], check(
            label, da.decode_attention(*dense, time_, heads),
            da.decode_attention_ref(*dense, time_, heads), dtype))
        if beams == 1:
            continue
        anc = anc_at(time_)
        for relu, key in ((False, "decode_pool_attention"),
                          (True, "decode_pool_attention[relu]")):
            errs[key] = max(errs[key], check(
                "%s[B%d,beams%d,T%d,hidden%d,heads%d,time%d]" % (
                    key, b, beams, t, hidden, heads, time_),
                da.decode_pool_attention(*pool, anc, time_, heads,
                                         relu=relu),
                da.decode_pool_attention_ref(*pool, anc, time_, heads,
                                             relu=relu), dtype))
    return dict(errs)


def decode_times(da, gen, dtype, b, beams, t, hidden, heads, errs):
    """Device times of #10 (B rows) and #8 (B x beams, softmax and relu) at
    the cache's last position, of their plain versions and of SDPA (over
    the ancestry-gathered cache for #8, gathered beforehand), beside the
    byte bound and the splits the wrapper launched."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dh = hidden // heads
    eb = torch.tensor([], dtype=dtype).element_size()
    time_ = t - 1
    n = time_ + 1
    # the splits the wrapper recorded at its last launch; null where the
    # package records none (the parent commit under --package)
    taken = getattr(da, "taken", {})

    def timed(key, fn, sets):
        taken.clear()
        ms = device_ms(fn, sets, 3 * len(sets))
        return ms, taken.get(key)

    rows = {}

    def heads_of(x, length):
        return x.view(x.shape[0], -1, heads, dh)[:, :length].transpose(1, 2)

    dense = copies(lambda: dense_inputs(gen, dtype, b, t, hidden),
                   2 * b * t * hidden * eb)

    def k_dense(q, k, v):
        return da.decode_attention(q, k, v, time_, heads)

    def p_dense(q, k, v):
        return da.decode_attention_ref(q, k, v, time_, heads)

    def l_dense(q, k, v):
        return sdpa(heads_of(q, 1), heads_of(k, n), heads_of(v, n))

    nbytes = (2 * b * n * hidden + 2 * b * hidden) * eb
    b_ms, b_by = bound(nbytes, 4 * b * n * hidden, dtype)
    ms, splits = timed("decode_attention", k_dense, dense)
    rows["decode_attention"] = dict(
        max_abs_err=errs["decode_attention"], ms=ms,
        plain_ms=device_ms(p_dense, dense, 3 * len(dense)),
        library_ms=device_ms(l_dense, dense, 3 * len(dense)),
        bound_ms=b_ms, bound_by=b_by, splits=splits)
    del dense

    def pool_set():
        qkv, anc_at = pool_inputs(gen, dtype, b, beams, t, hidden)
        return qkv + (anc_at(time_),)

    pool = copies(pool_set, 2 * b * beams * t * hidden * eb)
    for relu, key in ((False, "decode_pool_attention"),
                      (True, "decode_pool_attention[relu]")):
        def k_pool(q, k, v, anc, relu=relu):
            return da.decode_pool_attention(q, k, v, anc, time_, heads,
                                            relu=relu)

        def p_pool(q, k, v, anc, relu=relu):
            return da.decode_pool_attention_ref(q, k, v, anc, time_, heads,
                                                relu=relu)

        # bytes: each DISTINCT selected pool row once (beams that share an
        # ancestor share its K/V), q, out and the ancestry entries
        anc = pool[0][3][:, :, :n].long()
        distinct = torch.zeros(b, beams, n, device="cuda").scatter_(
            1, anc, 1.0).sum().item()
        nbytes = (2 * distinct * hidden + 2 * b * beams * hidden) * eb \
            + 4 * b * beams * n
        b_ms, b_by = bound(nbytes, 4 * b * beams * n * hidden, dtype)
        lib_ms = None
        if not relu:
            gathered = [
                (heads_of(q.view(b * beams, 1, hidden), 1),
                 heads_of(torch.take_along_dim(
                     k, a.long()[..., None], dim=1).view(
                         b * beams, t, hidden), n),
                 heads_of(torch.take_along_dim(
                     v, a.long()[..., None], dim=1).view(
                         b * beams, t, hidden), n))
                for q, k, v, a in pool]
            lib_ms = device_ms(sdpa, gathered, 3 * len(gathered))
            del gathered
        ms, splits = timed("decode_pool_attention", k_pool, pool)
        rows[key] = dict(
            max_abs_err=errs[key], ms=ms,
            plain_ms=device_ms(p_pool, pool, 3 * len(pool)),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, splits=splits)
    del pool
    torch.cuda.empty_cache()
    return rows


def kernels_phase(da):
    """#10 and #8 at the decode shapes of serving (every TIMES entry, timed
    at the last) and of long_train's serving (a full 8192-position cache,
    split), and at DECODE_CHECK_CASES; fp32 and bf16, against their plain
    versions. Returns the rows keyed (kernel, dtype) and (kernel, "long")
    (bf16)."""
    gen = torch.Generator().manual_seed(SEED)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        errs = decode_checks(da, gen, dtype, B, K, T, HIDDEN, HEADS, TIMES)
        for key, r in decode_times(da, gen, dtype, B, K, T, HIDDEN, HEADS,
                                   errs).items():
            rows[(key, dtype)] = r
            phase("kernels", kernel=key, dtype=name, time=T - 1, **r)
        long_t = LONG_DECODE_T
        errs = decode_checks(da, gen, dtype, LONG_DECODE_B, K, long_t,
                             HIDDEN, HEADS, (long_t - 1,))
        if dtype == torch.bfloat16:
            for key, r in decode_times(da, gen, dtype, LONG_DECODE_B, K,
                                       long_t, HIDDEN, HEADS, errs).items():
                if r["splits"] is not None and r["splits"] < 2:
                    raise AssertionError("%s at T=%d launched %d split"
                                         % (key, long_t, r["splits"]))
                rows[(key, "long")] = r
                phase("kernels", kernel=key, dtype=name, case="B%d_T%d" % (
                    LONG_DECODE_B, long_t), time=long_t - 1, **r)
        else:
            phase("kernels", case="B%d_T%d" % (LONG_DECODE_B, long_t),
                  dtype=name, max_abs_err=errs)
        for case in DECODE_CHECK_CASES:
            b, beams, t, hidden, heads, time_ = case
            phase("kernels", dtype=name, case="B%d_beams%d_T%d_hidden%d_"
                  "heads%d_time%d" % case, max_abs_err=decode_checks(
                      da, gen, dtype, b, beams, t, hidden, heads, (time_,)))
        torch.cuda.empty_cache()
    return rows


def write_corpus(d):
    """A 32768-token vocabulary and a 32-sentence test set of 20 to 60
    tokens, made from SEED; returns the vocabulary's words."""
    rs = np.random.RandomState(SEED)
    words = ["w%d" % i for i in range(32768 - 3)]   # + pad, unk, eos
    with open(os.path.join(d, "vocab.txt"), "w") as w:
        w.write("\n".join(words) + "\n")
    for name in ("test.src", "test.tgt"):
        with open(os.path.join(d, name), "w") as w:
            for _ in range(TEST_SENTENCES):
                n = rs.randint(20, 61)
                w.write(" ".join(words[i] for i in rs.randint(0, len(words),
                                                              n)) + "\n")
    return words


def serve_phase(da, d, beam, kernel):
    """run.main --mode test over the saved weights; returns the launch
    count of ``kernel``."""
    from zero_tpu_torch import run
    from zero_tpu_torch.config import load_config_file

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "output_dir={0}/model,test_output={0}/trans{1}.txt,"
            "eval_batch_size=32,beam_size={1}".format(d, beam))
    da.launches.clear()
    t0 = time.time()
    summary = run.main(["--mode", "test", "--config", CONFIG,
                        "--parameters", spec])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(da.launches)
    with open(os.path.join(d, "trans%d.txt" % beam)) as r:
        lines = r.read().splitlines()
    layers = load_config_file(CONFIG)["num_decoder_layer"]
    if len(lines) != TEST_SENTENCES or summary["sentences"] != TEST_SENTENCES:
        raise AssertionError("served %d lines" % len(lines))
    if launches.get(kernel, 0) != layers * summary["steps"]:
        raise AssertionError("%s launched %s times, expected %d layers x %d "
                             "steps" % (kernel, launches.get(kernel),
                                        layers, summary["steps"]))
    plain = {n: c for n, c in launches.items() if n.endswith("_ref") and c}
    other = {n: c for n, c in launches.items()
             if not n.endswith("_ref") and n != kernel and c}
    if plain or other:
        raise AssertionError("unexpected calls during serving: %s"
                             % {**plain, **other})
    phase("serve", beam=beam, sentences=summary["sentences"],
          target_tokens=summary["target_tokens"],
          decode_steps=summary["steps"], decode_s=summary["seconds"],
          sentences_per_s=summary["sentences"] / summary["seconds"],
          target_tokens_per_s=summary["target_tokens"] / summary["seconds"],
          wall_s=wall, launches=launches, bleu=summary["bleu"])
    return launches[kernel]


def reference_phase(da):
    """A small fp32 model: beam search on the card (CUDA kernels) equals
    beam search on the CPU (plain versions)."""
    import copy

    from zero_tpu_torch.config import default_config
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.search import beam_search
    from zero_tpu_torch.vocab import Vocab

    cfg = default_config()
    for k, v in dict(model_name="transformer", hidden_size=64, embed_size=64,
                     filter_size=128, num_heads=4, num_encoder_layer=2,
                     num_decoder_layer=2, decode_length=10,
                     initializer="uniform_unit_scaling",
                     initializer_gain=1.0).items():
        setattr(cfg, k, v)
    vocab = Vocab()
    for i in range(40):
        vocab.insert("w%d" % i)
    cfg.src_vocab = cfg.tgt_vocab = vocab
    model = get_model("transformer")
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).to("cuda")
    rs = np.random.RandomState(SEED)
    src = rs.randint(3, 43, (6, 12))
    for i, n in enumerate(rs.randint(3, 12, 6)):
        src[i, n:] = 0
    src[-1] = 0   # an all-pad row
    out = {}
    for beam, kernel in ((4, "decode_pool_attention"), (1, "decode_attention")):
        cfg.beam_size = beam
        inf = model.infer_fn(cfg)
        da.launches.clear()
        with torch.inference_mode():
            g = beam_search(gpu, torch.as_tensor(src).cuda(), inf, cfg)
            c = beam_search(cpu, torch.as_tensor(src), inf, cfg)
        same = torch.equal(g["seq"].cpu(), c["seq"])
        err = (g["score"].cpu() - c["score"]).abs().max().item()
        if not (same and err <= 1e-4 and da.launches[kernel] > 0
                and torch.isfinite(g["score"]).all()):
            raise AssertionError("beam %d: card vs CPU sequences equal %s, "
                                 "score err %.3g, %s launches %d"
                                 % (beam, same, err, kernel,
                                    da.launches[kernel]))
        out["beam%d" % beam] = dict(same_sequences=same, max_score_err=err,
                                    steps=g["steps"])
    phase("reference", **out)


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

# (name, B, H, Lq, Lk, Dh, causal, pad mask with an all-pad row); the
# small cases (train_reference's model shapes: ragged tails, Dh 16) are
# checked, not timed
ATTN_CASES = (("self_causal", 16, 8, 256, 256, 64, True, False),
              ("self_pad", 16, 8, 256, 256, 64, False, True),
              ("cross", 16, 8, 200, 256, 64, False, True))
ATTN_SMALL = (("small_causal", 6, 4, 9, 9, 16, True, False),
              ("small_pad", 6, 4, 12, 12, 16, False, True),
              ("small_cross", 6, 4, 9, 12, 16, False, True))
# checked, not timed: the causal flag with an all-pad row, where the fused
# mask rule gives that row uniform weights over all Lk keys (the tensor-core
# dk/dv must reach the query tiles above the diagonal), on 64-row tiles
# that end ragged; the other head depths the tensor-core backward takes;
# and a depth it does not take, where bf16 keeps the CUDA-core #1 and #2
# (forward_route)
ATTN_CHECK_CASES = (("causal_pad_200", 4, 2, 200, 200, 64, True, True),
                    ("dh128_causal_pad_136", 2, 2, 136, 136, 128, True,
                     True),
                    ("dh32_cross_72x200", 2, 2, 72, 200, 32, False, True),
                    ("dh80_causal_pad_136", 2, 2, 136, 136, 80, True, True),
                    ("dh40_pad_136", 2, 1, 136, 136, 40, False, True))
FFN_SHAPE = (4096, 512, 2048, 512)
# the train phase's largest stacked microbatch (112 x 112 tokens), timed in
# bf16 only
FFN_LARGE = (12544, 512, 2048, 512)
# checked, not timed: train_reference's model shapes (ragged N), and widths
# that are not a multiple of the tensor-core kernels' 128 x 128 tiles
FFN_SMALL = ((54, 64, 128, 64), (72, 64, 128, 64), (200, 48, 80, 48))
SEED_WORDS = (0x12345678, 0x9ABCDEF0)


def grad_ms(outputs, inputs, dout):
    """A callable timing one backward pass alone (autograd.grad over a
    retained forward graph)."""
    def run():
        return torch.autograd.grad(outputs, inputs, dout, retain_graph=True)
    return run


def fwd_bwd(fn, n_inputs):
    """fn's forward and backward together, over a set whose first
    ``n_inputs`` tensors take gradients and whose last is the output
    gradient."""
    def run(*s):
        return torch.autograd.grad(fn(*s), s[:n_inputs], s[-1])
    run.__name__ = fn.__name__ + "_fwd_bwd"
    return run


def attention_pairs(pad, h, lq, causal):
    """The (row, key) pairs whose weights the output needs: the valid keys
    of each row, all Lk for a row with no valid key; over B and H."""
    b, lk = pad.shape
    keep = (pad > 0)[:, None, None, :].expand(b, 1, lq, lk)
    if causal:
        keep = keep & torch.ones(lq, lk, dtype=torch.bool,
                                 device=pad.device).tril()
    return torch.where(keep.any(-1, keepdim=True), keep,
                       True).sum().item() * h


def attention_pad(gen, b, lk, padded):
    """[B, Lk] key pad mask: random lengths, the last of several rows all
    padding; or all valid."""
    if not padded:
        return torch.ones(b, lk)
    lens = torch.randint(lk // 4, lk + 1, (b,), generator=gen)
    pad = (torch.arange(lk)[None] < lens[:, None]).float()
    if b > 1:
        pad[-1] = 0.0   # an all-pad batch row
    return pad


def train_attention_rows(fa, gen):
    """Kernels #1/#2 against fused_attention_ref, on the route
    forward_route picks; returns the JSON rows of the timed cases."""
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, b, h, lq, lk, dh, causal, padded in ATTN_CASES + ATTN_SMALL \
            + ATTN_CHECK_CASES:
        timed = name in [c[0] for c in ATTN_CASES]
        for dtype in (torch.float32, torch.bfloat16):
            def inputs():
                q = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                k = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                v = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
                pad = attention_pad(gen, b, lk, padded)
                do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
                return [t.requires_grad_() for t in (q, k, v)] + [
                    pad.to(dev), do]

            # bound: the keys each row's output needs (all Lk for a row
            # with no valid key) in the forward's two products
            pairs = attention_pairs(inputs()[3], h, lq, causal)
            eb = torch.tensor([], dtype=dtype).element_size()
            fwd_bytes = (2 * b * h * lq * dh + 2 * b * h * lk * dh) * eb \
                + 4 * b * lk
            bwd_bytes = (4 * b * h * lq * dh + 4 * b * h * lk * dh) * eb \
                + 4 * b * lk + 8 * b * h * lq
            for rate in (0.0, 0.1):
                q, k, v, pad, do = inputs()
                words = SEED_WORDS if rate else None
                fa.launches.clear()
                out = fa.fused_attention(q, k, v, pad, causal=causal,
                                         dropout_rate=rate, rng=words)
                grads = torch.autograd.grad(out, (q, k, v), do)
                tc = fa.forward_route(dtype, dh) == "tensor_cores"
                sfx = "_tc" if tc else ""
                want = {"fused_attention" + sfx: 1,
                        "fused_attention_backward" + sfx: 1}
                if dict(fa.launches) != want:
                    raise AssertionError("fused_attention %s %s: launches "
                                         "%s, expected %s" % (
                                             name, dtype, dict(fa.launches),
                                             want))
                ref = fa.fused_attention_ref(q, k, v, pad, causal, rate,
                                             words)
                rgrads = torch.autograd.grad(ref, (q, k, v), do)
                label = "%s[%s,p=%g]" % (name, str(dtype)[6:], rate)
                errs = [check("fused_attention " + label, out, ref, dtype,
                              TRAIN_TOLERANCE)]
                errs += [check("fused_attention_backward %s d%s" % (label, w),
                               g, r, dtype, TRAIN_TOLERANCE)
                         for w, g, r in zip("qkv", grads, rgrads)]
                if not torch.isfinite(out).all():
                    raise AssertionError("fused_attention %s: non-finite "
                                         "output" % label)
                if padded and b > 1 and (grads[0][-1].any()
                                         or grads[1][-1].any()):
                    raise AssertionError("fused_attention %s: the all-pad "
                                         "batch row has nonzero dq or dk"
                                         % label)
                if padded and b > 1 and rate == 0.0:
                    # the fused rule: the all-pad batch row averages all Lk
                    # keys, under the causal flag too
                    check("fused_attention %s all-pad row" % label, out[-1],
                          v[-1].float().mean(dim=-2, keepdim=True).expand(
                              h, lq, dh), dtype, TRAIN_TOLERANCE)
                if not timed:
                    phase("train_kernels", kernel="fused_attention",
                          case=label, max_abs_err=errs[0],
                          backward_max_abs_err=max(errs[1:]),
                          kernels=sorted(want))
                    continue
                sets = copies(inputs, fwd_bytes)

                def k_fwd(q, k, v, pad, do):
                    return fa.fused_attention(q, k, v, pad, causal=causal,
                                              dropout_rate=rate, rng=words)

                def p_fwd(q, k, v, pad, do):
                    return fa.fused_attention_ref(q, k, v, pad, causal, rate,
                                                  words)

                def l_fwd(q, k, v, pad, do):
                    if causal:
                        return sdpa(q, k, v, is_causal=True)
                    return sdpa(q, k, v, attn_mask=(pad > 0)[:, None, None])

                iters = 2 * len(sets)
                fwd = dict(ms=device_ms(k_fwd, sets, iters),
                           plain_ms=device_ms(p_fwd, sets, iters))
                bwd = {}
                for key, fn in (("ms", k_fwd), ("plain_ms", p_fwd)):
                    graphs = [(grad_ms(fn(*s), s[:3], s[4]),) for s in sets]
                    bwd[key] = device_ms(lambda run: run(), graphs, iters)
                    del graphs
                if tc:
                    # the CUDA-core #1 and #2 that ran before the tensor-core
                    # ones, on the same inputs (called directly: the
                    # tensor-core kernels' device time is the same either
                    # way)
                    drop = (causal, rate, sa.kernel_words(words, q.shape,
                                                          rate))
                    fwd["parent_ms"] = device_ms(
                        fa._forward, [tuple(t.detach() for t in s[:3])
                                      + (s[3],) + drop for s in sets], iters)
                    args = []
                    for s in sets:
                        qkv = tuple(t.detach() for t in s[:3])
                        o, m, l = fa._forward(*qkv, s[3], *drop)
                        args.append(qkv + (s[3], o, s[4], m, l) + drop)
                    bwd["parent_ms"] = device_ms(fa._backward, args, iters)
                    del args
                if rate == 0.0:
                    fwd["library_ms"] = device_ms(l_fwd, sets, iters)
                    graphs = [(grad_ms(l_fwd(*s), s[:3], s[4]),)
                              for s in sets]
                    bwd["library_ms"] = device_ms(lambda run: run(), graphs,
                                                  iters)
                    del graphs
                    bwd["fwd_bwd_ms"] = device_ms(fwd_bwd(k_fwd, 3), sets,
                                                  iters)
                    bwd["library_fwd_bwd_ms"] = device_ms(
                        fwd_bwd(l_fwd, 3), sets, iters)
                fb, fby = bound(fwd_bytes, 4 * pairs * dh, dtype)
                bb, bby = bound(bwd_bytes, 10 * pairs * dh, dtype)
                fwd.update(bound_ms=fb, bound_by=fby, max_abs_err=errs[0])
                bwd.update(bound_ms=bb, bound_by=bby,
                           max_abs_err=max(errs[1:]))
                phase("train_kernels", kernel="fused_attention", case=label,
                      **fwd)
                phase("train_kernels", kernel="fused_attention_backward",
                      case=label, **bwd)
                rows[("fused_attention", name, dtype, rate)] = fwd
                rows[("fused_attention_backward", name, dtype, rate)] = bwd
                del sets
                torch.cuda.empty_cache()
    return rows


def train_ffn_rows(ff, gen):
    """Kernels #11/#12 against fused_ffn_ref; returns the rows, keyed by
    (kernel, N, dtype, rate)."""
    dev = "cuda"
    rows = {}
    for (n, d_in, f, d_out), dtype in [
            (shape, dtype) for shape in FFN_SMALL + (FFN_SHAPE,)
            for dtype in (torch.float32, torch.bfloat16)] + [
                (FFN_LARGE, torch.bfloat16)]:
        timed = (n, d_in, f, d_out) in (FFN_SHAPE, FFN_LARGE)

        def inputs():
            x = torch.randn(n, d_in, generator=gen).to(dev, dtype)
            w1 = (torch.randn(d_in, f, generator=gen) * d_in ** -0.5).to(
                dev, dtype)
            b1 = (torch.randn(f, generator=gen) * 0.1).to(dev, dtype)
            w2 = (torch.randn(f, d_out, generator=gen) * f ** -0.5).to(
                dev, dtype)
            b2 = (torch.randn(d_out, generator=gen) * 0.1).to(dev, dtype)
            dy = torch.randn(n, d_out, generator=gen).to(dev, dtype)
            return [t.requires_grad_() for t in (x, w1, b1, w2, b2)] + [dy]

        eb = torch.tensor([], dtype=dtype).element_size()
        weights = d_in * f + f + f * d_out + d_out
        fwd_bytes = (n * d_in + weights + n * d_out) * eb
        bwd_bytes = (n * d_in + weights + n * d_out) * eb \
            + (n * d_in + weights) * eb
        fwd_flops = 2 * n * (d_in * f + f * d_out)
        bwd_flops = 2 * n * (3 * d_in * f + 2 * f * d_out)
        for rate in (0.0, 0.1):
            words = SEED_WORDS if rate else None
            x, w1, b1, w2, b2, dy = inputs()
            out = ff.fused_ffn(x, w1, b1, w2, b2, words, rate)
            grads = torch.autograd.grad(out, (x, w1, b1, w2, b2), dy)
            ref = ff.fused_ffn_ref(x, w1, b1, w2, b2, words, rate)
            rgrads = torch.autograd.grad(ref, (x, w1, b1, w2, b2), dy)
            label = "N%d_%d_%d_%d[%s,p=%g]" % (n, d_in, f, d_out,
                                                str(dtype)[6:], rate)
            errs = [check("fused_ffn " + label, out, ref, dtype,
                          TRAIN_TOLERANCE)]
            errs += [check("fused_ffn_backward %s d%s" % (label, w), g, r,
                           dtype, TRAIN_TOLERANCE)
                     for w, g, r in zip(("x", "W1", "b1", "W2", "b2"), grads,
                                        rgrads)]
            if not timed:
                phase("train_kernels", kernel="fused_ffn", case=label,
                      max_abs_err=errs[0], backward_max_abs_err=max(errs[1:]))
                continue
            sets = copies(inputs, fwd_bytes)

            def k_fwd(x, w1, b1, w2, b2, dy):
                return ff.fused_ffn(x, w1, b1, w2, b2, words, rate)

            def p_fwd(x, w1, b1, w2, b2, dy):
                return ff.fused_ffn_ref(x, w1, b1, w2, b2, words, rate)

            iters = 2 * len(sets)
            fwd = dict(ms=device_ms(k_fwd, sets, iters),
                       plain_ms=device_ms(p_fwd, sets, iters))
            bwd = {}
            for key, fn in (("ms", k_fwd), ("plain_ms", p_fwd)):
                graphs = [(grad_ms(fn(*s), s[:5], s[5]),) for s in sets]
                bwd[key] = device_ms(lambda run: run(), graphs, iters)
                del graphs
            if rate == 0.0:
                # yardstick: F.linear / relu / F.linear on [out, in] weights
                lsets = [[t.detach().t().contiguous().requires_grad_()
                          if t.dim() == 2 and i in (1, 3)
                          else t for i, t in enumerate(s)] for s in sets]

                def l_fwd(x, w1t, b1, w2t, b2, dy):
                    lin = torch.nn.functional.linear
                    return lin(torch.relu(lin(x, w1t, b1)), w2t, b2)

                fwd["library_ms"] = device_ms(l_fwd, lsets, iters)
                graphs = [(grad_ms(l_fwd(*s), s[:5], s[5]),) for s in lsets]
                bwd["library_ms"] = device_ms(lambda run: run(), graphs,
                                              iters)
                bwd["fwd_bwd_ms"] = device_ms(fwd_bwd(k_fwd, 5), sets, iters)
                bwd["library_fwd_bwd_ms"] = device_ms(fwd_bwd(l_fwd, 5),
                                                      lsets, iters)
                del graphs, lsets
            fb, fby = bound(fwd_bytes, fwd_flops, dtype)
            bb, bby = bound(bwd_bytes, bwd_flops, dtype)
            fwd.update(bound_ms=fb, bound_by=fby, max_abs_err=errs[0])
            bwd.update(bound_ms=bb, bound_by=bby, max_abs_err=max(errs[1:]))
            phase("train_kernels", kernel="fused_ffn", case=label, **fwd)
            phase("train_kernels", kernel="fused_ffn_backward", case=label,
                  **bwd)
            rows[("fused_ffn", n, dtype, rate)] = fwd
            rows[("fused_ffn_backward", n, dtype, rate)] = bwd
            del sets
            torch.cuda.empty_cache()
    return rows


# tensor parallelism's launches (tp_train's, at the train shapes; bf16,
# dropout on): the second half of the 8 heads, and of the 2048 hidden
# columns, whose dropout rows and indices are the whole layer's
SPLIT_RATE = 0.1
SPLIT_HEADS = (4, 8)
SPLIT_HIDDEN = 1024


def check_head_split(where, kernel, name, launch, plain, q, k, v, do,
                     shared, heads, want, counter):
    """``launch(q, k, v, heads)`` over the heads [offset, H) of q, k, v
    [B, H, L, Dh] with ``heads`` = (offset, H), as tensor parallelism
    launches the wrapper on a process's heads: its output and its
    gradients of q, k, v and the ``shared`` (unsplit) inputs held against
    ``plain`` on the same heads, and its output and dq, dk, dv against
    the same heads of the launch over all H heads (``heads`` None), each
    at TRAIN_TOLERANCE. Counts the launches in ``counter`` against
    ``want``."""
    offset = heads[0]
    whole = launch(q, k, v, None)
    wgrads = torch.autograd.grad(whole, (q, k, v), do)
    part = [t.detach()[:, offset:].contiguous().requires_grad_()
            for t in (q, k, v)]
    pdo = do[:, offset:].contiguous()
    leaves = part + list(shared)
    counter.clear()
    out = launch(*part, heads)
    grads = torch.autograd.grad(out, leaves, pdo)
    if dict(counter) != want:
        raise AssertionError("%s over heads %s: launches %s, expected %s"
                             % (kernel, heads, dict(counter), want))
    ref = plain(*part, heads)
    rgrads = torch.autograd.grad(ref, leaves, pdo)
    label = "%s_heads_%d-%d_of_%d[%s,p=%g]" % (
        name, offset, q.shape[1] - 1, heads[1],
        str(q.dtype)[6:], SPLIT_RATE)
    names = ["q", "k", "v"] + ["_shared%d" % i for i in range(len(shared))]
    dtype = q.dtype
    errs = [check("%s %s" % (kernel, label), out, ref, dtype,
                  TRAIN_TOLERANCE)]
    errs += [check("%s_backward %s d%s" % (kernel, label, w), g, r, dtype,
                   TRAIN_TOLERANCE)
             for w, g, r in zip(names, grads, rgrads)]
    whole_errs = [check("%s %s against the whole launch" % (kernel, label),
                        out, whole[:, offset:], dtype, TRAIN_TOLERANCE)]
    whole_errs += [check("%s_backward %s d%s against the whole launch"
                         % (kernel, label, w), g, r[:, offset:], dtype,
                         TRAIN_TOLERANCE)
                   for w, g, r in zip("qkv", grads, wgrads)]
    phase(where, kernel=kernel, case=label, max_abs_err=errs[0],
          backward_max_abs_err=max(errs[1:]),
          whole_max_abs_err=max(whole_errs), kernels=sorted(want))


def train_split_checks(fa, ff, gen):
    """#1/#2 over SPLIT_HEADS at ATTN_CASES (the tensor-core kernels in
    bf16), and #11/#12 over each half of FFN_SHAPE's hidden width, with
    dropout on: the kernels' head and column offsets."""
    dev, dtype, rate = "cuda", torch.bfloat16, SPLIT_RATE
    for name, b, h, lq, lk, dh, causal, padded in ATTN_CASES:
        q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(
            dev, dtype).requires_grad_() for n in (lq, lk, lk))
        do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
        pad = attention_pad(gen, b, lk, padded).to(dev)

        def launch(q, k, v, heads):
            return fa.fused_attention(q, k, v, pad, causal=causal,
                                      dropout_rate=rate, rng=SEED_WORDS,
                                      heads=heads)

        def plain(q, k, v, heads):
            return fa.fused_attention_ref(q, k, v, pad, causal, rate,
                                          SEED_WORDS, heads)

        check_head_split("train_kernels", "fused_attention", name, launch,
                         plain, q, k, v, do, (), SPLIT_HEADS,
                         {"fused_attention_tc": 1,
                          "fused_attention_backward_tc": 1}, fa.launches)
    n, d_in, f, d_out = FFN_SHAPE
    x = torch.randn(n, d_in, generator=gen).to(dev, dtype)
    w1 = (torch.randn(d_in, f, generator=gen) * d_in ** -0.5).to(dev, dtype)
    b1 = (torch.randn(f, generator=gen) * 0.1).to(dev, dtype)
    w2 = (torch.randn(f, d_out, generator=gen) * f ** -0.5).to(dev, dtype)
    b2 = (torch.randn(d_out, generator=gen) * 0.1).to(dev, dtype)
    dy = torch.randn(n, d_out, generator=gen).to(dev, dtype)
    leaves = [t.requires_grad_() for t in (x, w1, b1, w2, b2)]
    whole = ff.fused_ffn(*leaves, SEED_WORDS, rate)
    wgrads = torch.autograd.grad(whole, leaves, dy)
    outs, dxs = [], []
    for lo in (0, SPLIT_HIDDEN):
        cols = slice(lo, lo + SPLIT_HIDDEN)
        # the output bias once, as ops/nn.py:ffn adds it after the reduce
        part = [t.detach().contiguous().requires_grad_() for t in (
            x, w1[:, cols], b1[cols], w2[cols],
            b2 if lo == 0 else torch.zeros_like(b2))]
        hidden = (lo, f)
        ff.launches.clear()
        out = ff.fused_ffn(*part, SEED_WORDS, rate, hidden=hidden)
        grads = torch.autograd.grad(out, part, dy)
        if dict(ff.launches) != {"fused_ffn": 1, "fused_ffn_backward": 1}:
            raise AssertionError("fused_ffn over hidden %s: launches %s"
                                 % (hidden, dict(ff.launches)))
        ref = ff.fused_ffn_ref(*part, SEED_WORDS, rate, hidden)
        rgrads = torch.autograd.grad(ref, part, dy)
        label = "N%d_hidden_%d-%d_of_%d[bfloat16,p=%g]" % (
            n, lo, lo + SPLIT_HIDDEN - 1, f, rate)
        errs = [check("fused_ffn " + label, out, ref, dtype,
                      TRAIN_TOLERANCE)]
        errs += [check("fused_ffn_backward %s d%s" % (label, w), g, r,
                       dtype, TRAIN_TOLERANCE)
                 for w, g, r in zip(("x", "W1", "b1", "W2", "b2"), grads,
                                    rgrads)]
        # the slice's own gradients are the whole launch's columns
        whole_errs = [check("fused_ffn_backward %s d%s against the whole "
                            "launch" % (label, w), g, r, dtype,
                            TRAIN_TOLERANCE)
                      for w, g, r in (("W1", grads[1], wgrads[1][:, cols]),
                                      ("b1", grads[2], wgrads[2][cols]),
                                      ("W2", grads[3], wgrads[3][cols]))]
        phase("train_kernels", kernel="fused_ffn", case=label,
              max_abs_err=errs[0], backward_max_abs_err=max(errs[1:]),
              whole_max_abs_err=max(whole_errs),
              kernels=sorted(ff.launches))
        outs.append(out.float())
        dxs.append(grads[0].float())
    # the two slices' sums (the model line's reduce) are the whole launch's
    phase("train_kernels", kernel="fused_ffn",
          case="N%d_hidden_halves_summed[bfloat16,p=%g]" % (n, rate),
          max_abs_err=check("fused_ffn halves summed", sum(outs), whole,
                            dtype, TRAIN_TOLERANCE),
          backward_max_abs_err=check("fused_ffn_backward halves summed dx",
                                     sum(dxs), wgrads[0], dtype,
                                     TRAIN_TOLERANCE))


def train_kernels_phase():
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    gen = torch.Generator().manual_seed(SEED)
    rows = train_attention_rows(fa, gen)
    rows.update(train_ffn_rows(ff, gen))
    train_split_checks(fa, ff, gen)
    return rows


# ---------------------------------------------------------------------------
# RPR attention kernels (#3/#4)
# ---------------------------------------------------------------------------

RPR_MAX = 16        # max_relative_position of RPR_CONFIG, at ATTN_CASES
RPR_SMALL_MAX = 3   # rpr_reference's model, at ATTN_SMALL: 2m < every Lk
# checked, not timed, in bf16 (name, B, H, Lq, Lk, Dh, causal, padded, m):
# the causal flag with an all-pad batch row (its weights are uniform over
# all Lk keys, so it feeds dTv's bucket 0 from the keys past the diagonal,
# which no other row reaches), on 64-row tiles that end ragged; the other
# head depths the tensor-core #3/#4 take (128: 32-row dk/dv tiles; 32; 80,
# padded to 128); a depth they do not take (40: the CUDA-core #3/#4); and
# the kernels' largest m (R = 129 buckets, three 64-bucket steps)
RPR_CHECK_CASES = (
    ("causal_pad_200", 4, 2, 200, 200, 64, True, True, RPR_MAX),
    ("dh128_causal_pad_136", 2, 2, 136, 136, 128, True, True, RPR_MAX),
    ("dh32_cross_72x200", 2, 2, 72, 200, 32, False, True, RPR_MAX),
    ("dh80_causal_pad_136", 2, 2, 136, 136, 80, True, True, RPR_MAX),
    ("dh40_pad_136", 2, 1, 136, 136, 40, False, True, RPR_MAX),
    ("m64_causal_pad_200", 2, 2, 200, 200, 64, True, True, 64))
# m = 0, forward only: one bucket, which every key falls in, so the
# tensor-core #3 has no interior bucket and its two edge buckets are one.
# (dTk is then 0 by the algebra, the score term being a per-row constant,
# and a bf16 backward carries the rounding of its delta, which it forms from
# the bf16 output, into it: no absolute bound fits a zero reference.)
RPR_M0_CASE = ("m0_causal_pad_136", 2, 2, 136, 136, 64, True, True, 0)
# the tables as the wrappers read them (.keys, .values), without the
# parameter wrapping of ops/rpr.py:RprTables, so gradients reach tk and tv
Tables = collections.namedtuple("Tables", "keys values")


def rpr_attention_rows(fa, gen):
    """Kernels #3/#4 against fused_attention_rpr_ref, on the route
    forward_route picks (bf16 at Dh 64: the tensor-core #3 and #4, whose
    CUDA-core parents are timed on the same inputs as parent_ms); returns
    the rows."""
    from zero_tpu_torch.ops import attention as attn
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    cases = [c + (RPR_MAX if c in ATTN_CASES else RPR_SMALL_MAX, dtype)
             for c in ATTN_CASES + ATTN_SMALL
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [c + (torch.bfloat16,) for c in RPR_CHECK_CASES]
    for name, b, h, lq, lk, dh, causal, padded, m, dtype in cases:
        timed = name in [c[0] for c in ATTN_CASES]
        r = 2 * m + 1

        def inputs():
            q = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
            k = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
            v = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
            tk = torch.randn(r, dh, generator=gen).to(dev, dtype)
            tv = torch.randn(r, dh, generator=gen).to(dev, dtype)
            pad = attention_pad(gen, b, lk, padded)
            do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
            return [t.requires_grad_() for t in (q, k, v, tk, tv)] + [
                pad.to(dev), do]

        # bound: attention's products over the pairs each row needs,
        # plus the RPR terms per row (q.Tk and wb.Tv forward; their
        # recompute, do.Tv, ds_b.Tk, dTk and dTv backward)
        pairs = attention_pairs(inputs()[5], h, lq, causal)
        eb = torch.tensor([], dtype=dtype).element_size()
        rows_rd = b * h * lq * r * dh
        fwd_bytes = (2 * b * h * lq * dh + 2 * b * h * lk * dh
                     + 2 * r * dh) * eb + 4 * b * lk
        bwd_bytes = (4 * b * h * lq * dh + 4 * b * h * lk * dh
                     + 4 * r * dh) * eb + 4 * b * lk + 8 * b * h * lq
        route = fa.forward_route(dtype, dh)
        tc = route == "tensor_cores"
        sfx = "_tc" if tc else ""
        want = {"fused_attention_rpr" + sfx: 1,
                "fused_attention_rpr_backward" + sfx: 1}
        for rate in (0.0, 0.1):
            q, k, v, tk, tv, pad, do = inputs()
            words = SEED_WORDS if rate else None
            fa.launches.clear()
            out = fa.fused_attention(q, k, v, pad, causal=causal,
                                     dropout_rate=rate, rng=words,
                                     rpr_tables=Tables(tk, tv),
                                     max_relative_position=m)
            grads = torch.autograd.grad(out, (q, k, v, tk, tv), do)
            if dict(fa.launches) != want:
                raise AssertionError("fused_attention_rpr %s %s: launches "
                                     "%s, expected %s" % (
                                         name, dtype, dict(fa.launches),
                                         want))
            ref = fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, m,
                                             causal, rate, words)
            rgrads = torch.autograd.grad(ref, (q, k, v, tk, tv), do)
            label = "%s[%s,p=%g,m=%d]" % (name, str(dtype)[6:], rate, m)
            errs = [check("fused_attention_rpr " + label, out, ref, dtype,
                          TRAIN_TOLERANCE)]
            errs += [check("fused_attention_rpr_backward %s d%s"
                           % (label, w), g, rg, dtype, TRAIN_TOLERANCE)
                     for w, g, rg in zip(("q", "k", "v", "Tk", "Tv"),
                                         grads, rgrads)]
            if not all(torch.isfinite(x).all() for x in (out,) + grads):
                raise AssertionError("fused_attention_rpr %s: non-finite "
                                     "output or gradient" % label)
            if padded and b > 1 and (grads[0][-1].any()
                                     or grads[1][-1].any()):
                raise AssertionError("fused_attention_rpr %s: the all-pad "
                                     "batch row has nonzero dq or dk"
                                     % label)
            if not timed:
                phase("rpr_kernels", kernel="fused_attention_rpr",
                      case=label, max_abs_err=errs[0],
                      backward_max_abs_err=max(errs[1:]),
                      kernels=sorted(want))
                continue
            sets = copies(inputs, fwd_bytes)
            # the launch words of the CUDA-core parents, called directly
            launch = sa.kernel_words(words, (b, h, lq), rate)

            def k_fwd(q, k, v, tk, tv, pad, do):
                return fa.fused_attention(
                    q, k, v, pad, causal=causal, dropout_rate=rate,
                    rng=words, rpr_tables=Tables(tk, tv),
                    max_relative_position=m)

            def p_fwd(q, k, v, tk, tv, pad, do):
                return fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, m,
                                                  causal, rate, words)

            def l_fwd(q, k, v, tk, tv, pad, do):
                # a floor: SDPA computes attention WITHOUT the RPR terms
                if causal:
                    return sdpa(q, k, v, is_causal=True)
                return sdpa(q, k, v, attn_mask=(pad > 0)[:, None, None])

            iters = 2 * len(sets)
            fwd = dict(ms=device_ms(k_fwd, sets, iters),
                       plain_ms=device_ms(p_fwd, sets, iters))
            if tc:
                # the CUDA-core #3 that ran before the tensor-core one, on
                # the same inputs
                def parent_fwd(q, k, v, tk, tv, pad, do):
                    return fa._forward_rpr(q, k, v, pad, tk, tv, m, 0,
                                           causal, rate, launch,
                                           route="cuda_cores")

                fwd["parent_ms"] = device_ms(parent_fwd, sets, iters)
            bwd = {}
            for key, fn in (("ms", k_fwd), ("plain_ms", p_fwd)):
                graphs = [(grad_ms(fn(*s), s[:5], s[6]),) for s in sets]
                bwd[key] = device_ms(lambda run: run(), graphs, iters)
                del graphs
            if tc:
                # the CUDA-core #4 that ran before the tensor-core one,
                # on the same inputs, behind the same forward
                drop = (causal, rate, launch)
                args = []
                for s in sets:
                    qkv = tuple(t.detach() for t in s[:3])
                    tables = (s[3].detach(), s[4].detach())
                    o, mx, lx = fa._forward_rpr(*qkv, s[5], *tables, m, 0,
                                                *drop)
                    args.append(qkv + (s[5],) + tables
                                + (o, s[6], mx, lx, m, 0) + drop)
                bwd["parent_ms"] = device_ms(fa._backward_rpr, args,
                                             iters)
                del args
            if rate == 0.0:
                fwd["library_ms"] = device_ms(l_fwd, sets, iters)
                graphs = [(grad_ms(l_fwd(*s), s[:3], s[6]),)
                          for s in sets]
                bwd["library_ms"] = device_ms(lambda run: run(), graphs,
                                              iters)
                del graphs
                # the composite of use_flash_attention=false on
                # [B, L, hidden] projections, under the same mask
                keep = (sets[0][5] > 0)[:, None, None, :]
                if causal:
                    keep = keep & torch.ones(lq, lk, dtype=torch.bool,
                                             device=dev).tril()
                keep = keep.float()
                csets = [[attn.combine_heads(x.detach()).requires_grad_()
                          for x in s[:3]]
                         + [x.detach().requires_grad_() for x in s[3:5]]
                         + [attn.combine_heads(s[6])] for s in sets]

                def c_fwd(q2, k2, v2, tk, tv, do2):
                    return attn._attn_core(q2, k2, v2, keep, h,
                                           rpr_tables=Tables(tk, tv),
                                           rpr_max=m)[0]

                fwd["composite_ms"] = device_ms(c_fwd, csets, iters)
                graphs = [(grad_ms(c_fwd(*s), s[:5], s[5]),)
                          for s in csets]
                bwd["composite_ms"] = device_ms(lambda run: run(), graphs,
                                                iters)
                del graphs, csets
                bwd["fwd_bwd_ms"] = device_ms(fwd_bwd(k_fwd, 5), sets,
                                              iters)
            fb, fby = bound(fwd_bytes, 4 * pairs * dh + 4 * rows_rd, dtype)
            bb, bby = bound(bwd_bytes, 10 * pairs * dh + 10 * rows_rd,
                            dtype)
            fwd.update(bound_ms=fb, bound_by=fby, max_abs_err=errs[0])
            bwd.update(bound_ms=bb, bound_by=bby,
                       max_abs_err=max(errs[1:]))
            phase("rpr_kernels", kernel="fused_attention_rpr",
                  case=label, route=route, **fwd)
            phase("rpr_kernels", kernel="fused_attention_rpr_backward",
                  case=label, route=route, **bwd)
            rows[("fused_attention_rpr", name, dtype, rate)] = fwd
            rows[("fused_attention_rpr_backward", name, dtype, rate)] = bwd
            del sets
            torch.cuda.empty_cache()
    return rows


def rpr_m0_check(fa, gen):
    """The RPR forward at RPR_M0_CASE against fused_attention_rpr_ref,
    bf16, dropout 0 and 0.1."""
    name, b, h, lq, lk, dh, causal, padded, m = RPR_M0_CASE
    dev, dtype = "cuda", torch.bfloat16
    sfx = "_tc" if fa.forward_route(dtype, dh) == "tensor_cores" else ""
    for rate in (0.0, 0.1):
        q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(dev, dtype)
                   for n in (lq, lk, lk))
        tk, tv = (torch.randn(2 * m + 1, dh, generator=gen).to(dev, dtype)
                  for _ in range(2))
        pad = attention_pad(gen, b, lk, padded).to(dev)
        words = SEED_WORDS if rate else None
        fa.launches.clear()
        out = fa.fused_attention(q, k, v, pad, causal=causal,
                                 dropout_rate=rate, rng=words,
                                 rpr_tables=Tables(tk, tv),
                                 max_relative_position=m)
        if dict(fa.launches) != {"fused_attention_rpr" + sfx: 1}:
            raise AssertionError("fused_attention_rpr %s: launches %s"
                                 % (name, dict(fa.launches)))
        ref = fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, m, causal,
                                         rate, words)
        label = "%s[%s,p=%g,m=%d]" % (name, str(dtype)[6:], rate, m)
        err = check("fused_attention_rpr " + label, out, ref, dtype,
                    TRAIN_TOLERANCE)
        phase("rpr_kernels", kernel="fused_attention_rpr", case=label,
              max_abs_err=err, kernels=sorted(fa.launches))


def rpr_kernels_phase():
    from zero_tpu_torch.ops.kernels import fused_attention as fa

    gen = torch.Generator().manual_seed(SEED + 2)
    rows = rpr_attention_rows(fa, gen)
    rpr_m0_check(fa, gen)
    rpr_split_check(fa, gen)
    return rows


def rpr_split_check(fa, gen):
    """#3/#4 over SPLIT_HEADS at ATTN_CASES' causal case with RPR_MAX
    (the tensor-core kernels in bf16), dropout on; the tables are whole
    on every process, so their gradients are held against the plain
    version's."""
    dev, dtype, rate = "cuda", torch.bfloat16, SPLIT_RATE
    name, b, h, lq, lk, dh, causal, padded = ATTN_CASES[0]
    q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(
        dev, dtype).requires_grad_() for n in (lq, lk, lk))
    tk, tv = (torch.randn(2 * RPR_MAX + 1, dh, generator=gen).to(
        dev, dtype).requires_grad_() for _ in range(2))
    do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
    pad = attention_pad(gen, b, lk, padded).to(dev)

    def launch(q, k, v, heads):
        return fa.fused_attention(q, k, v, pad, causal=causal,
                                  dropout_rate=rate, rng=SEED_WORDS,
                                  rpr_tables=Tables(tk, tv),
                                  max_relative_position=RPR_MAX,
                                  heads=heads)

    def plain(q, k, v, heads):
        return fa.fused_attention_rpr_ref(q, k, v, pad, tk, tv, RPR_MAX,
                                          causal, rate, SEED_WORDS, heads)

    check_head_split("rpr_kernels", "fused_attention_rpr", name, launch,
                     plain, q, k, v, do, (tk, tv), SPLIT_HEADS,
                     {"fused_attention_rpr_tc": 1,
                      "fused_attention_rpr_backward_tc": 1}, fa.launches)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def write_train_corpus(d, words, sentences=8000):
    """Parallel training text of 10 to 100 tokens per side over the
    synthetic vocabulary, made from SEED."""
    rs = np.random.RandomState(SEED + 1)
    for name in ("train.src", "train.tgt"):
        with open(os.path.join(d, name), "w") as w:
            for _ in range(sentences):
                n = rs.randint(10, 101)
                w.write(" ".join(words[i] for i in rs.randint(0, len(words),
                                                              n)) + "\n")


def stacked_shape(shapes):
    """A step's microbatches all run at its stacked shape: the largest
    rows, source and target lengths among them."""
    return (max(s[0][0] for s in shapes), max(s[0][1] for s in shapes),
            max(s[1][1] for s in shapes))


def model_flops(shapes, cfg):
    """Matmul FLOPs of one training step: its microbatches run at the
    step's stacked shape; forward x 3 for forward + backward, plus the
    chunked CE's recomputed logits. transformer_rpr adds its RPR matmuls,
    q.Tk and the bucket sums' product with Tv: 4 * rows * (2m+1) * hidden
    per attention (the one-hot expansions are not counted);
    transformer_aan's decoder has the gate's product in place of
    self-attention (its cumulative mean is no matmul); transformer_fuse's
    the query side's v projection (its average is no matmul either).
    ReLA's, L0Drop's and Fixup's matmuls are transformer's (L0Drop's gate
    projection, 2 * d FLOPs a source token, is left out);
    transformer_ibdecoder's decoder runs over the interleaved target of
    M + 2 (rounded up to even) positions. Model FLOPs:
    use_remat's recompute of the layers' forwards is not counted."""
    d, f = cfg["hidden_size"], cfg["filter_size"]
    v = 32768
    b, ls, lt = stacked_shape(shapes)
    name = cfg.get("model_name")
    if name == "transformer_ibdecoder":
        # the decoder and the softmax run over the interleaved target:
        # both streams and their eos, M + 2 rounded up to even
        lt = lt + 2 + lt % 2
    rpr = 0
    if name == "transformer_rpr":
        r = 2 * cfg["max_relative_position"] + 1
        rpr = 4 * r * d
    # transformer_moe: each token's FFN runs in top_k experts (the routed
    # tokens; the router's d x E product is left out); transformer_clsr:
    # two d x d products (shared and per-language) per CLSR unit and
    # token, 2 units an encoder layer, 3 a decoder layer;
    # transformer_multilingual: LaLT's d x d product per target token, and
    # under ROBT a second pass over the synthetic pair (its greedy decode
    # is not counted)
    ffn_k = int(cfg.get("moe_top_k", 1)) if name == "transformer_moe" else 1
    clsr = 4 * d * d if name == "transformer_clsr" else 0
    lalt = 2 * d * d if name == "transformer_multilingual" else 0
    passes = 2 if (name == "transformer_multilingual"
                   and str(cfg.get("robt", False)).lower() == "true") else 1
    total = 0
    for _ in range(passes * len(shapes)):
        ns, nt = b * ls, b * lt
        if cfg.get("model_name") == "transformer_aan":
            # average attention: the gate's [2d, 2d] product (and the
            # aan_ffn), no self-attention matmuls
            dec_self = 2 * nt * 2 * d * 2 * d + (
                4 * nt * d * f if cfg.get("use_ffn") else 0)
        elif cfg.get("model_name") == "transformer_fuse":
            dec_self = 2 * nt * d * d
        else:
            dec_self = 2 * nt * d * 4 * d + 4 * b * lt * lt * d
        enc = cfg["num_encoder_layer"] * (
            2 * ns * d * 4 * d + 4 * ns * d * f * ffn_k
            + 4 * b * ls * ls * d + rpr * ns + 2 * clsr * ns)
        dec = cfg["num_decoder_layer"] * (
            dec_self + 2 * nt * d * 2 * d + 2 * ns * d * 2 * d
            + 4 * nt * d * f * ffn_k + 4 * b * lt * ls * d + 2 * rpr * nt
            + 3 * clsr * nt)
        logits = 2 * nt * d * v + lalt * nt
        total += 3 * (enc + dec + logits) + logits
    return total


def remat_forwards(cfg):
    """Forward launches of a layer's kernel per microbatch: 2 under
    use_remat (the backward recomputes each layer's forward), else 1.
    ``cfg`` holds a config file's values, overrides as strings."""
    return 2 if str(cfg.get("use_remat", False)).lower() == "true" else 1


def expected_launches(cfg, summary):
    """Per microbatch: one attention per encoder layer and two per decoder
    layer (18 at 6+6, 6 at BASE_CUT's 2+2), one FFN per layer (12, 4);
    forward (twice under
    use_remat) and backward, the attention on the route forward_route
    picks. transformer_l0drop's layers are transformer's."""
    microbatches = cfg["update_cycle"] * summary["steps"]
    attn = cfg["num_encoder_layer"] + 2 * cfg["num_decoder_layer"]
    ffn = cfg["num_encoder_layer"] + cfg["num_decoder_layer"]
    fwd = remat_forwards(cfg)
    sfx = route_suffix(cfg)
    return {"fused_attention" + sfx: attn * microbatches * fwd,
            "fused_attention_backward" + sfx: attn * microbatches,
            "fused_ffn": ffn * microbatches * fwd,
            "fused_ffn_backward": ffn * microbatches}


def rpr_expected_launches(cfg, summary):
    """transformer_rpr: an attention takes the RPR kernels where its keys
    outnumber 2m (ops/attention.py:_rpr_flash_ok), at each step's stacked
    lengths: encoder self-attention and decoder cross attention over the
    source, decoder self-attention over the target. Its FFN never fuses.
    Both directions run on the route forward_route picks (bf16 at Dh 64:
    the tensor-core #3 and #4)."""
    two_m = 2 * cfg["max_relative_position"]
    n = 0
    for shapes in summary["shapes"]:
        _, ls, lt = stacked_shape(shapes)
        n += len(shapes) * (cfg["num_encoder_layer"] * (ls > two_m)
                            + cfg["num_decoder_layer"] * ((lt > two_m)
                                                          + (ls > two_m)))
    sfx = route_suffix(cfg)
    return {"fused_attention_rpr" + sfx: n,
            "fused_attention_rpr_backward" + sfx: n}


def route_suffix(cfg):
    """The launch counters' suffix of the attention kernels' route at a
    config's dtype and head depth: "_tc" on the tensor cores."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa

    return "_tc" if fa.forward_route(
        getattr(torch, cfg["default_dtype"]),
        cfg["hidden_size"] // cfg["num_heads"]) == "tensor_cores" else ""


def train_run(d, out, flags, counters, config=CONFIG, extra="",
              steps=TRAIN_STEPS):
    from zero_tpu_torch import run

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "output_dir={1},use_flash_attention={2},use_fused_ffn={2},"
            "max_training_steps={3},disp_freq=1,save_freq=0,eval_freq=0,"
            "sample_freq=0,epoches=100".format(d, out, flags, steps))
    spec += extra
    for c in counters:
        c.clear()
    summary = run.main(["--mode", "train", "--config", config,
                        "--parameters", spec])
    return summary, collect(counters)


def collect(counters):
    launches = {}
    for c in counters:
        launches.update({k: v for k, v in c.items() if v})
    return launches


def train_phase(d, da, config=CONFIG, label="train",
                expected=expected_launches, extra="",
                flag_runs=("true", "false"), serving=None, steps=TRAIN_STEPS,
                note=None, peak=PEAK_BF16, flops_fn=None):
    """Train ``config`` (with the ``extra`` parameters) ``steps`` steps
    with both kernel flags on, then off (``flag_runs``); then serve
    (--mode test) and score the kernel run's checkpoint, whose launches
    ``serving(cfg, served, serve_launches, score_launches)`` checks where
    given (no plain version in any case); ``note`` is printed beside the
    numbers; ``peak`` is MFU's denominator (the peak rate of the dtype the
    model computes in). Returns the kernel run's results (its launch
    counts under "launches") and the serving run's launch counts."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    cfg = load_config_file(config)
    cfg.update(overrides(extra))
    counters = (fa.launches, ff.launches, da.launches)
    results = {}
    for flags in flag_runs:
        out = os.path.join(d, "%s_%s" % (label, flags))
        torch.cuda.reset_peak_memory_stats()
        summary, launches = train_run(d, out, flags, counters, config, extra,
                                      steps)
        if summary["steps"] != steps:
            raise AssertionError("trained %d steps, wanted %d"
                                 % (summary["steps"], steps))
        if not all(math.isfinite(x) for x in summary["losses"]):
            raise AssertionError("non-finite loss: %s" % summary["losses"])
        want = expected(cfg, summary) if flags == "true" else {}
        if launches != want:
            raise AssertionError("%s (flags %s) launches %s, expected %s "
                                 "(no plain version)" % (label, flags,
                                                         launches, want))
        ends = summary["step_end_times"]
        step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
        ms = 1e3 * step_s[len(step_s) // 2]
        tokens = summary["target_tokens"]
        flops = [(flops_fn or model_flops)(s, cfg)
                 for s in summary["shapes"]]
        timed = sum(b - a for a, b in zip(ends[:-1], ends[1:]))
        tok_s = sum(tokens[1:]) / timed
        mfu = sum(flops[1:]) / timed / peak
        results[flags] = dict(
            kernels=flags == "true", steps=steps, ms_per_step_median=ms,
            ms_per_step_mean=1e3 * timed / (steps - 1),
            target_tokens_per_s=tok_s,
            model_tflop_per_step=sum(flops) / steps / 1e12, mfu=mfu,
            loss_first=summary["losses"][0], loss_last=summary["losses"][-1],
            gnorm_first=summary["gnorms"][0],
            gnorm_last=summary["gnorms"][-1], launches=launches,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            **({} if note is None else {"note": note}))
        phase(label, **results[flags])
        torch.cuda.reset_peak_memory_stats()
    # the kernel run's checkpoint serves through --mode test
    served, serve_launches = serve_checkpoint(d, label, counters)
    # and scores it through --mode score (the saved param.json keeps both
    # kernel flags on, so the forward runs the kernels)
    from zero_tpu_torch import run
    for c in counters:
        c.clear()
    scores, ppl = run.main(["--mode", "score", "--parameters",
                            checkpoint_spec(d, label, "scores")])
    score_launches = collect(counters)
    if len(scores) != TEST_SENTENCES or not all(map(math.isfinite, scores)):
        raise AssertionError("scored %d sentences: %s" % (len(scores),
                                                          scores[:4]))
    plain = [n for n in list(serve_launches) + list(score_launches)
             if n.endswith("_ref")]
    if plain:
        raise AssertionError("%s: plain versions ran while serving or "
                             "scoring: %s %s" % (label, serve_launches,
                                                 score_launches))
    if serving is not None:
        serving(cfg, served, serve_launches, score_launches)
    phase(label, served_sentences=served["sentences"],
          served_bleu=served["bleu"], served_s=served["seconds"],
          sentences_per_s=served["sentences"] / served["seconds"],
          decode_steps=served["steps"], serve_launches=serve_launches,
          scored_sentences=len(scores), score_ppl=ppl,
          score_launches=score_launches)
    return results["true"], serve_launches


def checkpoint_spec(d, label, output, beam=None):
    """--parameters of --mode test/score over the kernel run's checkpoint
    of ``label`` on the 32-sentence test set, writing ``output``."""
    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "output_dir={0}/{1}_true,test_output={0}/{1}_{2}.txt,"
            "eval_batch_size=32".format(d, label, output))
    return spec + ("" if beam is None else ",beam_size=%d" % beam)


def serve_checkpoint(d, label, counters, beam=None, extra="", tag=""):
    """--mode test of the kernel run's checkpoint of ``label`` (the saved
    beam, or ``beam``; ``extra`` parameters, ``tag`` in the output's
    name); returns evaluate()'s summary and the launches."""
    from zero_tpu_torch import run

    for c in counters:
        c.clear()
    output = ("trained" if beam is None else "trained_beam%d" % beam) + tag
    served = run.main(["--mode", "test", "--parameters",
                       checkpoint_spec(d, label, output, beam) + extra])
    launches = collect(counters)
    with open(os.path.join(d, "%s_%s.txt" % (label, output))) as r:
        lines = r.read().splitlines()
    if len(lines) != TEST_SENTENCES or served["sentences"] != TEST_SENTENCES:
        raise AssertionError("served %d lines of the trained model"
                             % len(lines))
    return served, launches


def rpr_serving(cfg, served, serve_launches, score_launches):
    """RPR decode runs no decode kernel; the encoder (serving) and the
    scoring forward run #3, as the saved flags say."""
    rpr_fwd = {"fused_attention_rpr" + route_suffix(cfg)}
    if set(serve_launches) != rpr_fwd or set(score_launches) != rpr_fwd:
        raise AssertionError("rpr_train: serving launched %s, scoring %s"
                             % (serve_launches, score_launches))


def _small_model(dropout, model_name="transformer"):
    from zero_tpu_torch.config import default_config
    from zero_tpu_torch.vocab import Vocab

    cfg = default_config()
    for k, v in dict(model_name=model_name, hidden_size=64, embed_size=64,
                     filter_size=128, num_heads=4, num_encoder_layer=2,
                     num_decoder_layer=2, initializer="uniform_unit_scaling",
                     initializer_gain=1.0, use_flash_attention=True,
                     use_fused_ffn=True, dropout=dropout,
                     attention_dropout=dropout, relu_dropout=dropout,
                     residual_dropout=dropout, label_smooth=0.1,
                     loss_chunk_tokens=16, decode_length=10,
                     max_relative_position=RPR_SMALL_MAX).items():
        setattr(cfg, k, v)
    vocab = Vocab()
    for i in range(40):
        vocab.insert("w%d" % i)
    cfg.src_vocab = cfg.tgt_vocab = vocab
    return cfg


def _small_batch():
    rs = np.random.RandomState(SEED)
    src = rs.randint(3, 43, (6, 12))
    tgt = rs.randint(3, 43, (6, 9))
    for i, (ns, nt) in enumerate(zip(rs.randint(3, 12, 6),
                                     rs.randint(2, 9, 6))):
        src[i, ns:] = 0
        tgt[i, nt:] = 0
    src[-1] = 0   # an all-pad row
    tgt[-1] = 0
    return {"source": torch.as_tensor(src), "target": torch.as_tensor(tgt)}


def plain_attention(q, k, v, pad_mask=None, *, causal=False,
                    dropout_rate=0.0, rng=None, rpr_tables=None,
                    max_relative_position=None, heads=None, qrows=None):
    """fused_attention's interface over its plain versions: from the same
    seed words they draw the kernels' dropout masks."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa

    pad = (torch.ones(q.shape[0], k.shape[2], device=q.device)
           if pad_mask is None else pad_mask.float())
    rate = dropout_rate if rng is not None else 0.0
    if rpr_tables is None:
        return fa.fused_attention_ref(q, k, v, pad, causal, rate, rng, heads,
                                      qrows)
    assert qrows is None
    return fa.fused_attention_rpr_ref(
        q, k, v, pad, rpr_tables.keys.to(q.dtype),
        rpr_tables.values.to(q.dtype), max_relative_position, causal, rate,
        rng, heads)


def plain_ffn(x, w1, b1, w2, b2, rng=None, rate=0.0, hidden=None,
              tokens=None):
    """fused_ffn's interface over its plain version."""
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    y = ff.fused_ffn_ref(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, rng,
                         rate, hidden, tokens)
    return y.reshape(*x.shape[:-1], w2.shape[1])


def train_reference_phase():
    """train_fn on the card (kernels) against the CPU (plain versions)."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    model = get_model("transformer")
    feats = _small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    cfg = _small_model(0.0)
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    fa.launches.clear()
    ff.launches.clear()
    lc = model.train_fn(cpu, feats, cfg, None)["loss"]
    gc = torch.autograd.grad(lc, list(cpu.parameters()))
    lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
    gg = torch.autograd.grad(lg, list(gpu.parameters()))
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    errs = grad_errors(cpu, gc, gg)
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    if not (loss_err <= 1e-4 and grad_err <= 1e-4
            and fa.launches["fused_attention_backward"] == 6
            and ff.launches["fused_ffn_backward"] == 4):
        raise AssertionError("train_reference: loss rel err %.3g, grad rel "
                             "err %.3g (%s), launches %s %s"
                             % (loss_err, grad_err, worst,
                                dict(fa.launches), dict(ff.launches)))

    # dropout on: kernels against plain versions on the card, same words
    cfg = _small_model(0.1)
    losses = []
    for plain in (False, True):
        with mock.patch.object(fa, "fused_attention",
                               plain_attention if plain
                               else fa.fused_attention), \
                mock.patch.object(ff, "fused_ffn",
                                  plain_ffn if plain else ff.fused_ffn):
            loss = model.train_fn(gpu, gfeats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
        losses.append(loss.item())
    drop_err = abs(losses[0] - losses[1]) / abs(losses[1])
    if not drop_err <= 1e-5:
        raise AssertionError("train_reference: dropout-on loss kernels %r "
                             "vs plain %r" % tuple(losses))

    # bf16: the same model (widths 64/128) takes the tensor-core FFN kernels,
    # held against plain_ffn on the card, dropout off and on from the same
    # seed words (the attention kernels run on both sides). Tolerance: loss
    # within 1e-2 relative, grads within 2e-2 of their scale (grad_errors):
    # bf16 keeps 8 mantissa bits, the kernels sum each product in fp32 and
    # round it once, and PyTorch's bf16 matmuls may round partial sums.
    bf16 = {}
    for rate in (0.0, 0.1):
        cfg = _small_model(rate)
        cfg.default_dtype = "bfloat16"
        kern, plain = bf16_runs(model, gpu, gfeats, cfg, ff, "fused_ffn",
                                (ff.fused_ffn, plain_ffn), [ff.launches])
        bf16[rate] = dict(loss_kernels=kern[0], loss_plain=plain[0],
                          **bf16_errors(cpu, kern, plain))
        if not (bf16[rate]["loss_rel_err"] <= 1e-2
                and bf16[rate]["grad_rel_err"] <= 2e-2
                and kern[2] == {"fused_ffn": 4, "fused_ffn_backward": 4}
                and plain[2] == {"fused_ffn_ref": 4}):
            raise AssertionError("train_reference bf16 p=%g: %s, launches "
                                 "%s / %s" % (rate, bf16[rate], kern[2],
                                              plain[2]))
    attn = train_reference_attention_bf16(model, gpu, gfeats)
    phase("train_reference", loss_rel_err=loss_err, grad_rel_err=grad_err,
          dropout_loss_kernels=losses[0], dropout_loss_plain=losses[1],
          dropout_rel_err=drop_err,
          bf16={"p=%g" % r: v for r, v in bf16.items()},
          bf16_attention=attn)
    bad = {r: v for r, v in attn.items() if not v["ok"]}
    if bad:
        raise AssertionError("train_reference bf16 attention: %s" % bad)


def train_reference_attention_bf16(model, gpu, gfeats):
    """The small model in bf16 at head depth 16, where #1 and #2 take the
    tensor cores (forward_route), the FFN kernels on every side, dropout
    off and on from the same seed words: train_fn with #1 and #2 against
    the plain attention on the card (loss within 1e-2 relative), and with
    #2 against the plain version's backward behind the same #1 (grads
    within 2e-2 of their scale): the bounds of the other bf16 checks.
    Beside them, ungated: the whole path's grads against the plain
    version's (``full_path``), and both paths' against the plain attention
    in fp32 (``kernels_vs_fp32``, ``plain_vs_fp32``): on this 54-token
    batch one bf16 ulp in an attention output flips ReLU units of the
    FFNs, whose weight grads then move by a large share of their scale
    whichever version rounds."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa

    out = {}
    for rate in (0.0, 0.1):
        cfg = _small_model(rate)
        cfg32 = _small_model(rate)
        cfg.default_dtype = "bfloat16"
        kern, plain_bwd, plain = bf16_runs(
            model, gpu, gfeats, cfg, fa, "fused_attention",
            (fa.fused_attention, plain_backward_fused, plain_attention),
            [fa.launches])
        (plain32,) = bf16_runs(model, gpu, gfeats, cfg32, fa,
                               "fused_attention", (plain_attention,),
                               [fa.launches])
        grads = bf16_errors(gpu, kern, plain_bwd)
        r = dict(loss_kernels=kern[0], loss_plain=plain[0],
                 loss_rel_err=abs(kern[0] - plain[0]) / abs(plain[0]),
                 grad_rel_err=grads["grad_rel_err"],
                 grad_worst=grads["grad_worst"], launches=kern[2],
                 full_path=bf16_errors(gpu, kern, plain),
                 kernels_vs_fp32=bf16_errors(gpu, kern, plain32),
                 plain_vs_fp32=bf16_errors(gpu, plain, plain32))
        r["ok"] = (r["loss_rel_err"] <= 1e-2 and r["grad_rel_err"] <= 2e-2
                   and kern[2] == {"fused_attention_tc": 6,
                                   "fused_attention_backward_tc": 6}
                   and plain_bwd[2] == {"fused_attention_tc": 6,
                                        "fused_attention_ref": 6}
                   and plain[2] == {"fused_attention_ref": 6})
        out["p=%g" % rate] = r
    return out


def bf16_grad_errors(model, test, ref):
    """grad_errors of the ``test`` grads against the ``ref`` grads, but the
    cross-attention key bias's: its gradient is zero in exact arithmetic
    (softmax ignores a per-row constant), so both sides hold bf16 rounding
    noise there, above grad_errors' 1e-3 floor, and its error is taken on
    the scale of the model's largest gradient."""
    errs = grad_errors(model, ref, test)
    top = max(g.abs().max().item() for g in ref)
    for name, a, b in zip([n for n, _ in model.named_parameters()], test,
                          ref):
        if name.endswith("cross.k.b"):
            errs[name] = (a - b).abs().max().item() / top
    return errs


def grad_errors(cpu, gc, gg):
    """Each card grad's max error relative to its CPU grad's max |grad|,
    floored at 1e-3 of the model's largest: the cross-attention key bias
    has an exactly zero gradient in exact arithmetic (softmax ignores a
    per-row constant), so both sides hold rounding noise there."""
    names = [n for n, _ in cpu.named_parameters()]
    top = max(b.abs().max().item() for b in gc)
    scale = {n: max(b.abs().max().item(), 1e-3 * top)
             for n, b in zip(names, gc)}
    return {n: (a.cpu() - b).abs().max().item() / scale[n]
            for n, a, b in zip(names, gg, gc)}


def rpr_reference_phase(da):
    """A small fp32 transformer_rpr (m = 3 < half of every length, so all
    six attentions take the RPR kernels): train_fn card against CPU, with
    dropout on kernels against plain versions, beam-4 decode card against
    CPU."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.search import beam_search

    model = get_model("transformer_rpr")
    feats = _small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    cfg = _small_model(0.0, "transformer_rpr")
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    fa.launches.clear()
    lc = model.train_fn(cpu, feats, cfg, None)["loss"]
    gc = torch.autograd.grad(lc, list(cpu.parameters()))
    lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
    gg = torch.autograd.grad(lg, list(gpu.parameters()))
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    errs = grad_errors(cpu, gc, gg)
    worst = max(errs, key=errs.get)
    table_err = max(e for n, e in errs.items() if "_rpr." in n)
    want = {"fused_attention_rpr": 6, "fused_attention_rpr_backward": 6,
            "fused_attention_rpr_ref": 6}
    if not (loss_err <= 1e-4 and errs[worst] <= 1e-4
            and collect([fa.launches]) == want):
        raise AssertionError("rpr_reference: loss rel err %.3g, grad rel err "
                             "%.3g (%s), launches %s" % (
                                 loss_err, errs[worst], worst,
                                 dict(fa.launches)))

    # dropout on: kernels against plain versions on the card, same words
    cfg = _small_model(0.1, "transformer_rpr")
    losses = []
    for plain in (False, True):
        fa.launches.clear()
        with mock.patch.object(fa, "fused_attention",
                               plain_attention if plain
                               else fa.fused_attention):
            loss = model.train_fn(gpu, gfeats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
        losses.append(loss.item())
        key = "fused_attention_rpr" + ("_ref" if plain else "")
        if fa.launches[key] != 6:
            raise AssertionError("rpr_reference: dropout run launched %s"
                                 % dict(fa.launches))
    drop_err = abs(losses[0] - losses[1]) / abs(losses[1])
    if not drop_err <= 1e-5:
        raise AssertionError("rpr_reference: dropout-on loss kernels %r vs "
                             "plain %r" % tuple(losses))

    # beam 4: the card runs the classic permuted cache (RPR has no pool
    # kernel), the CPU the ancestry pools; no decode kernel either way
    cfg.beam_size = 4
    inf = model.infer_fn(cfg)
    src = feats["source"]
    da.launches.clear()
    with torch.inference_mode():
        g = beam_search(gpu, src.cuda(), inf, cfg)
        c = beam_search(cpu, src, inf, cfg)
    same = torch.equal(g["seq"].cpu(), c["seq"])
    score_err = (g["score"].cpu() - c["score"]).abs().max().item()
    if not (same and score_err <= 1e-4 and not collect([da.launches])
            and torch.isfinite(g["score"]).all()):
        raise AssertionError("rpr_reference beam 4: card vs CPU sequences "
                             "equal %s, score err %.3g, decode launches %s"
                             % (same, score_err, dict(da.launches)))
    phase("rpr_reference", loss_rel_err=loss_err, grad_rel_err=errs[worst],
          worst=worst, table_grad_rel_err=table_err,
          dropout_loss_kernels=losses[0], dropout_loss_plain=losses[1],
          dropout_rel_err=drop_err, beam4_same_sequences=same,
          beam4_max_score_err=score_err, beam4_steps=g["steps"])


# ---------------------------------------------------------------------------
# transformer_rela, transformer_aan and ensemble decoding
# ---------------------------------------------------------------------------

AAN_CONFIG = os.path.join(REPO, "configs", "transformer_aan_wmt14.json")
# transformer_rela is configs/transformer_rpr_rela.json with these names
RELA_EXTRA = (",model_name=transformer_rela,scope_name=transformer_rela"
              + BASE_CUT)
TEST_BATCHES = TEST_SENTENCES // 32    # at eval_batch_size 32


def no_kernel(cfg, summary):
    """ReLA trains on the composite attention whatever the flags say, and
    its FFN is never fused (the JAX package's rule): no launch at all."""
    return {}


def rela_serving(cfg, served, serve_launches, score_launches):
    """Beam-4 decode runs #8 in relu mode, once per decoder layer and
    step; the encoder and the scoring forward run no kernel."""
    want = {"decode_pool_attention_relu":
            cfg["num_decoder_layer"] * served["steps"]}
    if serve_launches != want or score_launches:
        raise AssertionError("rela_train: serving launched %s, expected %s; "
                             "scoring %s, expected none"
                             % (serve_launches, want, score_launches))


def rela_train_phase(d, da):
    """transformer_rela (configs/transformer_rpr_rela.json renamed) trained
    TRAIN_STEPS steps with use_flash_attention on (no kernel launch, per
    the JAX rule), served at beam 4 (#8 in relu mode), at beam 1 (no
    decode kernel: #10 has no relu mode) and scored. Returns the beam-4
    serving launches."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    _, served = train_phase(d, da, RPR_CONFIG, "rela_train", no_kernel,
                            RELA_EXTRA, ("true",), rela_serving)
    served1, launches1 = serve_checkpoint(
        d, "rela_train", (fa.launches, ff.launches, da.launches), beam=1)
    if launches1:
        raise AssertionError("rela_train beam 1 launched %s, expected no "
                             "kernel" % launches1)
    phase("rela_train", beam=1, sentences_per_s=served1["sentences"]
          / served1["seconds"], decode_steps=served1["steps"],
          served_bleu=served1["bleu"], serve_launches=launches1)
    return served


def encoder_expected_launches(cfg, summary):
    """transformer_aan and transformer_fuse: per microbatch one attention
    and one FFN per encoder layer, forward (twice under use_remat) and
    backward (6 each at 6 layers; the attention on the route forward_route
    picks); the AAN decoder's cross attention and FFN, and the merged
    decoder's attention and FFN, run the composite."""
    n = cfg["num_encoder_layer"] * cfg["update_cycle"] * summary["steps"]
    fwd = n * remat_forwards(cfg)
    sfx = route_suffix(cfg)
    return {"fused_attention" + sfx: fwd, "fused_attention_backward" + sfx: n,
            "fused_ffn": fwd, "fused_ffn_backward": n}


def encoder_serving(cfg, served, serve_launches, score_launches):
    """Serving and scoring run the encoder's forward kernels (one
    attention and one FFN per encoder layer and test batch); AAN and fuse
    decode keep a running sum and take no decode kernel."""
    n = cfg["num_encoder_layer"] * TEST_BATCHES
    want = {"fused_attention" + route_suffix(cfg): n, "fused_ffn": n}
    if serve_launches != want or score_launches != want:
        raise AssertionError("%s: serving launched %s, scoring %s, "
                             "expected %s" % (cfg["model_name"],
                                              serve_launches, score_launches,
                                              want))


def small_reference(da, name, train_want, decode_want):
    """A small fp32 ``name`` model (_small_model, dropout off): train_fn
    loss and grads on the card (kernels) against the CPU (plain versions)
    within 1e-4, and beam 4 on the card against the CPU: identical
    sequences, scores within 1e-4. ``train_want`` is the card's training
    launches; ``decode_want(steps)`` its decode launches."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.search import beam_search

    counters = (fa.launches, ff.launches, da.launches)
    model = get_model(name)
    feats = _small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    cfg = _small_model(0.0, name)
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    lc = model.train_fn(cpu, feats, cfg, None)["loss"]
    gc = torch.autograd.grad(lc, list(cpu.parameters()))
    for c in counters:
        c.clear()
    lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
    gg = torch.autograd.grad(lg, list(gpu.parameters()))
    train_launches = collect(counters)
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    errs = grad_errors(cpu, gc, gg)
    worst = max(errs, key=errs.get)
    cfg.beam_size = 4
    inf = model.infer_fn(cfg)
    with torch.inference_mode():
        c = beam_search(cpu, feats["source"], inf, cfg)
        for n in counters:
            n.clear()
        g = beam_search(gpu, gfeats["source"], inf, cfg)
    decode_launches = collect(counters)
    same = torch.equal(g["seq"].cpu(), c["seq"])
    score_err = (g["score"].cpu() - c["score"]).abs().max().item()
    out = dict(loss_rel_err=loss_err, grad_rel_err=errs[worst], worst=worst,
               train_launches=train_launches, beam4_same_sequences=same,
               beam4_max_score_err=score_err, beam4_steps=g["steps"],
               decode_launches=decode_launches)
    if not (loss_err <= 1e-4 and errs[worst] <= 1e-4
            and train_launches == train_want and same and score_err <= 1e-4
            and decode_launches == decode_want(g["steps"])
            and torch.isfinite(g["score"]).all()):
        raise AssertionError("%s reference: %s" % (name, out))
    return out


def rela_reference_phase(da):
    """A small fp32 transformer_rela: no training kernel (ReLA keeps the
    composite); beam 4 on the card through #8's relu mode."""
    phase("rela_reference", **small_reference(
        da, "transformer_rela", {},
        lambda steps: {"decode_pool_attention_relu": 2 * steps}))


def aan_reference_phase(da):
    """A small fp32 transformer_aan: the encoder's CUDA-core #1/#2 and
    #11/#12 (fp32) on the card; beam 4 with no decode kernel."""
    n = 2   # encoder layers of _small_model
    phase("aan_reference", **small_reference(
        da, "transformer_aan",
        {"fused_attention": n, "fused_attention_backward": n,
         "fused_ffn": n, "fused_ffn_backward": n},
        lambda steps: {"fused_attention": n, "fused_ffn": n}))


def ensemble_phase(d, da):
    """--mode ensemble at beam 4 over the checkpoints that train
    (transformer-base) and rela_train saved, on the 32-sentence test set:
    #8 in both modes, once per decoder layer and step each; then a small
    fp32 transformer + transformer_rela ensemble on the card against the
    CPU. Returns the ensemble run's launches."""
    import copy

    from zero_tpu_torch import run, train
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.search import beam_search

    counters = (fa.launches, ff.launches, da.launches)
    cfg = load_config_file(CONFIG)
    cfg.update(overrides(BASE_CUT))
    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "test_output={0}/ensemble.txt,eval_batch_size=32,"
            "beam_size=4".format(d))
    for c in counters:
        c.clear()
    summary = run.main(["--mode", "ensemble", "--ensemble_dirs",
                        "{0}/train_true;{0}/rela_train_true".format(d),
                        "--parameters", spec])
    launches = collect(counters)
    with open(os.path.join(d, "ensemble.txt")) as r:
        lines = r.read().splitlines()
    # transformer-base's encoder runs #1 and #11 (its saved flags), ReLA's
    # the composite; each model's decoder its mode of #8
    enc = cfg["num_encoder_layer"] * TEST_BATCHES
    steps = cfg["num_decoder_layer"] * summary["steps"]
    want = {"fused_attention" + route_suffix(cfg): enc, "fused_ffn": enc,
            "decode_pool_attention": steps,
            "decode_pool_attention_relu": steps}
    if len(lines) != TEST_SENTENCES or summary["sentences"] \
            != TEST_SENTENCES or launches != want:
        raise AssertionError("ensemble: %d lines, launches %s, expected %s"
                             % (len(lines), launches, want))

    # small fp32 models: the card's ensemble decodes the CPU's sequences
    names = ("transformer", "transformer_rela")
    cfgs = [_small_model(0.0, n) for n in names]
    for c in cfgs:
        c.beam_size = 4
    cpu = [get_model(n).init_fn(torch.Generator().manual_seed(SEED + i), c)
           for i, (n, c) in enumerate(zip(names, cfgs))]
    gpu = [copy.deepcopy(p).cuda() for p in cpu]
    inf = train.make_ensemble_inference(
        [get_model(n).infer_fn(c) for n, c in zip(names, cfgs)])
    src = _small_batch()["source"]
    with torch.inference_mode():
        c = beam_search(cpu, src, inf, cfgs[0])
        for n in counters:
            n.clear()
        g = beam_search(gpu, src.cuda(), inf, cfgs[0])
    small = collect(counters)
    same = torch.equal(g["seq"].cpu(), c["seq"])
    score_err = (g["score"].cpu() - c["score"]).abs().max().item()
    small_want = {"fused_attention": 2, "fused_ffn": 2,
                  "decode_pool_attention": 2 * g["steps"],
                  "decode_pool_attention_relu": 2 * g["steps"]}
    phase("ensemble", models=list(names), sentences=summary["sentences"],
          bleu=summary["bleu"], decode_s=summary["seconds"],
          sentences_per_s=summary["sentences"] / summary["seconds"],
          target_tokens_per_s=summary["target_tokens"] / summary["seconds"],
          decode_steps=summary["steps"], launches=launches,
          small_same_sequences=same, small_max_score_err=score_err,
          small_launches=small)
    if not (same and score_err <= 1e-4 and small == small_want
            and torch.isfinite(g["score"]).all()):
        raise AssertionError("ensemble small models: card vs CPU sequences "
                             "equal %s, score err %.3g, launches %s, "
                             "expected %s" % (same, score_err, small,
                                              small_want))
    return launches


DEEP_CONFIG = os.path.join(REPO, "configs", "deep_transformer_fuse_l0drop.json")
# deep_train and l0drop_train (3 before the data-parallel phases came)
DEEP_STEPS = 2
MEMORY_STEPS = 2     # deep_memory, each setting
FIXUP_STEPS = 2
L0DROP_EXTRA = (",model_name=transformer_l0drop,scope_name=transformer_l0drop"
                + DEEP_CUT)
FIXUP_EXTRA = (",model_name=transformer_fixup,scope_name=transformer_fixup"
               + DEEP_CUT)
# deep_memory's settings: remat off, then each remat_policy
REMAT_SETTINGS = (("off", ",use_remat=false"),
                  ("nothing", ",remat_policy=nothing"),
                  ("dots", ",remat_policy=dots"),
                  ("dots_all", ",remat_policy=dots_all"))
MFU_NOTE = "model FLOPs (forward x3); use_remat's recompute not counted"


def deep_train_phase(d, da):
    """configs/deep_transformer_fuse_l0drop.json at DEEP_CUT's depth
    (transformer_fuse, 2+3, use_remat) DEEP_STEPS steps with both kernel
    flags on: per microbatch the encoder's #1 and #11 twice a layer (the
    recompute) and #2 and #12 once; the merged decoder takes no kernel.
    Then --mode test at beam 4 and --mode score (the encoder's #1 and #11,
    no decode kernel). Returns the training results."""
    return train_phase(d, da, DEEP_CONFIG, "deep_train",
                       encoder_expected_launches, DEEP_CUT,
                       flag_runs=("true",),
                       serving=encoder_serving, steps=DEEP_STEPS,
                       note=MFU_NOTE)[0]


def deep_memory_phase(d, da):
    """The deep config MEMORY_STEPS steps (both kernel flags on) with
    use_remat off, then under each remat_policy: peak memory allocated,
    median step and launches (#1 and #11 twice a layer under remat)."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    out = {}
    for name, extra in REMAT_SETTINGS:
        extra += DEEP_CUT
        cfg = load_config_file(DEEP_CONFIG)
        cfg.update(overrides(extra))
        path = os.path.join(d, "deep_memory_" + name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        summary, launches = train_run(d, path, "true", counters, DEEP_CONFIG,
                                      extra, MEMORY_STEPS)
        peak = torch.cuda.max_memory_allocated()
        shutil.rmtree(path)
        want = encoder_expected_launches(cfg, summary)
        ends = summary["step_end_times"]
        step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
        out[name] = dict(peak_gib=peak / 2 ** 30,
                         allocated_before_gib=before / 2 ** 30,
                         ms_per_step_median=1e3 * step_s[len(step_s) // 2],
                         loss_last=summary["losses"][-1], launches=launches)
        phase("deep_memory", remat=name, **out[name])
        if (summary["steps"] != MEMORY_STEPS or launches != want
                or not all(map(math.isfinite, summary["losses"]))):
            raise AssertionError("deep_memory %s: %d steps, losses %s, "
                                 "launches %s, expected %s"
                                 % (name, summary["steps"],
                                    summary["losses"], launches, want))
    return out


def l0drop_serving(cfg, served, serve_launches, score_launches):
    """Beam 4: the encoder's #1 and #11 once a layer per test batch, #8
    once per decoder layer and step (decode's cross attention and FFN take
    no kernel); scoring (l0_compact_ratio 0): every attention's #1 and
    FFN's #11 of the teacher-forced pass."""
    enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
    sfx = route_suffix(cfg)
    want = {"fused_attention" + sfx: enc * TEST_BATCHES,
            "fused_ffn": enc * TEST_BATCHES,
            "decode_pool_attention": dec * served["steps"]}
    score_want = {"fused_attention" + sfx: (enc + 2 * dec) * TEST_BATCHES,
                  "fused_ffn": (enc + dec) * TEST_BATCHES}
    if serve_launches != want or score_launches != score_want:
        raise AssertionError("l0drop_train: serving launched %s, expected "
                             "%s; scoring %s, expected %s"
                             % (serve_launches, want, score_launches,
                                score_want))


def l0drop_train_phase(d, da):
    """The deep config as transformer_l0drop DEEP_STEPS steps with both
    kernel flags on (every attention and FFN: 16 #1, 8 #2, 10 #11, 5 #12
    per microbatch at DEEP_CUT's 2+3 under use_remat), the expected-L0
    penalty of each step beside its loss; served at beam 4 (#8) and beam
    1 (#10), at l0_compact_ratio 0 and 0.5 (the compacted memory's count
    softmax on the composite), and scored; then one batch at the same
    widths whose gates are forced closed on a row. Returns (training
    results, beam-4 serving launches, beam-1 serving launches)."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.models import transformer_l0drop as l0mod
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    cfg = load_config_file(DEEP_CONFIG)
    cfg.update(overrides(L0DROP_EXTRA))
    penalties = []
    real_penalty = l0mod.l0_penalty

    def record(log_alpha, mask):
        penalty = real_penalty(log_alpha, mask)
        penalties.append(penalty.detach())
        return penalty

    with mock.patch.object(l0mod, "l0_penalty", record):
        results, served4 = train_phase(
            d, da, DEEP_CONFIG, "l0drop_train", expected_launches,
            L0DROP_EXTRA, ("true",), l0drop_serving, steps=DEEP_STEPS,
            note=MFU_NOTE)
    cycle = int(cfg["update_cycle"])
    per_step = [torch.stack(penalties[i:i + cycle]).mean().item()
                for i in range(0, len(penalties), cycle)]
    weight = [cfg["l0_norm_reg_scalar"] * min(
        max(step - cfg["l0_norm_start_reg_ramp_up"], 0)
        / max(cfg["l0_norm_end_reg_ramp_up"]
              - cfg["l0_norm_start_reg_ramp_up"], 1), 1.0)
        for step in (0, DEEP_STEPS - 1)]
    phase("l0drop_train", loss_first=results["loss_first"],
          loss_last=results["loss_last"], l0_penalty_first=per_step[0],
          l0_penalty_last=per_step[-1], l0_weight_first=weight[0],
          l0_weight_last=weight[1], penalty_steps=len(per_step))
    if len(per_step) != DEEP_STEPS or not all(map(math.isfinite, per_step)):
        raise AssertionError("l0drop_train: penalties %s" % per_step)
    enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
    served1 = None
    for beam, ratio in ((1, 0.0), (4, 0.5), (1, 0.5)):
        served, launches = serve_checkpoint(
            d, "l0drop_train", counters, beam=beam,
            extra=",l0_compact_ratio=%g" % ratio, tag="_ratio%g" % ratio)
        kernel = "decode_pool_attention" if beam > 1 else "decode_attention"
        want = {"fused_attention" + route_suffix(cfg): enc * TEST_BATCHES,
                "fused_ffn": enc * TEST_BATCHES,
                kernel: dec * served["steps"]}
        phase("l0drop_train", beam=beam, l0_compact_ratio=ratio,
              sentences_per_s=served["sentences"] / served["seconds"],
              decode_steps=served["steps"], served_bleu=served["bleu"],
              serve_launches=launches)
        if launches != want:
            raise AssertionError("l0drop_train beam %d ratio %g launched %s,"
                                 " expected %s" % (beam, ratio, launches,
                                                   want))
        if beam == 1 and ratio == 0.0:
            served1 = launches
    l0drop_closed_row(d, da)
    return results, served4, served1


def l0drop_closed_row(d, da):
    """One training batch of transformer_l0drop at the deep config's widths
    (bf16, both kernel flags, use_remat) whose gates are forced closed on
    row 0 (its noise set to 0): that row's memory is all pad, which the
    cross attention's #1/#2 take with uniform weights. The loss and every
    grad must be finite."""
    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops import l0norm
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.vocab import Vocab

    counters = (fa.launches, ff.launches, da.launches)
    values = load_config_file(DEEP_CONFIG)
    values.update(overrides(L0DROP_EXTRA))
    values.update(use_flash_attention=True, use_fused_ffn=True,
                  update_cycle=1)
    cfg = default_config().override_from_dict(values)
    cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d, "vocab.txt"))
    model = get_model("transformer_l0drop")
    params = model.init_fn(torch.Generator().manual_seed(SEED), cfg).cuda()
    feats = _full_width_batch()
    real_noise, real_gate = l0norm.uniform_noise, l0norm.hard_concrete_from_noise
    gates = []

    def closed_row0(words, shape, device):
        noise = real_noise(words, shape, device)
        noise[0] = 0.0
        return noise

    def spy(*args):
        gates.append(real_gate(*args))
        return gates[-1]

    for c in counters:
        c.clear()
    with mock.patch.object(l0norm, "uniform_noise", closed_row0), \
            mock.patch.object(l0norm, "hard_concrete_from_noise", spy):
        loss = model.train_fn(params, feats, cfg,
                              torch.Generator().manual_seed(SEED),
                              step=1000)["loss"]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    launches = collect(counters)
    want = expected_launches(values, {"steps": 1})
    out = dict(closed_row_gates_max=gates[0][0].max().item(),
               other_rows_open=int((gates[0][1:] > 0).sum().item()),
               loss=loss.item(),
               grads_finite=all(bool(torch.isfinite(g).all())
                                for g in grads),
               launches=launches)
    phase("l0drop_closed_row", **out)
    if not (out["closed_row_gates_max"] == 0.0 and out["other_rows_open"]
            and math.isfinite(out["loss"]) and out["grads_finite"]
            and launches == want):
        raise AssertionError("l0drop_closed_row: %s, expected launches %s"
                             % (out, want))
    del params, grads


def fixup_serving(cfg, served, serve_launches, score_launches):
    """Fixup's layers pass no kernel flag but use_flash_decode: beam 4
    runs #8 once per decoder layer and step, scoring no kernel."""
    want = {"decode_pool_attention": cfg["num_decoder_layer"]
            * served["steps"]}
    if serve_launches != want or score_launches:
        raise AssertionError("fixup_train: serving launched %s, expected "
                             "%s; scoring %s, expected none"
                             % (serve_launches, want, score_launches))


def fixup_train_phase(d, da):
    """The deep config's widths as transformer_fixup FIXUP_STEPS steps
    with both kernel flags on (no training kernel, as in the JAX package),
    then --mode test at beam 4 (#8) and --mode score. Returns the beam-4
    serving launches."""
    return train_phase(d, da, DEEP_CONFIG, "fixup_train", no_kernel,
                       FIXUP_EXTRA, ("true",), fixup_serving,
                       steps=FIXUP_STEPS, note=MFU_NOTE)[1]


def remat_reference(da, name, train_want, decode_want):
    """A small ``name`` model (_small_model) with dropout 0.1 and
    use_remat: train_fn loss and grads on the card (kernels, fp32) against
    the CPU (plain versions) on the same seed words, loss within 1e-5 and
    grads within 1e-4; beam 4 card against CPU, identical sequences; then
    in bf16 on the card (the tensor-core kernels) the checkpointed layers
    against the same layers without the checkpoint on the same words,
    grads within 1e-6 of their max."""
    import copy

    from zero_tpu_torch.models import common, get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.search import beam_search

    counters = (fa.launches, ff.launches, da.launches)
    model = get_model(name)
    feats = _small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    cfg = _small_model(0.1, name)
    cfg.use_remat = True

    def run(params, batch, config):
        loss = model.train_fn(params, batch, config,
                              torch.Generator().manual_seed(SEED),
                              step=100)["loss"]
        return loss, torch.autograd.grad(loss, list(params.parameters()))

    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    lc, gc = run(cpu, feats, cfg)
    for c in counters:
        c.clear()
    lg, gg = run(gpu, gfeats, cfg)
    train_launches = collect(counters)
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    errs = grad_errors(cpu, gc, gg)
    worst = max(errs, key=errs.get)
    cfg.beam_size = 4
    inf = model.infer_fn(cfg)
    with torch.inference_mode():
        c = beam_search(cpu, feats["source"], inf, cfg)
        for n in counters:
            n.clear()
        g = beam_search(gpu, gfeats["source"], inf, cfg)
    decode_launches = collect(counters)
    same = torch.equal(g["seq"].cpu(), c["seq"])

    cfg16 = _small_model(0.1, name)
    cfg16.use_remat = True
    cfg16.default_dtype = "bfloat16"
    for n in counters:
        n.clear()
    l1, g1 = run(gpu, gfeats, cfg16)
    bf16_launches = collect(counters)
    with mock.patch.object(common, "remat_layer",
                           lambda layer, ctx, fn, *args: fn(layer, *args)):
        l0, g0 = run(gpu, gfeats, cfg16)
    top = max(b.abs().max().item() for b in g0)
    gap = max((a - b).abs().max().item() for a, b in zip(g1, g0)) / top
    out = dict(loss_rel_err=loss_err, grad_rel_err=errs[worst], worst=worst,
               train_launches=train_launches, beam4_same_sequences=same,
               beam4_steps=g["steps"], decode_launches=decode_launches,
               bf16_remat_loss_gap=abs(l1.item() - l0.item()),
               bf16_remat_grad_gap=gap, bf16_launches=bf16_launches)
    bf16_want = {(k + "_tc" if k.startswith("fused_attention") else k): v
                 for k, v in train_want.items()}
    if not (loss_err <= 1e-5 and errs[worst] <= 1e-4
            and train_launches == train_want and same
            and bf16_launches == bf16_want
            and decode_launches == decode_want(g["steps"])
            and torch.isfinite(g["score"]).all() and math.isfinite(l1.item())
            and gap <= 1e-6):
        raise AssertionError("%s remat reference: %s" % (name, out))
    return out


def deep_reference_phase(da):
    """Small transformer_fuse, transformer_l0drop and transformer_fixup
    models (2+2 layers) under use_remat with dropout on: card against CPU
    and, in bf16, the checkpoint against none (remat_reference). fp32
    takes the CUDA-core #1/#2 and #11/#12, forwards twice a layer."""
    n = 2   # layers a side of _small_model
    phase("deep_reference", model="transformer_fuse", **remat_reference(
        da, "transformer_fuse",
        {"fused_attention": 2 * n, "fused_attention_backward": n,
         "fused_ffn": 2 * n, "fused_ffn_backward": n},
        lambda steps: {"fused_attention": n, "fused_ffn": n}))
    phase("deep_reference", model="transformer_l0drop", **remat_reference(
        da, "transformer_l0drop",
        {"fused_attention": 2 * 3 * n, "fused_attention_backward": 3 * n,
         "fused_ffn": 2 * 2 * n, "fused_ffn_backward": 2 * n},
        lambda steps: {"fused_attention": n, "fused_ffn": n,
                       "decode_pool_attention": n * steps}))
    phase("deep_reference", model="transformer_fixup", **remat_reference(
        da, "transformer_fixup", {},
        lambda steps: {"decode_pool_attention": n * steps}))


# the copy task's steps (700 until the tensor- and expert-parallel phases
# came; BLEU 0.968 at 450 on the CPU)
CONVERGE_STEPS = 550


def converge_phase(d):
    """The copy task through --mode train on the card, both flags on."""
    from zero_tpu_torch import run

    rs = np.random.RandomState(3)
    words = ["tok%d" % i for i in range(12)]
    with open(os.path.join(d, "vocab.txt"), "w") as w:
        w.write("\n".join(["<pad>", "<unk>", "<eos>"] + words) + "\n")
    for name, n in (("train", 400), ("dev", 16), ("test", 16)):
        lines = [" ".join(rs.choice(words, rs.randint(3, 8)))
                 for _ in range(n)]
        for side in ("src", "tgt"):
            with open(os.path.join(d, "%s.%s" % (name, side)), "w") as w:
                w.write("\n".join(lines) + "\n")
    spec = ("model_name=transformer,hidden_size=32,embed_size=32,"
            "filter_size=64,num_heads=2,num_encoder_layer=1,"
            "num_decoder_layer=1,dropout=0.0,residual_dropout=0.0,"
            "relu_dropout=0.0,attention_dropout=0.0,max_len=16,"
            "batch_or_token=batch,batch_size=32,eval_batch_size=16,"
            "beam_size=2,decode_length=12,decode_max_len=24,lrate=3e-3,"
            "lrate_strategy=vanilla,max_training_steps=%d,disp_freq=200,"
            "save_freq=300,eval_freq=350,sample_freq=300,epoches=200,"
            "pad_seq_multiple=4,pad_batch_multiple=4,"
            "use_flash_attention=true,use_fused_ffn=true,"
            "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "src_dev_file={0}/dev.src,tgt_dev_file={0}/dev.tgt,"
            "output_dir={0}/out".format(d) % CONVERGE_STEPS)
    t0 = time.time()
    summary = run.main(["--mode", "train", "--parameters", spec])
    if not (summary["bleu"] is not None and summary["bleu"] >= 0.95):
        raise AssertionError("copy task BLEU %s < 0.95" % summary["bleu"])
    phase("converge", steps=summary["steps"], bleu=summary["bleu"],
          loss_last=summary["losses"][-1], wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# long sequences: streaming attention (#5-#7), cross-attention decode (#9)
# ---------------------------------------------------------------------------

# (name, B, H, Lq, Lk, Dh, causal, pad mask with an all-pad row): decoder
# self-attention past the fused kernels' 8192 keys; encoder self-attention
# under a pad mask; cross attention of a short target over a 16k memory
LONG_CASES = (("causal_8320", 1, 8, 8320, 8320, 64, True, False),
              ("pad_8320", 2, 4, 8320, 8320, 64, False, True),
              ("cross_256x16384", 1, 8, 256, 16384, 64, False, True))
# bf16 only, checked and not timed: lengths off the tensor-core kernels'
# 64- and 128-row tiles (the cross case has B=2 so that its pad mask holds
# an all-pad row beside a ragged one), the other head depths they take
# (16-column steps, padded to 64 or 128 in shared memory), and depths they
# do not take, where bf16 keeps the CUDA-core #5-#7 (route)
BF16_CHECK_CASES = (("ragged_causal_8259", 1, 2, 8259, 8259, 64, True,
                     False),
                    ("ragged_cross_333x8259", 2, 2, 333, 8259, 64, False,
                     True),
                    ("dh128_causal_300", 1, 2, 300, 300, 128, True, False),
                    ("dh32_pad_200x333", 2, 2, 200, 333, 32, False, True),
                    ("dh80_pad_136", 2, 1, 136, 136, 80, False, True),
                    ("dh40_pad_136", 2, 1, 136, 136, 40, False, True),
                    ("dh256_causal_200", 1, 2, 200, 200, 256, True, False))
# (B, beams, S): transformer-base MT decode and the long-memory serving shape
CROSS_CASES = ((32, 4, 64), (4, 4, 16384))
# checked, not timed: the last batch row's memory fully masked (it averages
# all S positions), split over S; 5 beams (two beam groups, the second of
# one beam) and one beam
CROSS_CHECK_CASES = ((3, 5, 3000), (2, 1, 700))
LONG_STEPS = 2
LONG_PARAMS = ("use_flash_attention=true,max_len=16384,token_size=16384,"
               "pad_seq_multiple=128")


def plain_stream(q, k, v, pad_mask=None, *, causal=False, dropout_rate=0.0,
                 rng=None, heads=None, qrows=None):
    """streaming_attention's interface over its plain version: from the
    same seed words it draws the kernels' dropout masks."""
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    pad = (torch.ones(q.shape[0], k.shape[2], device=q.device)
           if pad_mask is None else pad_mask.float())
    rate = dropout_rate if rng is not None else 0.0
    return sa.streaming_attention_ref(q, k, v, pad, causal, rate, rng,
                                      heads=heads, qrows=qrows)


def streaming_rows(sa, gen):
    """Kernels #5-#7 against streaming_attention_ref on the route ``route``
    picks (bf16 at Dh 64: the tensor-core ones; fp32: the CUDA-core ones);
    bf16 timings."""
    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    cases = [(c, dt) for c in LONG_CASES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(c, torch.bfloat16) for c in BF16_CHECK_CASES]
    for (name, b, h, lq, lk, dh, causal, padded), dtype in cases:
        def inputs():
            q = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
            k = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
            v = torch.randn(b, h, lk, dh, generator=gen).to(dev, dtype)
            pad = attention_pad(gen, b, lk, padded)
            do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
            return [t.requires_grad_() for t in (q, k, v)] + [
                pad.to(dev), do]

        for rate in (0.0, 0.1):
            q, k, v, pad, do = inputs()
            words = SEED_WORDS if rate else None
            sa.launches.clear()
            out = sa.streaming_attention(q, k, v, pad, causal=causal,
                                         dropout_rate=rate, rng=words)
            grads = torch.autograd.grad(out, (q, k, v), do)
            suffix = {"tensor_cores": "_tc", "cuda_cores": ""}[
                sa.route("cuda", dtype, dh)]
            want = {"streaming_attention" + suffix: 1,
                    "streaming_attention_dq" + suffix: 1,
                    "streaming_attention_dkdv" + suffix: 1}
            if dict(sa.launches) != want:
                raise AssertionError("streaming_attention %s %s: "
                                     "launches %s, expected %s" % (
                                         name, dtype, dict(sa.launches),
                                         want))
            ref = sa.streaming_attention_ref(q, k, v, pad, causal, rate,
                                             words)
            rgrads = torch.autograd.grad(ref, (q, k, v), do)
            label = "%s[%s,p=%g]" % (name, str(dtype)[6:], rate)
            errs = [check("streaming_attention " + label, out, ref,
                          dtype, TRAIN_TOLERANCE)]
            errs += [check("streaming_attention_backward %s d%s"
                           % (label, w), g, r, dtype, TRAIN_TOLERANCE)
                     for w, g, r in zip("qkv", grads, rgrads)]
            if not all(torch.isfinite(x).all() for x in (out,) + grads):
                raise AssertionError("streaming_attention %s: non-finite"
                                     " output or gradient" % label)
            if padded and b > 1 and (grads[0][-1].any()
                                     or grads[1][-1].any()):
                raise AssertionError("streaming_attention %s: the all-pad "
                                     "batch row has nonzero dq or dk" % label)
            del out, grads, ref, rgrads
            if dtype != torch.bfloat16 or (name, b, h, lq, lk, dh,
                                           causal, padded) \
                    in BF16_CHECK_CASES:
                phase("long_kernels", kernel="streaming_attention",
                      case=label, max_abs_err=errs[0],
                      backward_max_abs_err=max(errs[1:]),
                      kernels=sorted(want))
                continue
            rows.update(time_streaming(sa, sdpa, name, inputs, pad,
                                       h, lq, lk, dh, causal, rate,
                                       words, errs))
            torch.cuda.empty_cache()
    return rows


def time_streaming(sa, sdpa, name, inputs, pad, h, lq, lk, dh, causal,
                   rate, words, errs):
    """Device times of the tensor-core #5, #6 and #7 alone, of the
    CUDA-core #5, #6 and #7 on the same inputs (``parent_ms``: what ran
    before the tensor-core kernels), of the plain version's forward and
    backward,
    and of SDPA (dropout off), beside each bound: the bytes of each input
    once and each output once, and the products over the (row, key) pairs
    the output needs (4 flops per pair and depth forward, 6 for #6: s, dP,
    dQ; 8 for #7: s, dP, dV, dK)."""
    b = pad.shape[0]
    pairs = attention_pairs(pad, h, lq, causal)
    dtype = torch.bfloat16
    eb = 2
    qb, kb = b * h * lq * dh * eb, b * h * lk * dh * eb
    rows_f32 = 4 * b * h * lq
    sets = copies(inputs, 2 * qb + 2 * kb)
    f_args = [(s[0].detach(), s[1].detach(), s[2].detach(), s[3], bool(causal),
               rate, sa.kernel_words(words, s[0].shape, rate)) for s in sets]
    fwds = [sa._forward_tc(*a) for a in f_args]
    dq_args = [a[:4] + (o, s[4], m, l) + a[4:]
               for a, (o, m, l), s in zip(f_args, fwds, sets)]
    deltas = [sa._backward_dq_tc(*a)[1] for a in dq_args]
    kv_args = [a[:4] + (s[4], m, l, delta) + a[4:]
               for a, (o, m, l), s, delta in zip(f_args, fwds, sets, deltas)]

    def p_fwd(q, k, v, pad, do):
        return sa.streaming_attention_ref(q, k, v, pad, causal, rate, words)

    def l_fwd(q, k, v, pad, do):
        if causal:
            return sdpa(q, k, v, is_causal=True)
        return sdpa(q, k, v, attn_mask=(pad > 0)[:, None, None])

    iters = 2 * len(sets)
    plain_bwd = device_ms(lambda run: run(), [(grad_ms(p_fwd(*s), s[:3],
                                                       s[4]),)
                                              for s in sets], iters)
    out = {}
    for key, fn, parent, args, nbytes, flops in (
            ("streaming_attention_tc", sa._forward_tc, sa._forward, f_args,
             2 * qb + 2 * kb + rows_f32 * 2 + 4 * b * lk, 4 * pairs * dh),
            ("streaming_attention_dq_tc", sa._backward_dq_tc,
             sa._backward_dq, dq_args,
             4 * qb + 2 * kb + rows_f32 * 3 + 4 * b * lk, 6 * pairs * dh),
            ("streaming_attention_dkdv_tc", sa._backward_dkdv_tc,
             sa._backward_dkdv, kv_args,
             2 * qb + 4 * kb + rows_f32 * 3 + 4 * b * lk, 8 * pairs * dh)):
        bound_ms, bound_by = bound(nbytes, flops, dtype)
        r = dict(ms=device_ms(fn, args, iters), bound_ms=bound_ms,
                 bound_by=bound_by)
        r["parent_ms"] = device_ms(parent, args, iters)
        if key == "streaming_attention_tc":
            r.update(plain_ms=device_ms(p_fwd, sets, iters),
                     max_abs_err=errs[0])
        else:
            # the plain version's backward computes dq, dk and dv at once
            r.update(plain_ms=plain_bwd, max_abs_err=max(errs[1:]))
        if rate == 0.0:
            if key == "streaming_attention_tc":
                r["library_ms"] = device_ms(l_fwd, sets, iters)
            else:
                r["library_ms"] = device_ms(
                    lambda run: run(), [(grad_ms(l_fwd(*s), s[:3], s[4]),)
                                        for s in sets], iters)
        phase("long_kernels", kernel=key, case="%s[bf16,p=%g]" % (name, rate),
              **r)
        out[(key, name, rate)] = r
    return out


def cross_rows(da, gen):
    """Kernel #9 against decode_cross_attention_ref; bf16 timings beside
    the composite cross_attn_step runs (_attn_core over the beam-folded
    queries) and SDPA, and the memory splits the wrapper launched (null
    for a checkout that records none)."""
    from zero_tpu_torch.ops import attention as attn

    dev = "cuda"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dh = HIDDEN // HEADS
    taken = getattr(da, "taken", {})
    rows = {}
    for b, beams, s_len in CROSS_CASES + CROSS_CHECK_CASES:
        masked = (b, beams, s_len) in CROSS_CHECK_CASES
        for dtype in (torch.float32, torch.bfloat16):
            def inputs():
                q = torch.randn(b, beams, HIDDEN, generator=gen).to(dev,
                                                                    dtype)
                mk = torch.randn(b, s_len, HIDDEN, generator=gen).to(dev,
                                                                     dtype)
                mv = torch.randn(b, s_len, HIDDEN, generator=gen).to(dev,
                                                                     dtype)
                lens = torch.randint(s_len // 2, s_len + 1, (b,),
                                     generator=gen)
                mask = (torch.arange(s_len)[None] < lens[:, None]).float()
                if masked:
                    mask[-1] = 0.0
                return q, mk, mv, mask.to(dev)

            args = inputs()
            label = "B%d_beams%d_S%d%s[%s]" % (
                b, beams, s_len, "_masked_row" if masked else "",
                str(dtype)[6:])
            taken.clear()
            out = da.decode_cross_attention(*args, HEADS)
            splits = taken.get("decode_cross_attention")
            err = check("decode_cross_attention " + label, out,
                        da.decode_cross_attention_ref(*args, HEADS), dtype)
            if masked:
                # the fully masked row: every position's weight 1/S
                check("decode_cross_attention %s masked row" % label, out[-1],
                      args[2][-1].float().mean(0).expand(beams, HIDDEN),
                      dtype)
            if dtype != torch.bfloat16 or masked:
                phase("long_kernels", kernel="decode_cross_attention",
                      case=label, max_abs_err=err, splits=splits)
                continue
            sets = copies(inputs, 2 * b * s_len * HIDDEN * 2)

            def k_cross(q, mk, mv, mask):
                return da.decode_cross_attention(q, mk, mv, mask, HEADS)

            def p_cross(q, mk, mv, mask):
                return da.decode_cross_attention_ref(q, mk, mv, mask, HEADS)

            def c_cross(q, mk, mv, mask):
                return attn._attn_core(q, mk, mv, mask[:, None, None, :],
                                       HEADS)[0]

            def heads(x):
                return x.view(x.shape[0], x.shape[1], HEADS,
                              dh).transpose(1, 2)

            lsets = [(heads(q), heads(mk), heads(mv),
                      (mask > 0)[:, None, None, :])
                     for q, mk, mv, mask in sets]

            def l_cross(q, k, v, keep):
                return sdpa(q, k, v, attn_mask=keep)

            iters = 3 * len(sets)
            nbytes = (2 * b * s_len * HIDDEN + 2 * b * beams * HIDDEN) * 2 \
                + 4 * b * s_len
            b_ms, b_by = bound(nbytes, 4 * b * beams * s_len * HIDDEN, dtype)
            r = dict(max_abs_err=err, ms=device_ms(k_cross, sets, iters),
                     plain_ms=device_ms(p_cross, sets, iters),
                     composite_ms=device_ms(c_cross, sets, iters),
                     library_ms=device_ms(l_cross, lsets, iters),
                     bound_ms=b_ms, bound_by=b_by, splits=splits)
            phase("long_kernels", kernel="decode_cross_attention",
                  case=label, **r)
            rows[("decode_cross_attention", s_len)] = r
            del sets, lsets
            torch.cuda.empty_cache()
    return rows


def long_kernels_phase(da, streaming=True):
    """#5-#7 (unless not ``streaming``: under --package only #9 runs, on
    the same inputs as here, since the streaming rows draw no inputs #9
    reads) and #9."""
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    gen = torch.Generator().manual_seed(SEED + 4)
    rows = streaming_rows(sa, gen) if streaming else {}
    if streaming:
        stream_split_check(sa, gen)
        ring_kernel_checks(sa, gen)
        seq_block_checks(gen)
        torch.cuda.empty_cache()
    rows.update(cross_rows(da, torch.Generator().manual_seed(SEED + 5)))
    return rows


def stream_split_check(sa, gen):
    """#5-#7 over the second half of LONG_CASES' padded case's heads (B =
    2, so the offset moves the second batch row's heads too; the
    tensor-core kernels in bf16), dropout on."""
    dev, dtype, rate = "cuda", torch.bfloat16, SPLIT_RATE
    name, b, h, lq, lk, dh, causal, padded = LONG_CASES[1]
    q, k, v = (torch.randn(b, h, n, dh, generator=gen).to(
        dev, dtype).requires_grad_() for n in (lq, lk, lk))
    do = torch.randn(b, h, lq, dh, generator=gen).to(dev, dtype)
    pad = attention_pad(gen, b, lk, padded).to(dev)

    def launch(q, k, v, heads):
        return sa.streaming_attention(q, k, v, pad, causal=causal,
                                      dropout_rate=rate, rng=SEED_WORDS,
                                      heads=heads)

    def plain(q, k, v, heads):
        return sa.streaming_attention_ref(q, k, v, pad, causal, rate,
                                          SEED_WORDS, heads=heads)

    check_head_split("long_kernels", "streaming_attention", name, launch,
                     plain, q, k, v, do, (), (h // 2, h),
                     {"streaming_attention_tc": 1,
                      "streaming_attention_dq_tc": 1,
                      "streaming_attention_dkdv_tc": 1}, sa.launches)
    torch.cuda.empty_cache()


def write_long_corpus(d, words):
    """Training pairs (one per microbatch: LONG_STEPS steps of update_cycle
    4) and four test pairs, 8200 to 16000 tokens a side, from SEED."""
    rs = np.random.RandomState(SEED + 3)
    for prefix, n in (("long_train", 4 * LONG_STEPS), ("long_test", 4)):
        for side in ("src", "tgt"):
            with open(os.path.join(d, "%s.%s" % (prefix, side)), "w") as w:
                for _ in range(n):
                    length = rs.randint(8200, 16001)
                    w.write(" ".join(words[i] for i in rs.randint(
                        0, len(words), length)) + "\n")


def long_train_phase(d, da):
    """--mode train of transformer-base on the long pairs (at BASE_CUT,
    for the script's time), then --mode score and --mode test of its
    checkpoint; returns the train run's launch counts."""
    from zero_tpu_torch import run
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    cfg = load_config_file(CONFIG)
    cfg.update(overrides(BASE_CUT))
    counters = (sa.launches, fa.launches, ff.launches, da.launches)
    files = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
             "output_dir={0}/long_model,".format(d))
    spec = (files + LONG_PARAMS + ",src_train_file={0}/long_train.src,"
            "tgt_train_file={0}/long_train.tgt,lrate_strategy=vanilla,"
            "lrate=1e-3,max_training_steps={1},disp_freq=1,save_freq=0,"
            "eval_freq=0,sample_freq=0,epoches=100".format(d, LONG_STEPS)
            + BASE_CUT)
    for c in counters:
        c.clear()
    torch.cuda.reset_peak_memory_stats()
    summary = run.main(["--mode", "train", "--config", CONFIG,
                        "--parameters", spec])
    torch.cuda.synchronize()
    launches = collect(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = summary["losses"]
    if summary["steps"] != LONG_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError("long_train: %d steps, losses %s (finite and "
                             "falling wanted)" % (summary["steps"], losses))
    shapes = summary["shapes"]
    lengths = [stacked_shape(s)[1:] for s in shapes]
    if min(min(x) for x in lengths) <= 8192:
        raise AssertionError("long_train: stacked lengths %s, wanted > 8192"
                             % lengths)
    microbatches = cfg["update_cycle"] * summary["steps"]
    attn = cfg["num_encoder_layer"] + 2 * cfg["num_decoder_layer"]
    # bf16 at Dh 64: the tensor-core #5-#7, no CUDA-core kernel
    suffix = {"tensor_cores": "_tc", "cuda_cores": ""}[sa.route(
        "cuda", getattr(torch, cfg["default_dtype"]),
        cfg["hidden_size"] // cfg["num_heads"])]
    fwd_key = "streaming_attention" + suffix
    want = {k + suffix: attn * microbatches for k in (
        "streaming_attention", "streaming_attention_dq",
        "streaming_attention_dkdv")}
    if launches != want:
        raise AssertionError("long_train launches %s, expected %s (no plain "
                             "version, no CUDA-core kernel)"
                             % (launches, want))
    ends = summary["step_end_times"]
    step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
    timed = sum(step_s)
    flops = [model_flops(s, cfg) for s in shapes]
    phase("long_train", steps=summary["steps"], stacked_lengths=lengths,
          ms_per_step_median=1e3 * step_s[len(step_s) // 2],
          ms_per_step_mean=1e3 * timed / len(step_s),
          target_tokens_per_s=sum(summary["target_tokens"][1:]) / timed,
          model_tflop_per_step=sum(flops) / len(flops) / 1e12,
          mfu=sum(flops[1:]) / timed / PEAK_BF16, losses=losses,
          gnorms=summary["gnorms"], launches=launches, peak_gib=peak)

    # score and serve the checkpoint on four long pairs, two per batch
    spec = (files + "src_test_file={0}/long_test.src,"
            "tgt_test_file={0}/long_test.tgt,eval_batch_size=2,"
            "eval_max_len=16384,beam_size=4".format(d))
    for c in counters:
        c.clear()
    scores, ppl = run.main(["--mode", "score", "--parameters", spec
                            + ",test_output=%s/long_scores.txt" % d])
    score_launches = collect(counters)
    if len(scores) != 4 or not all(map(math.isfinite, scores)) \
            or score_launches != {fwd_key: attn * 2}:
        raise AssertionError("long_train scoring: %s, launches %s"
                             % (scores, score_launches))
    for c in counters:
        c.clear()
    served = run.main(["--mode", "test", "--parameters", spec
                       + ",test_output=%s/long_trans.txt" % d])
    serve_launches = collect(counters)
    with open(os.path.join(d, "long_trans.txt")) as r:
        lines = r.read().splitlines()
    layers = cfg["num_decoder_layer"]
    want = {fwd_key: cfg["num_encoder_layer"] * 2,
            "decode_pool_attention": layers * served["steps"]}
    if len(lines) != 4 or served["sentences"] != 4 \
            or serve_launches != want:
        raise AssertionError("long_train serving: %d lines, launches %s, "
                             "expected %s" % (len(lines), serve_launches,
                                              want))
    phase("long_train", scored=len(scores), score_ppl=ppl,
          score_launches=score_launches, served_sentences=len(lines),
          served_s=served["seconds"], decode_steps=served["steps"],
          serve_launches=serve_launches)
    return launches


def _long_small_batch():
    """Six rows of 160 source and 136 target positions (random lengths,
    the last row all padding), from SEED."""
    rs = np.random.RandomState(SEED + 5)
    src = rs.randint(3, 43, (6, 160))
    tgt = rs.randint(3, 43, (6, 136))
    for i, (ns, nt) in enumerate(zip(rs.randint(70, 161, 6),
                                     rs.randint(70, 137, 6))):
        src[i, ns:] = 0
        tgt[i, nt:] = 0
    src[-1] = 0
    tgt[-1] = 0
    return {"source": torch.as_tensor(src), "target": torch.as_tensor(tgt)}


def long_reference_phase(da):
    """A small fp32 model whose every attention streams (fa.MAX_LK lowered
    to 64, lengths 136-160): train_fn card (kernels) against CPU (plain
    versions), dropout on kernels against plain versions on the card, and
    beam 4 card against CPU."""
    import copy

    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa
    from zero_tpu_torch.search import beam_search

    model = get_model("transformer")
    feats = _long_small_batch()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    with mock.patch.object(fa, "MAX_LK", 64):
        cfg = _small_model(0.0)
        cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
        gpu = copy.deepcopy(cpu).cuda()
        sa.launches.clear()
        fa.launches.clear()
        lc = model.train_fn(cpu, feats, cfg, None)["loss"]
        gc = torch.autograd.grad(lc, list(cpu.parameters()))
        lg = model.train_fn(gpu, gfeats, cfg, None)["loss"]
        gg = torch.autograd.grad(lg, list(gpu.parameters()))
        loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
        errs = grad_errors(cpu, gc, gg)
        worst = max(errs, key=errs.get)
        want = {"streaming_attention_ref": 6, "streaming_attention": 6,
                "streaming_attention_dq": 6, "streaming_attention_dkdv": 6}
        if not (loss_err <= 1e-4 and errs[worst] <= 1e-4
                and collect([sa.launches, fa.launches]) == want):
            raise AssertionError("long_reference: loss rel err %.3g, grad "
                                 "rel err %.3g (%s), launches %s %s" % (
                                     loss_err, errs[worst], worst,
                                     dict(sa.launches), dict(fa.launches)))

        # dropout on: kernels against plain versions on the card, same words
        cfg = _small_model(0.1)
        losses = []
        for plain in (False, True):
            sa.launches.clear()
            with mock.patch.object(sa, "streaming_attention",
                                   plain_stream if plain
                                   else sa.streaming_attention), \
                    mock.patch.object(ff, "fused_ffn",
                                      plain_ffn if plain else ff.fused_ffn):
                loss = model.train_fn(gpu, gfeats, cfg,
                                      torch.Generator().manual_seed(SEED))
            losses.append(loss["loss"].item())
            key = "streaming_attention" + ("_ref" if plain else "")
            if sa.launches[key] != 6:
                raise AssertionError("long_reference: dropout run launched "
                                     "%s" % dict(sa.launches))
        drop_err = abs(losses[0] - losses[1]) / abs(losses[1])
        if not drop_err <= 1e-5:
            raise AssertionError("long_reference: dropout-on loss kernels %r"
                                 " vs plain %r" % tuple(losses))

        # beam 4: the encoder streams (#5), decoding runs the pool kernel
        cfg.beam_size = 4
        cfg.decode_max_len = 24
        inf = model.infer_fn(cfg)
        sa.launches.clear()
        da.launches.clear()
        with torch.inference_mode():
            g = beam_search(gpu, gfeats["source"], inf, cfg)
            c = beam_search(cpu, feats["source"], inf, cfg)
        same = torch.equal(g["seq"].cpu(), c["seq"])
        score_err = (g["score"].cpu() - c["score"]).abs().max().item()
        if not (same and score_err <= 1e-4
                and sa.launches["streaming_attention"] == 2
                and da.launches["decode_pool_attention"] > 0
                and torch.isfinite(g["score"]).all()):
            raise AssertionError("long_reference beam 4: card vs CPU "
                                 "sequences equal %s, score err %.3g, "
                                 "launches %s %s" % (
                                     same, score_err, dict(sa.launches),
                                     dict(da.launches)))
        bf16 = long_reference_bf16(model, gfeats, sa)
    phase("long_reference", loss_rel_err=loss_err, grad_rel_err=errs[worst],
          worst=worst, dropout_loss_kernels=losses[0],
          dropout_loss_plain=losses[1], dropout_rel_err=drop_err,
          beam4_same_sequences=same, beam4_max_score_err=score_err,
          beam4_steps=g["steps"], bf16=bf16)


class _PlainBackward(torch.autograd.Function):
    """A forward kernel (#1 or #5, on the route its wrapper picks), and the
    plain version's backward (fused_attention_ref's or
    streaming_attention_ref's autograd, recomputed) in place of #2 or
    #6/#7."""

    @staticmethod
    def forward(ctx, q, k, v, pad, causal, rate, words, fused):
        from zero_tpu_torch.ops.kernels import fused_attention as fa
        from zero_tpu_torch.ops.kernels import streaming_attention as sa

        tc = sa.route("cuda", q.dtype, q.shape[-1]) == "tensor_cores"
        if fused:
            fwd = fa._forward_tc if tc else fa._forward
        else:
            fwd = sa._forward_tc if tc else sa._forward
        o = fwd(*map(sa._aligned, (q, k, v)), pad, causal, rate,
                sa.kernel_words(words, q.shape, rate))[0]
        ctx.save_for_backward(q, k, v, pad)
        ctx.args = (causal, rate, words)
        ctx.fused = fused
        return o

    @staticmethod
    def backward(ctx, do):
        from zero_tpu_torch.ops.kernels import fused_attention as fa
        from zero_tpu_torch.ops.kernels import streaming_attention as sa

        ref = fa.fused_attention_ref if ctx.fused \
            else sa.streaming_attention_ref
        q, k, v, pad = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            grads = torch.autograd.grad(ref(*leaves, pad, *ctx.args),
                                        leaves, do)
        return tuple(grads) + (None,) * 5


def _plain_backward(q, k, v, pad_mask, causal, dropout_rate, rng, fused):
    pad = (torch.ones(q.shape[0], k.shape[2], device=q.device)
           if pad_mask is None else pad_mask.float()).contiguous()
    rate = float(dropout_rate) if (rng is not None
                                   and 0.0 < dropout_rate < 1.0) else 0.0
    words = tuple(rng) if rate else None
    return _PlainBackward.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), pad, bool(causal), rate,
                                words, fused)


def plain_backward_stream(q, k, v, pad_mask=None, *, causal=False,
                          dropout_rate=0.0, rng=None, heads=None,
                          qrows=None):
    """streaming_attention's interface (every head, every query): the
    forward kernel, the plain version's backward (the same dropout masks
    from the same words)."""
    assert heads is None and qrows is None
    return _plain_backward(q, k, v, pad_mask, causal, dropout_rate, rng,
                           False)


def plain_backward_fused(q, k, v, pad_mask=None, *, causal=False,
                         dropout_rate=0.0, rng=None, rpr_tables=None,
                         max_relative_position=None, heads=None,
                         qrows=None):
    """fused_attention's interface (no RPR, every head, every query): the
    forward kernel, the plain version's backward (the same dropout masks
    from the same words)."""
    assert rpr_tables is None and heads is None and qrows is None
    return _plain_backward(q, k, v, pad_mask, causal, dropout_rate, rng,
                           True)


def bf16_runs(model, params, gfeats, cfg, module, name, fns, counters):
    """train_fn's loss, grads (on the CPU) and launch counts with
    ``module.name`` patched to each of ``fns`` in turn."""
    runs = []
    for fn in fns:
        for c in counters:
            c.clear()
        with mock.patch.object(module, name, fn):
            loss = model.train_fn(params, gfeats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
            grads = torch.autograd.grad(loss, list(params.parameters()))
        runs.append((loss.item(), [g.cpu() for g in grads],
                     collect(counters)))
    return runs


def bf16_errors(model, test, ref):
    """Loss and grad errors of the ``test`` run against the ``ref`` run
    (bf16_runs entries)."""
    (lt, gt, _), (lr, gr, _) = test, ref
    errs = bf16_grad_errors(model, gt, gr)
    worst = max(errs, key=errs.get)
    return dict(loss_rel_err=abs(lt - lr) / abs(lr), grad_rel_err=errs[worst],
                grad_worst=sorted(errs, key=errs.get)[-3:])


def long_reference_bf16(model, gfeats, sa):
    """bf16 at head depth 64 (hidden 128, 2 heads), every attention
    streaming: train_fn with the tensor-core #6/#7 against the plain
    version's backward on the card, dropout off and on from the same seed
    words. The tensor-core forward kernel #5 and the FFN kernels run on
    both sides, as train_reference's bf16 check
    keeps the attention kernels on both sides: with the forward switched
    to the plain version too, its one-ulp bf16 rounding differences alone
    move the decoder FFN's grads by ~4% of their scale, as much as the
    plain version's bf16 run differs from its fp32 run (``full_path``
    reports that comparison, the whole kernel path against the whole plain
    version). Bounds of train_reference's bf16 FFN check: loss within 1e-2
    relative, grads within 2e-2 of their scale (grad_errors; the
    cross-attention key bias on the model's largest)."""
    small, out = None, {}
    for rate in (0.0, 0.1):
        cfg = _small_model(rate)
        for key, val in dict(hidden_size=128, embed_size=128, filter_size=256,
                             num_heads=2).items():
            setattr(cfg, key, val)
        if small is None:
            small = model.init_fn(torch.Generator().manual_seed(SEED),
                                  cfg).cuda()
        cfg.default_dtype = "bfloat16"
        kern, plain_bwd, plain = bf16_runs(
            model, small, gfeats, cfg, sa, "streaming_attention",
            (sa.streaming_attention, plain_backward_stream, plain_stream),
            [sa.launches])
        out["p=%g" % rate] = r = dict(
            loss_kernels=kern[0], loss_plain=plain_bwd[0],
            **bf16_errors(small, kern, plain_bwd),
            full_path=bf16_errors(small, kern, plain))
        want = {"streaming_attention_tc": 6, "streaming_attention_dq_tc": 6,
                "streaming_attention_dkdv_tc": 6}
        if not (r["loss_rel_err"] <= 1e-2 and r["grad_rel_err"] <= 2e-2
                and kern[2] == want
                and plain_bwd[2] == {"streaming_attention_tc": 6,
                                     "streaming_attention_ref": 6}):
            raise AssertionError("long_reference bf16 p=%g: %s, launches "
                                 "%s / %s" % (rate, r, kern[2],
                                              plain_bwd[2]))
    return out


# ---------------------------------------------------------------------------
# scan_layers, transformer_moe, transformer_multilingual with ROBT,
# transformer_clsr
# ---------------------------------------------------------------------------

ML_CONFIG = os.path.join(REPO, "configs", "multilingual_robt_opus100.json")
# config 4 at DEEP_CUT's 2+3 (20+6 as written; 2+6 from the RNN phases
# until the multilingual config's tensor-parallel phase)
SCAN_EXTRA = (",model_name=transformer_l0drop,scope_name=transformer_l0drop,"
              "scan_layers=true" + DEEP_CUT)
# steps cut for the script's time as later slices' phases came (10, 12,
# 5, 10, 5 and 10, then 4, 4, 3, 3, 3 and 4, then 3 each before the
# data-parallel phases)
SCAN_STEPS = 2
# the base config at 2+2 (3+3 since the RNN phases came, until the ZeRO
# phases did)
MOE_EXTRA = (",model_name=transformer_moe,scope_name=transformer_moe,"
             "num_encoder_layer=2,num_decoder_layer=2")
MOE_STEPS = 2
MOE_TOP2_STEPS = 2
ML_STEPS = 2
ML_OFF_STEPS = 2
# the multilingual config's phases at 1+1 (6+6 as written; 3+3 before the
# RNN phases came, 2+2 before the ZeRO phases) for the script's time:
# CLSR's checkpoints (786M parameters at 6+6) dominated its phase
ML_CUT = ",num_encoder_layer=1,num_decoder_layer=1"
CLSR_EXTRA = (",model_name=transformer_clsr,scope_name=transformer_clsr,"
              "robt=false" + ML_CUT)
CLSR_STEPS = 2
ML_LANGUAGES = 100
PEAK_FP32 = PEAK_FLOPS[torch.float32]
FP32_NOTE = ("computes in fp32 whatever default_dtype says (as the JAX "
             "package): MFU against the fp32 peak")
# a stacked checkpoint restored in a fresh process: params, Adam state and
# EMA against the file, tensor for tensor
SCAN_RESTORE = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
sys.path.insert(0, sys.argv[1])
from zero_tpu_torch.config import default_config, merge_params
from zero_tpu_torch.models import get_model
from zero_tpu_torch.saver import Saver, flat_from_module, load_checkpoint_file
from zero_tpu_torch.train_step import init_train_state
from zero_tpu_torch.vocab import Vocab

cfg = merge_params(default_config(), "", "device=cpu", output_dir=sys.argv[2])
cfg.src_vocab = cfg.tgt_vocab = Vocab(cfg.src_vocab_file)
state = init_train_state(get_model(cfg.model_name), cfg, torch.Generator(),
                         "cpu")
trees = {"params": state.params, "opt": state.opt, "ema": state.ema}
saver = Saver(output_dir=sys.argv[2])
assert saver.restore(trees)
want = load_checkpoint_file(saver.latest_path())
got = {}
for prefix, tree in trees.items():
    if tree is not None:
        got.update(flat_from_module(tree, prefix))
print(json.dumps({
    "tensors": len(got), "same_keys": sorted(got) == sorted(want),
    "equal": all(np.array_equal(got[k], want[k]) for k in want),
    "stacked": list(got["params/encoder/self/qkv/ws/0"].shape)}))
"""


def write_multilingual_corpus(d, words):
    """The multilingual config's data in ``d``: a 32768-token vocabulary
    whose 100 language tags <2l00> ... <2l99> take ids 3-102; 8000
    training pairs of 10 to 100 tokens a side and a 32-sentence test set
    of 20 to 60, each source line led by a random tag (the target
    language). Made from SEED."""
    os.makedirs(d)
    tags = ["<2l%02d>" % i for i in range(ML_LANGUAGES)]
    text = words[:32768 - 3 - ML_LANGUAGES]
    with open(os.path.join(d, "vocab.txt"), "w") as w:
        w.write("\n".join(tags + text) + "\n")
    rs = np.random.RandomState(SEED + 3)
    for split, n, lo, hi in (("train", 8000, 10, 101),
                             ("test", TEST_SENTENCES, 20, 61)):
        with open(os.path.join(d, split + ".src"), "w") as ws, \
                open(os.path.join(d, split + ".tgt"), "w") as wt:
            for _ in range(n):
                for w, lead in ((ws, [tags[rs.randint(ML_LANGUAGES)]]),
                                (wt, [])):
                    toks = [text[i] for i in rs.randint(0, len(text),
                                                        rs.randint(lo, hi))]
                    w.write(" ".join(lead + toks) + "\n")


@contextlib.contextmanager
def recording_train_fn(name, record):
    """The registered ``name``'s train_fn, with ``record(out)`` called on
    each of its results (the losses the train step does not return)."""
    from zero_tpu_torch.models import base

    spec = base._REGISTRY[name]

    def train_fn(*args, **kwargs):
        out = spec.train_fn(*args, **kwargs)
        record(out)
        return out

    with mock.patch.dict(base._REGISTRY,
                         {name: spec._replace(train_fn=train_fn)}):
        yield


def decode_serving(label, kernel="decode_attention", encoder=False):
    """A checker of a model's serving: ``kernel`` once per decoder layer
    and decode step; with ``encoder`` the encoder's forward kernels once
    a layer per test batch, in serving and in scoring (CUDA-core #1 and
    #11: the model computes in fp32), else no other kernel."""
    def check(cfg, served, serve_launches, score_launches):
        enc = cfg["num_encoder_layer"] * TEST_BATCHES
        forward = {"fused_attention": enc, "fused_ffn": enc} if encoder \
            else {}
        want = dict(forward, **{kernel: cfg["num_decoder_layer"]
                                * served["steps"]})
        if serve_launches != want or score_launches != forward:
            raise AssertionError("%s: serving launched %s, expected %s; "
                                 "scoring %s, expected %s"
                                 % (label, serve_launches, want,
                                    score_launches, forward))
    return check


def scan_train_phase(d, da):
    """The deep config as transformer_l0drop with scan_layers (stacked
    [20, ...] and [6, ...] layers) SCAN_STEPS steps, both kernel flags on:
    launches per microbatch 64 #1, 32 #2, 52 #11, 26 #12 (use_remat), as
    unrolled; served at beam 4 (#8) and beam 1 (#10), and scored; the
    stacked checkpoint restored in a fresh process (params, Adam state,
    EMA), which runs beside the next phases. Returns (training results,
    beam-4 and beam-1 serving launches, a callable that waits for the
    fresh process and checks that every tensor equals the file's)."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    results, served4 = train_phase(
        d, da, DEEP_CONFIG, "scan_train", expected_launches, SCAN_EXTRA,
        ("true",), l0drop_serving, steps=SCAN_STEPS, note=MFU_NOTE)
    out = os.path.join(d, "scan_train_true")
    proc = subprocess.Popen([sys.executable, "-c", SCAN_RESTORE, REPO, out],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ,
                                                OMP_NUM_THREADS="2"))
    cfg = load_config_file(DEEP_CONFIG)
    cfg.update(overrides(SCAN_EXTRA))

    def restore_check():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise AssertionError("scan_train restore exited %d: %s"
                                 % (proc.returncode, stderr[-2000:]))
        restored = json.loads(stdout.strip().splitlines()[-1])
        phase("scan_train", fresh_process_restore=restored)
        if not (restored["same_keys"] and restored["equal"] and
                restored["stacked"] == [cfg["num_encoder_layer"], 512,
                                        1536]):
            raise AssertionError("scan_train restore: %s" % restored)

    try:
        served1, launches1 = serve_checkpoint(d, "scan_train", counters,
                                              beam=1)
        enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
        want = {"fused_attention" + route_suffix(cfg): enc * TEST_BATCHES,
                "fused_ffn": enc * TEST_BATCHES,
                "decode_attention": dec * served1["steps"]}
        phase("scan_train", beam=1, sentences_per_s=served1["sentences"]
              / served1["seconds"], decode_steps=served1["steps"],
              served_bleu=served1["bleu"], serve_launches=launches1)
        if launches1 != want:
            raise AssertionError("scan_train beam 1 launched %s, expected "
                                 "%s" % (launches1, want))
    except BaseException:
        proc.kill()
        raise
    return results, served4, launches1, restore_check


def moe_train_phase(d, da):
    """configs/transformer_base_wmt14.json as transformer_moe (8 experts,
    top-1, capacity 1.25, "auto" = einsum dispatch), both kernel flags on,
    MOE_STEPS steps: no training kernel (the JAX layers pass none); moe_aux
    beside the loss, peak memory; MOE_TOP2_STEPS steps at moe_top_k=2;
    one full-width fp32 batch through einsum and scatter (loss and grads);
    --mode test at beam 4 (#10) and --mode score (no kernel). Returns
    (training results, serving launches)."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    aux = []
    with recording_train_fn("transformer_moe",
                            lambda out: aux.append(out["moe_aux"].detach())):
        results, served = train_phase(
            d, da, CONFIG, "moe_train", no_kernel, MOE_EXTRA, ("true",),
            decode_serving("moe_train"), steps=MOE_STEPS,
            note="model FLOPs count each token's FFN in top_k experts")
        cycle = len(aux) // MOE_STEPS
        per_step = [torch.stack(aux[i:i + cycle]).mean().item()
                    for i in range(0, len(aux), cycle)]
        phase("moe_train", loss_first=results["loss_first"],
              loss_last=results["loss_last"], moe_aux_first=per_step[0],
              moe_aux_last=per_step[-1], peak_gib=results["peak_gib"])
        aux.clear()
        out = os.path.join(d, "moe_top2")
        torch.cuda.reset_peak_memory_stats()
        summary, launches = train_run(d, out, "true", counters, CONFIG,
                                      MOE_EXTRA + ",moe_top_k=2",
                                      MOE_TOP2_STEPS)
    ends = summary["step_end_times"]
    step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
    top2 = dict(moe_top_k=2, steps=summary["steps"],
                ms_per_step_median=1e3 * step_s[len(step_s) // 2],
                loss_last=summary["losses"][-1],
                moe_aux_last=torch.stack(aux[-cycle:]).mean().item(),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=launches)
    phase("moe_train", **top2)
    shutil.rmtree(out)
    if (summary["steps"] != MOE_TOP2_STEPS or launches
            or not all(map(math.isfinite, summary["losses"]))):
        raise AssertionError("moe_train top-2: %s" % top2)
    moe_dispatch_check(d)
    return results, served


def moe_dispatch_check(d):
    """transformer_moe at the base config's widths in fp32, one batch of 16
    rows (source 48, target 40 positions, dropout on): train_fn through
    the einsum and the scatter dispatch on the same seed words. The loss
    and every grad agree within 1e-5 of their max; the share of (token,
    slot) pairs the capacity keeps is printed."""
    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops import moe
    from zero_tpu_torch.vocab import Vocab

    values = load_config_file(CONFIG)
    values.update(model_name="transformer_moe", default_dtype="float32")
    cfg = default_config().override_from_dict(values)
    cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d, "vocab.txt"))
    model = get_model("transformer_moe")
    params = model.init_fn(torch.Generator().manual_seed(SEED), cfg).cuda()
    feats = _full_width_batch()
    kept = []
    real_route = moe._route

    def route(*args):
        out = real_route(*args)
        kept.append(out[1].float().mean().item())
        return out

    runs = {}
    for dispatch in ("einsum", "scatter"):
        cfg.moe_dispatch = dispatch
        with mock.patch.object(moe, "_route", route):
            loss = model.train_fn(params, feats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
        runs[dispatch] = (loss.item(), torch.autograd.grad(
            loss, list(params.parameters())))
    (le, ge), (ls, gs) = runs["einsum"], runs["scatter"]
    top = max(g.abs().max().item() for g in ge)
    gap = max((a - b).abs().max().item() for a, b in zip(ge, gs)) / top
    out = dict(loss_einsum=le, loss_scatter=ls,
               loss_rel_gap=abs(le - ls) / abs(le), grad_gap=gap,
               kept_share=min(kept[:len(kept) // 2]))
    phase("moe_dispatch", **out)
    if not (out["loss_rel_gap"] <= 1e-5 and gap <= 1e-5
            and out["kept_share"] < 1.0):
        raise AssertionError("moe dispatch einsum vs scatter: %s" % out)
    del params


def _full_width_batch():
    """16 rows of 48 source and 40 target positions, each row 10 or more
    tokens, from SEED: a batch at full model width for the checks that
    run train_fn directly."""
    rs = np.random.RandomState(SEED + 2)
    src = rs.randint(3, 32768, (16, 48))
    tgt = rs.randint(3, 32768, (16, 40))
    for i, (ns, nt) in enumerate(zip(rs.randint(10, 49, 16),
                                     rs.randint(10, 41, 16))):
        src[i, ns:] = 0
        tgt[i, nt:] = 0
    return {"source": torch.as_tensor(src).cuda(),
            "target": torch.as_tensor(tgt).cuda()}


def ml_expected_launches(cfg, summary):
    """transformer_multilingual, flags on, per microbatch: the encoder's
    #1 and #11 forwards in the main pass, ROBT's encode and the synthetic
    pass (3 x 6), their backwards in the two training passes (2 x 6), and
    ROBT's greedy decode one #10 per decoder layer and step, L_src - 1
    steps at the step's stacked source length. Without ROBT 6 of each of
    #1, #2, #11, #12. fp32: the CUDA-core routes."""
    enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
    robt = str(cfg.get("robt", False)).lower() == "true"
    micro = cfg["update_cycle"] * summary["steps"]
    passes = 3 if robt else 1
    out = {"fused_attention": passes * enc * micro,
           "fused_attention_backward": (passes - robt) * enc * micro,
           "fused_ffn": passes * enc * micro,
           "fused_ffn_backward": (passes - robt) * enc * micro}
    if robt:
        out["decode_attention"] = sum(
            len(shapes) * dec * (stacked_shape(shapes)[1] - 1)
            for shapes in summary["shapes"])
    return out


def multilingual_train_phase(d, da):
    """configs/multilingual_robt_opus100.json (at ML_CUT's 1+1, 512/2048,
    100 languages, ROBT with weight 1, use_remat, which the model ignores
    as the JAX package does) plus both kernel flags, ML_STEPS steps:
    launches per microbatch 9 #1, 6 #2, 9 #11, 6 #12 (fp32, CUDA cores)
    and 3 (L_src - 1) #10; the main and the back-translated losses, peak
    memory; then ML_OFF_STEPS steps with robt=false (3 of each); then
    --mode test at beam 4 on test sentences of mixed tags (#10) and --mode
    score. Returns (training results, serving launches, the robt=false
    results)."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    losses = []
    with recording_train_fn("transformer_multilingual",
                            lambda out: losses.append(out["loss"].detach())):
        results, served = train_phase(
            d, da, ML_CONFIG, "multilingual_train", ml_expected_launches,
            ML_CUT, flag_runs=("true",), serving=decode_serving(
                "multilingual_train", encoder=True),
            steps=ML_STEPS, note=FP32_NOTE, peak=PEAK_FP32)
    cycle = load_config_file(ML_CONFIG)["update_cycle"]
    main = torch.stack(losses[0::2]).view(ML_STEPS, cycle).mean(1).tolist()
    bt = torch.stack(losses[1::2]).view(ML_STEPS, cycle).mean(1).tolist()
    phase("multilingual_train", main_loss_first=main[0],
          main_loss_last=main[-1], bt_loss_first=bt[0], bt_loss_last=bt[-1],
          peak_gib=results["peak_gib"])
    if len(losses) != 2 * cycle * ML_STEPS:
        raise AssertionError("multilingual_train: %d passes" % len(losses))
    off = os.path.join(d, "multilingual_robt_off")
    torch.cuda.reset_peak_memory_stats()
    summary, launches = train_run(d, off, "true", counters, ML_CONFIG,
                                  ML_CUT + ",robt=false", ML_OFF_STEPS)
    cfg = load_config_file(ML_CONFIG)
    cfg.update(overrides(ML_CUT))
    cfg["robt"] = "false"
    ends = summary["step_end_times"]
    step_s = sorted(b - a for a, b in zip(ends[:-1], ends[1:]))
    timed = sum(b - a for a, b in zip(ends[:-1], ends[1:]))
    robt_off = dict(robt=False, steps=summary["steps"],
                    ms_per_step_median=1e3 * step_s[len(step_s) // 2],
                    target_tokens_per_s=sum(summary["target_tokens"][1:])
                    / timed, loss_last=summary["losses"][-1],
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    launches=launches)
    phase("multilingual_train", **robt_off)
    shutil.rmtree(off)
    if (summary["steps"] != ML_OFF_STEPS
            or launches != ml_expected_launches(cfg, summary)
            or not all(map(math.isfinite, summary["losses"]))):
        raise AssertionError("multilingual_train robt=false: %s, expected "
                             "%s" % (robt_off,
                                     ml_expected_launches(cfg, summary)))
    return results, served, robt_off


def clsr_train_phase(d, da):
    """The multilingual config as transformer_clsr with robt=false, both
    kernel flags on, CLSR_STEPS steps: no training kernel (the JAX layers
    pass none); the budget loss, peak memory; --mode test at beam 4 (#10)
    and --mode score (no kernel); then --mode ensemble of this checkpoint
    with multilingual_train's (the multilingual encoder's #1 and #11, #10
    in both decoders). Returns (training results, serving launches,
    ensemble launches)."""
    from zero_tpu_torch import run
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.models import transformer_clsr as clsr_mod
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    budgets = []
    real_budget = clsr_mod.budget_loss

    def record(gate_sums, cfg):
        out = real_budget(gate_sums, cfg)
        budgets.append(out.detach())
        return out

    with mock.patch.object(clsr_mod, "budget_loss", record):
        results, served = train_phase(
            d, da, ML_CONFIG, "clsr_train", no_kernel, CLSR_EXTRA, ("true",),
            decode_serving("clsr_train"), steps=CLSR_STEPS, note=FP32_NOTE,
            peak=PEAK_FP32)
    cfg = load_config_file(ML_CONFIG)
    cfg.update(overrides(ML_CUT))
    per_step = torch.stack(budgets).view(CLSR_STEPS, -1).mean(1).tolist()
    phase("clsr_train", loss_first=results["loss_first"],
          loss_last=results["loss_last"], budget_loss_first=per_step[0],
          budget_loss_last=per_step[-1], peak_gib=results["peak_gib"])
    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "test_output={0}/ensemble.txt,eval_batch_size=32,"
            "beam_size=4".format(d))
    for c in counters:
        c.clear()
    summary = run.main(["--mode", "ensemble", "--ensemble_dirs",
                        "{0}/multilingual_train_true;{0}/clsr_train_true"
                        .format(d), "--parameters", spec])
    launches = collect(counters)
    enc = cfg["num_encoder_layer"] * TEST_BATCHES
    want = {"fused_attention": enc, "fused_ffn": enc,
            "decode_attention": 2 * cfg["num_decoder_layer"]
            * summary["steps"]}
    with open(os.path.join(d, "ensemble.txt")) as r:
        lines = r.read().splitlines()
    phase("clsr_train", ensemble="multilingual_train+clsr_train",
          sentences=summary["sentences"], bleu=summary["bleu"],
          sentences_per_s=summary["sentences"] / summary["seconds"],
          decode_steps=summary["steps"], launches=launches)
    if len(lines) != TEST_SENTENCES or summary["sentences"] \
            != TEST_SENTENCES or launches != want:
        raise AssertionError("clsr_train ensemble: %d lines, launches %s, "
                             "expected %s" % (len(lines), launches, want))
    return results, served, launches


def _tagged_small_batch(languages):
    """_small_batch with a language tag (ids 3 to 2 + languages) leading
    every row but the all-pad one."""
    feats = _small_batch()
    src = feats["source"]
    tags = torch.as_tensor(np.random.RandomState(SEED).randint(
        3, 3 + languages, src.shape[0]))
    src[:-1, 0] = tags[:-1]
    return feats


def _card_vs_cpu(label, model, cfg, feats, train, train_want, decode_want,
                 counters, search=None, source=None,
                 name="slice13_reference"):
    """``train(params, feats)`` -> (loss, grads) on a CPU model and its
    copy on the card: loss within 1e-6 relative, every grad within 1e-5 of
    the largest |grad|; the card's training launches ``train_want``; beam 4
    card against CPU (``search``, by default beam_search, over
    ``source(feats)``, by default feats["source"]), identical sequences,
    the card's decode launches ``decode_want(steps)``; printed under the
    phase ``name``."""
    import copy

    from zero_tpu_torch.search import beam_search

    search = search or beam_search
    source = source or (lambda f: f["source"])
    cpu = model.init_fn(torch.Generator().manual_seed(SEED), cfg)
    gpu = copy.deepcopy(cpu).cuda()
    gfeats = {k: v.cuda() for k, v in feats.items()}
    lc, gc = train(cpu, feats)
    for c in counters:
        c.clear()
    lg, gg = train(gpu, gfeats)
    train_launches = collect(counters)
    top = max(b.abs().max().item() for b in gc)
    gap = max((a.cpu() - b).abs().max().item() for a, b in zip(gg, gc)) / top
    loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
    cfg.beam_size = 4
    inf = model.infer_fn(cfg)
    with torch.inference_mode():
        c = search(cpu, source(feats), inf, cfg)
        for n in counters:
            n.clear()
        g = search(gpu, source(gfeats), inf, cfg)
    decode_launches = collect(counters)
    same = torch.equal(g["seq"].cpu(), c["seq"])
    out = dict(case=label, loss_rel_err=loss_err, grad_gap=gap,
               train_launches=train_launches, beam4_same_sequences=same,
               beam4_steps=g["steps"], decode_launches=decode_launches)
    phase(name, **out)
    if not (loss_err <= 1e-6 and gap <= 1e-5 and same
            and train_launches == train_want
            and decode_launches == decode_want(g["steps"])
            and torch.isfinite(g["score"]).all()):
        raise AssertionError("%s %s: %s, expected launches %s / %s"
                             % (name, label, out, train_want,
                                decode_want(g["steps"])))
    return out


def slice13_reference_phase(da):
    """Small fp32 models (_small_model: 2+2 layers, 64/128, 4 heads,
    dropout 0.1), card against CPU on the same seed words (_card_vs_cpu):
    scan_layers transformer and transformer_l0drop under use_remat (the
    CUDA-core kernels, forwards twice); transformer_moe (4 experts at a
    capacity that drops tokens) through einsum and scatter, top-1 and
    top-2 (no kernel in training, #10 at decode); transformer_multilingual
    with ROBT, one intermediate language injected on both sides, through
    the train step's microbatch backward (the encoder's kernels, ROBT's
    #10); transformer_clsr with one gate noise injected (no training
    kernel). Then in bf16 on the card (tensor-core #1/#2, #11/#12) the
    scan transformer with use_remat against without, on the same words:
    the gap must be 0."""
    from zero_tpu_torch import robt
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops import l0norm
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.train_step import make_micro_backward

    counters = (fa.launches, ff.launches, da.launches)
    n = 2   # layers a side of _small_model

    def seeded(model, cfg):
        def train(params, feats):
            loss = model.train_fn(params, feats, cfg,
                                  torch.Generator().manual_seed(SEED),
                                  step=100)["loss"]
            return loss, torch.autograd.grad(loss, list(params.parameters()))
        return train

    for name in ("transformer", "transformer_l0drop"):
        cfg = _small_model(0.1, name)
        cfg.scan_layers = cfg.use_remat = True
        attn = 3 * n
        _card_vs_cpu("scan_" + name, get_model(name), cfg, _small_batch(),
                     seeded(get_model(name), cfg),
                     {"fused_attention": 2 * attn,
                      "fused_attention_backward": attn,
                      "fused_ffn": 2 * 2 * n, "fused_ffn_backward": 2 * n},
                     lambda steps: {"fused_attention": n, "fused_ffn": n,
                                    "decode_pool_attention": n * steps},
                     counters)
    moe_model = get_model("transformer_moe")
    for dispatch in ("einsum", "scatter"):
        for top_k in (1, 2):
            cfg = _small_model(0.1, "transformer_moe")
            cfg.moe_num_experts, cfg.moe_capacity_factor = 4, 0.5
            cfg.moe_dispatch, cfg.moe_top_k = dispatch, top_k
            _card_vs_cpu("moe_%s_top%d" % (dispatch, top_k), moe_model, cfg,
                         _small_batch(), seeded(moe_model, cfg), {},
                         lambda steps: {"decode_attention": n * steps},
                         counters)

    ml_model = get_model("transformer_multilingual")
    cfg = _small_model(0.1, "transformer_multilingual")
    cfg.num_languages, cfg.robt = 4, True
    feats = _tagged_small_batch(4)
    z = torch.as_tensor(np.random.RandomState(SEED + 4).randint(
        0, 4, (feats["source"].shape[0], 1)))
    backward = make_micro_backward(ml_model, cfg)

    def robt_train(params, batch):
        with mock.patch.object(robt, "draw_languages",
                               lambda gen, rows, langs, device: z.to(device)):
            loss = backward(params, batch,
                            torch.Generator().manual_seed(SEED), 100)
        grads = [p.grad.clone() for p in params.parameters()]
        for p in params.parameters():
            p.grad = None
        return loss, grads

    ls = feats["source"].shape[1]
    _card_vs_cpu("multilingual_robt", ml_model, cfg, feats, robt_train,
                 {"fused_attention": 3 * n, "fused_attention_backward": 2 * n,
                  "fused_ffn": 3 * n, "fused_ffn_backward": 2 * n,
                  "decode_attention": n * (ls - 1)},
                 lambda steps: {"fused_attention": n, "fused_ffn": n,
                                "decode_attention": n * steps}, counters)

    clsr_model = get_model("transformer_clsr")
    cfg = _small_model(0.1, "transformer_clsr")
    cfg.num_languages = 4
    noise = {}

    def injected(words, shape, device):
        shape = tuple(shape)
        if shape not in noise:
            noise[shape] = torch.as_tensor(np.random.RandomState(
                SEED + len(noise)).rand(*shape).astype(np.float32))
        return noise[shape].to(device)

    with mock.patch.object(l0norm, "uniform_noise", injected):
        _card_vs_cpu("clsr", clsr_model, cfg, _tagged_small_batch(4),
                     seeded(clsr_model, cfg), {},
                     lambda steps: {"decode_attention": n * steps}, counters)

    # bf16: the checkpointed stack against the plain one, same words
    model = get_model("transformer")
    cfg = _small_model(0.1)
    cfg.scan_layers, cfg.default_dtype = True, "bfloat16"
    params = model.init_fn(torch.Generator().manual_seed(SEED), cfg).cuda()
    feats = {k: v.cuda() for k, v in _small_batch().items()}
    runs = {}
    for remat in (False, True):
        cfg.use_remat = remat
        for c in counters:
            c.clear()
        runs[remat] = seeded(model, cfg)(params, feats) + (
            collect(counters),)
    (l0, g0, k0), (l1, g1, k1) = runs[False], runs[True]
    top = max(b.abs().max().item() for b in g0)
    gap = max((a - b).abs().max().item() for a, b in zip(g1, g0)) / top
    out = dict(case="scan_bf16_remat", loss_gap=abs(l1.item() - l0.item()),
               grad_gap=gap, launches_remat=k1, launches_plain=k0)
    phase("slice13_reference", **out)
    if not (out["loss_gap"] == 0.0 and gap == 0.0
            and k1["fused_attention_tc"] == 2 * k0["fused_attention_tc"]):
        raise AssertionError("slice13_reference bf16 remat: %s" % out)
    del params


# ---------------------------------------------------------------------------
# slice 14: transformer_ibdecoder, then speech translation (transformer_afs)
# ---------------------------------------------------------------------------

# the base config at BASE_CUT's 2+2 (6+6 before the RNN phases came)
IB_EXTRA = (",model_name=transformer_ibdecoder,"
            "scope_name=transformer_ibdecoder" + BASE_CUT)
IB_STEPS = 2     # 3 before the data-parallel phases came
IB_NOTE = ("MFU over the bf16 peak; the decoder computes in fp32 (its fp32 "
           "positions promote it, as in the JAX package)")
SPEECH_CONFIG = os.path.join(REPO, "configs", "speech_afs_mustc.json")
SPEECH_STEPS = 2     # 3 before the data-parallel phases came
SPEECH_CONTEXT_STEPS = 2
SPEECH_UTTERANCES = 600
# the config's own settings: the fused FFN off, no sample decode (a speech
# batch's frames fail its source print, as in the JAX package); 1+1+1
# layers (6+6+6 as written; 3+3+3 from the RNN phases to the ZeRO phases,
# 2+2+2 until sequence parallelism came)
SPEECH_EXTRA = (",use_fused_ffn=false,num_encoder_layer=1,"
                "num_st_encoder_layer=1,num_decoder_layer=1")


def ib_expected_launches(cfg, summary):
    """transformer_ibdecoder per microbatch: the encoder's attention and FFN
    on the config dtype's route (bf16: the tensor-core #1/#2), the
    decoder's two attentions a layer in fp32 (CUDA cores: its fp32
    positions promote it, as in the JAX package) and its FFN; forward and
    backward."""
    m = cfg["update_cycle"] * summary["steps"]
    enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
    sfx = route_suffix(cfg)
    return {"fused_attention" + sfx: enc * m,
            "fused_attention_backward" + sfx: enc * m,
            "fused_attention": 2 * dec * m,
            "fused_attention_backward": 2 * dec * m,
            "fused_ffn": (enc + dec) * m,
            "fused_ffn_backward": (enc + dec) * m}


def ib_serving(cfg, served, serve_launches, score_launches):
    """Serving runs the encoder's #1 and #11 once a layer per test batch
    and no decode kernel (the pair step attends over two positions, on the
    composite); scoring every attention's #1 (the decoder's in fp32) and
    every FFN's #11."""
    enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
    sfx = route_suffix(cfg)
    want = {"fused_attention" + sfx: enc * TEST_BATCHES,
            "fused_ffn": enc * TEST_BATCHES}
    score_want = {"fused_attention" + sfx: enc * TEST_BATCHES,
                  "fused_attention": 2 * dec * TEST_BATCHES,
                  "fused_ffn": (enc + dec) * TEST_BATCHES}
    if serve_launches != want or score_launches != score_want:
        raise AssertionError("ib_train: serving launched %s, expected %s; "
                             "scoring %s, expected %s"
                             % (serve_launches, want, score_launches,
                                score_want))


def ib_train_phase(d, da):
    """configs/transformer_base_wmt14.json as transformer_ibdecoder (6+6,
    bf16) with both kernel flags on, IB_STEPS steps: ms/step, tokens/s,
    MFU, launches (ib_expected_launches); --mode test of the checkpoint at
    beam 4 (the pair search: pair steps and sentences/s), --mode score,
    then beam 1. Returns (training results, beam-4 and beam-1 serving
    launches)."""
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    results, served4 = train_phase(d, da, CONFIG, "ib_train",
                                   ib_expected_launches, IB_EXTRA, ("true",),
                                   ib_serving, steps=IB_STEPS, note=IB_NOTE)
    cfg = load_config_file(CONFIG)
    cfg.update(overrides(IB_EXTRA))
    served, served1 = serve_checkpoint(d, "ib_train", counters, beam=1)
    phase("ib_train", beam=1, sentences_per_s=served["sentences"]
          / served["seconds"], pair_steps=served["steps"],
          served_bleu=served["bleu"], serve_launches=served1)
    want = {"fused_attention" + route_suffix(cfg):
            cfg["num_encoder_layer"] * TEST_BATCHES,
            "fused_ffn": cfg["num_encoder_layer"] * TEST_BATCHES}
    if served1 != want:
        raise AssertionError("ib_train beam 1 launched %s, expected %s"
                             % (served1, want))
    return results, served4, served1


def write_wav(path, samples, rate=16000):
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(samples.astype(np.int16).tobytes())


def write_speech_corpus(d, words):
    """The speech config's data in ``d`` (the manifests under the text
    phases' file names): the vocabulary; train.src, a manifest of
    SPEECH_UTTERANCES .npy log-mel-like features [T, 80], T from 300 to
    2048 frames, with transcripts and translations of 10-60 words, and
    train.tgt its translations; test.src, a manifest of 32 16 kHz .wav
    files of 3-10 s (read_wav and logmel run at test time), and test.tgt
    its references. Made from SEED."""
    os.makedirs(d)
    with open(os.path.join(d, "vocab.txt"), "w") as w:
        w.write("\n".join(words) + "\n")
    rng = np.random.default_rng(SEED + 5)

    def text():
        return " ".join(words[i] for i in rng.integers(
            0, len(words), rng.integers(10, 61)))

    for split, n in (("train", SPEECH_UTTERANCES), ("test", TEST_SENTENCES)):
        with open(os.path.join(d, split + ".src"), "w") as manifest, \
                open(os.path.join(d, split + ".tgt"), "w") as refs:
            for i in range(n):
                if split == "train":
                    name = "train%d.npy" % i
                    frames = int(rng.integers(300, 2049))
                    np.save(os.path.join(d, name), rng.standard_normal(
                        (frames, 80), dtype=np.float32) - 4.0)
                else:
                    name = "test%d.wav" % i
                    samples = int(rng.integers(48000, 160001))
                    write_wav(os.path.join(d, name),
                              3000.0 * rng.standard_normal(samples))
                translation = text()
                manifest.write("%s\t%s\t%s\n" % (name, text(), translation))
                refs.write(translation + "\n")


def speech_expected_launches(cfg, summary, context=False):
    """transformer_afs per microbatch: ASR encoder, ST encoder, decoder
    self- and cross attention, one #1 and one #2 a layer each (24 at
    6+6+6; st_context adds the context's ASR encoder), on the config
    dtype's route; no FFN kernel (the config leaves use_fused_ffn off)."""
    m = cfg["update_cycle"] * summary["steps"]
    asr = cfg["num_encoder_layer"] * (2 if context else 1)
    n = (asr + cfg["num_st_encoder_layer"] + 2 * cfg["num_decoder_layer"]) * m
    sfx = route_suffix(cfg)
    return {"fused_attention" + sfx: n, "fused_attention_backward" + sfx: n}


def speech_flops(shapes, cfg):
    """Matmul FLOPs of one transformer_afs step at its stacked shape
    (frames stacked by audio_frame_stride): the frontend, the ASR and ST
    encoder layers over the stacked frames (no compaction in training),
    the decoder, the CTC head and the tied softmax; forward x 3, plus the
    chunked CE's recomputed logits. The gates' products (2 d a frame) and
    the context's ASR encoder are left out."""
    d, f = cfg["hidden_size"], cfg["filter_size"]
    k = max(int(cfg["audio_frame_stride"]), 1)
    mels = cfg["audio_num_mel_bins"]
    ctc_classes = int(cfg["coarse_label_base"]) + 3
    v = 32768
    b = max(s[0][0] for s in shapes)
    frames = max(s[0][1] for s in shapes) // k
    lt = max(s[1][1] for s in shapes)
    ns, nt = b * frames, b * lt
    enc_layer = 2 * ns * d * 4 * d + 4 * ns * d * f + 4 * b * frames ** 2 * d
    enc = (cfg["num_encoder_layer"] + cfg["num_st_encoder_layer"]) * enc_layer
    dec = cfg["num_decoder_layer"] * (
        2 * nt * d * 4 * d + 4 * b * lt * lt * d + 2 * nt * d * 2 * d
        + 2 * ns * d * 2 * d + 4 * nt * d * f + 4 * b * lt * frames * d)
    front = 2 * ns * mels * k * d
    ctc = 2 * ns * d * ctc_classes
    logits = 2 * nt * d * v
    return len(shapes) * (3 * (front + enc + dec + ctc + logits) + logits)


@contextlib.contextmanager
def recording_afs(record):
    """transformer_afs with its raw frame counts (``record['frames']``, the
    frontend's mask sums), AFS penalties (``'penalty'``) and CTC terms
    (``'ctc'``) recorded as device scalars."""
    from zero_tpu_torch.models import transformer_afs as afs_mod

    frontend, gate, ctc_loss = (afs_mod._frontend, afs_mod._afs_gate,
                                afs_mod._ctc_loss)

    def rec_frontend(params, audio, mask, *args):
        record.setdefault("frames", []).append(mask.sum().detach())
        return frontend(params, audio, mask, *args)

    def rec_gate(*args):
        out = gate(*args)
        record.setdefault("penalty", []).append(out[2].detach())
        return out

    def rec_ctc(*args):
        out = ctc_loss(*args)
        record.setdefault("ctc", []).append(out.detach())
        return out

    with mock.patch.object(afs_mod, "_frontend", rec_frontend), \
            mock.patch.object(afs_mod, "_afs_gate", rec_gate), \
            mock.patch.object(afs_mod, "_ctc_loss", rec_ctc):
        yield


@contextlib.contextmanager
def recording_compaction(record):
    """transformer_afs's eval compaction with the valid frames before it
    and the kept ones after it recorded (``record['total']``,
    ``record['kept']``)."""
    from zero_tpu_torch.models import transformer_afs as afs_mod

    compact = afs_mod.compact_encodings

    def rec(encodes, mask, keep_score, ratio):
        out = compact(encodes, mask, keep_score, ratio)
        record.setdefault("total", []).append(mask.sum().detach())
        record.setdefault("kept", []).append(out[1][:, 1:].sum().detach())
        return out

    with mock.patch.object(afs_mod, "compact_encodings", rec):
        yield


def speech_serving(cfg, served, serve_launches, score_launches):
    """Serving: the ASR and ST encoders' #1 once a layer per test batch
    (the ST encoder over the compacted frames), #10 once per decoder layer
    and decode step (beam rows folded over the classic cache); scoring the
    encoders' and the decoder self-attention's #1, the cross attention on
    the composite (the compacted memory's count softmax)."""
    sfx = route_suffix(cfg)
    enc = cfg["num_encoder_layer"] + cfg["num_st_encoder_layer"]
    want = {"fused_attention" + sfx: enc * TEST_BATCHES,
            "decode_attention": cfg["num_decoder_layer"] * served["steps"]}
    score_want = {"fused_attention" + sfx:
                  (enc + cfg["num_decoder_layer"]) * TEST_BATCHES}
    if serve_launches != want or score_launches != score_want:
        raise AssertionError("speech_train: serving launched %s, expected "
                             "%s; scoring %s, expected %s"
                             % (serve_launches, want, score_launches,
                                score_want))


def speech_train_phase(d, da):
    """configs/speech_afs_mustc.json as written (6+6+6, bf16, AFS tf,
    coarse CTC, use_flash_attention) SPEECH_STEPS steps on the synthetic
    corpus (write_speech_corpus): loss, the CTC term and the AFS penalty,
    ms/step, target tokens/s and frames/s, MFU, peak memory, launches
    (speech_expected_launches); --mode test at beam 4 (the saved beam) and
    beam 1 with l0_compact_ratio 0.3 (the share of frames compacted away),
    --mode score, --mode ensemble of the checkpoint with itself; then
    SPEECH_CONTEXT_STEPS steps with st_context. Returns (training results,
    beam-4, beam-1 and ensemble serving launches)."""
    from zero_tpu_torch import run
    from zero_tpu_torch.config import load_config_file
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    cfg = load_config_file(SPEECH_CONFIG)
    cfg.update(overrides(SPEECH_EXTRA))
    rec, compacted = {}, {}
    with recording_afs(rec), recording_compaction(compacted):
        results, served4 = train_phase(
            d, da, SPEECH_CONFIG, "speech_train", speech_expected_launches,
            SPEECH_EXTRA, ("true",), speech_serving, steps=SPEECH_STEPS,
            flops_fn=speech_flops)
    cycle = int(cfg["update_cycle"])
    m = SPEECH_STEPS * cycle
    frames = torch.stack(rec["frames"][:m]).view(SPEECH_STEPS, cycle).sum(1)
    ctc = torch.stack(rec["ctc"][:m]).view(SPEECH_STEPS, cycle).mean(1)
    penalty = torch.stack(rec["penalty"][:m]).view(SPEECH_STEPS,
                                                    cycle).mean(1)
    shares = [1.0 - (k / t).item() for k, t in zip(compacted["kept"],
                                                   compacted["total"])]
    # frames/s over the steps after the first, as the phase's tokens/s
    frames_s = frames[1:].sum().item() / (
        (results["ms_per_step_mean"] / 1e3) * (SPEECH_STEPS - 1))
    phase("speech_train", loss_first=results["loss_first"],
          loss_last=results["loss_last"], ctc_first=ctc[0].item(),
          ctc_last=ctc[-1].item(), afs_penalty_first=penalty[0].item(),
          afs_penalty_last=penalty[-1].item(), frames_per_s=frames_s,
          raw_frames_per_step=frames.tolist(),
          compacted_away_share_beam4=sum(shares) / len(shares))
    if not all(map(math.isfinite, ctc.tolist() + penalty.tolist())):
        raise AssertionError("speech_train: ctc %s, penalty %s"
                             % (ctc.tolist(), penalty.tolist()))
    compacted.clear()
    with recording_compaction(compacted):
        served, served1 = serve_checkpoint(d, "speech_train", counters,
                                           beam=1)
    want1 = {"fused_attention" + route_suffix(cfg):
             (cfg["num_encoder_layer"] + cfg["num_st_encoder_layer"])
             * TEST_BATCHES,
             "decode_attention": cfg["num_decoder_layer"] * served["steps"]}
    shares = [1.0 - (k / t).item() for k, t in zip(compacted["kept"],
                                                   compacted["total"])]
    phase("speech_train", beam=1, sentences_per_s=served["sentences"]
          / served["seconds"], decode_steps=served["steps"],
          served_bleu=served["bleu"], compacted_away_share=sum(shares)
          / len(shares), serve_launches=served1)
    if served1 != want1:
        raise AssertionError("speech_train beam 1 launched %s, expected %s"
                             % (served1, want1))
    # the checkpoint with itself through --mode ensemble
    spec = checkpoint_spec(d, "speech_train", "ensemble")
    spec = ",".join(kv for kv in spec.split(",")
                    if not kv.startswith("output_dir="))
    for c in counters:
        c.clear()
    summary = run.main(["--mode", "ensemble", "--ensemble_dirs",
                        "{0}/speech_train_true;{0}/speech_train_true"
                        .format(d), "--parameters", spec])
    ensemble = collect(counters)
    want = {k: 2 * v for k, v in speech_expected_enc(cfg).items()}
    want["decode_attention"] = 2 * cfg["num_decoder_layer"] * summary["steps"]
    phase("speech_train", ensemble="speech_train x 2",
          sentences=summary["sentences"], bleu=summary["bleu"],
          sentences_per_s=summary["sentences"] / summary["seconds"],
          decode_steps=summary["steps"], launches=ensemble)
    if summary["sentences"] != TEST_SENTENCES or ensemble != want:
        raise AssertionError("speech_train ensemble: %d sentences, launches "
                             "%s, expected %s" % (summary["sentences"],
                                                  ensemble, want))
    # st_context: the previous utterance's frames through the ASR stack
    out = os.path.join(d, "speech_context")
    torch.cuda.reset_peak_memory_stats()
    summary, launches = train_run(d, out, "true", counters, SPEECH_CONFIG,
                                  SPEECH_EXTRA + ",st_context=true",
                                  SPEECH_CONTEXT_STEPS)
    want = speech_expected_launches(cfg, summary, context=True)
    ends = summary["step_end_times"]
    context = dict(st_context=True, steps=summary["steps"],
                   ms_per_step=1e3 * (ends[-1] - ends[0])
                   / max(len(ends) - 1, 1),
                   loss_last=summary["losses"][-1],
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=launches)
    phase("speech_train", **context)
    shutil.rmtree(out)
    if (summary["steps"] != SPEECH_CONTEXT_STEPS or launches != want
            or not all(map(math.isfinite, summary["losses"]))):
        raise AssertionError("speech_train st_context: %s, expected %s"
                             % (context, want))
    return results, served4, served1, ensemble


def speech_expected_enc(cfg):
    """The encoders' #1 of one --mode test pass over the test set."""
    return {"fused_attention" + route_suffix(cfg):
            (cfg["num_encoder_layer"] + cfg["num_st_encoder_layer"])
            * TEST_BATCHES}


def _small_afs(mode="tf", context=False):
    """_small_model (2+2 layers, 64/128, 4 heads, dropout 0.1, both kernel
    flags) as transformer_afs: 2 ST encoder layers, 80 mels stacked by 3,
    coarse CTC (base 5), l0_compact_ratio 0.3."""
    cfg = _small_model(0.1, "transformer_afs")
    for k, v in dict(data_kind="speech", audio_num_mel_bins=80,
                     audio_frame_stride=3, num_st_encoder_layer=2,
                     afs_mode=mode, st_context=context, ctc_enable=True,
                     ctc_alpha=0.3, coarse_label_base=5, afs_l0_scalar=0.5,
                     l0_compact_ratio=0.3).items():
        setattr(cfg, k, v)
    return cfg


def _small_speech_batch():
    """6 utterances of 50 to 12 frames (lengths off the stride) and an
    all-pad row; targets, coarse transcripts short enough to be feasible,
    and a previous segment whose first row is all zero (mask zero)."""
    rs = np.random.RandomState(SEED)
    lens = [50, 44, 31, 20, 13, 0]
    mask = (np.arange(50)[None] < np.asarray(lens)[:, None]).astype(
        np.float32)
    audio = (rs.randn(6, 50, 80) * mask[..., None]).astype(np.float32)
    ctx_mask = np.ones((6, 20), np.float32)
    ctx_mask[0] = 0.0
    context = (rs.randn(6, 20, 80) * ctx_mask[..., None]).astype(np.float32)
    tgt = rs.randint(3, 43, (6, 9))
    transcript = rs.randint(3, 8, (6, 4))
    for i, (nt, nc) in enumerate(zip([9, 7, 5, 4, 2, 0], [4, 4, 3, 2, 1, 0])):
        tgt[i, nt:] = 0
        transcript[i, nc:] = 0
    return {k: torch.as_tensor(v) for k, v in dict(
        audio=audio, audio_mask=mask, target=tgt, transcript=transcript,
        context=context, context_mask=ctx_mask).items()}


def _speech_source(feats):
    return {"audio": feats["audio"], "mask": feats["audio_mask"],
            "context": feats["context"],
            "context_mask": feats["context_mask"]}


def slice14_reference_phase(da):
    """Small fp32 models card against CPU on the same seed words
    (_card_vs_cpu: loss within 1e-6 relative, grads within 1e-5 of their
    max, identical beam-4 sequences, exact launch counts):
    transformer_ibdecoder with the kernel flags off and on (R1: the
    token-causal flag on; the pair search; no decode kernel);
    transformer_afs in modes tf (st_context) and t, with coarse CTC and
    l0_compact_ratio 0.3 at decode, the gate noise injected, and once with
    noise that closes every gate of one row (the ST encoder and the cross
    attention see a row with no valid key); then the CTC port alone on an
    infeasible row (3 frames, 4 labels)."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops import ctc as ctc_mod
    from zero_tpu_torch.ops import l0norm
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.search import ib_beam_search

    counters = (fa.launches, ff.launches, da.launches)
    n = 2   # layers a stack of _small_model

    def seeded(model, cfg):
        def train(params, feats):
            loss = model.train_fn(params, feats, cfg,
                                  torch.Generator().manual_seed(SEED),
                                  step=100)["loss"]
            return loss, torch.autograd.grad(loss, list(params.parameters()))
        return train

    ib_model = get_model("transformer_ibdecoder")
    for flags in (False, True):
        cfg = _small_model(0.1, "transformer_ibdecoder")
        cfg.use_flash_attention = cfg.use_fused_ffn = flags
        want = ({"fused_attention": 3 * n, "fused_attention_backward": 3 * n,
                 "fused_ffn": 2 * n, "fused_ffn_backward": 2 * n}
                if flags else {})
        enc = {"fused_attention": n, "fused_ffn": n} if flags else {}
        _card_vs_cpu("ibdecoder_flags_%s" % ("on" if flags else "off"),
                     ib_model, cfg, _small_batch(), seeded(ib_model, cfg),
                     want, lambda steps, enc=enc: enc, counters,
                     search=ib_beam_search, name="slice14_reference")

    noises = {}

    def injected(closed_row):
        def noise(words, shape, device):
            key = (tuple(shape), closed_row)
            if key not in noises:
                u = np.random.RandomState(SEED + sum(shape)).rand(*shape)
                if closed_row is not None and len(shape) == 3:
                    u[closed_row] = 0.0
                noises[key] = torch.as_tensor(u.astype(np.float32))
            return noises[key].to(device)
        return noise

    afs_model = get_model("transformer_afs")
    for label, mode, context, closed in (("afs_tf_context", "tf", True, None),
                                         ("afs_t", "t", False, None),
                                         ("afs_closed_row", "tf", False, 0)):
        cfg = _small_afs(mode, context)
        asr = n * (2 if context else 1)
        attn = asr + n + 2 * n
        ffn = asr + n + n
        want = {"fused_attention": attn, "fused_attention_backward": attn,
                "fused_ffn": ffn, "fused_ffn_backward": ffn}
        enc = {"fused_attention": asr + n, "fused_ffn": asr + n}
        with mock.patch.object(l0norm, "uniform_noise", injected(closed)):
            out = _card_vs_cpu(
                label, afs_model, cfg, _small_speech_batch(),
                seeded(afs_model, cfg), want,
                lambda steps, enc=enc: dict(enc, decode_attention=n * steps),
                counters, source=_speech_source, name="slice14_reference")
        if not math.isfinite(out["loss_rel_err"]):
            raise AssertionError("slice14_reference %s: %s" % (label, out))

    # the CTC port alone: an infeasible row (3 frames, 4 labels) beside a
    # feasible one, card against CPU
    rs = np.random.RandomState(SEED)
    logits = torch.as_tensor((2.0 * rs.randn(2, 9, 8)).astype(np.float32))
    logit_pad = torch.zeros(2, 9)
    logit_pad[1, 3:] = 1.0
    labels = torch.as_tensor([[4, 1, 6, 0, 0], [3, 4, 5, 6, 0]])
    label_pad = (labels == 0).float()
    runs = []
    for device in ("cpu", "cuda"):
        x = logits.to(device).clone().requires_grad_(True)
        loss = ctc_mod.ctc_loss(x, logit_pad.to(device), labels.to(device),
                                label_pad.to(device))
        (grad,) = torch.autograd.grad(loss.sum(), [x])
        runs.append((loss.detach().cpu(), grad.cpu()))
    (lc, gc), (lg, gg) = runs
    out = dict(case="ctc_infeasible", loss_cpu=lc.tolist(),
               loss_rel_err=((lg - lc).abs() / lc.abs()).max().item(),
               grad_gap=(gg - gc).abs().max().item() / gc.abs().max().item())
    phase("slice14_reference", **out)
    if not (lc[1] > 1e5 and out["loss_rel_err"] <= 1e-6
            and out["grad_gap"] <= 1e-5):
        raise AssertionError("slice14_reference ctc: %s" % out)


# ---------------------------------------------------------------------------
# slice 15: the RNN models and the host side
# ---------------------------------------------------------------------------

# the default config's RNN widths (1000 hidden, 620 embed, 8 heads) at the
# transformer-base training settings, but 2 microbatches a step (4 before
# the sequence-parallel phases came, for the script's time); bf16 asked
# for, fp32 computed
RNN_SETTINGS = dict(default_dtype="bfloat16", dropout=0.1, token_size=4096,
                    update_cycle=2, hidden_size=1000, embed_size=620,
                    num_heads=8)
RNN_MODELS = {
    "rnn_train": dict(model_name="rnnsearch", scope_name="rnnsearch",
                      cell="atr", caencoder=True),
    # depth cut from the default 6+6 to 2+2 for the script's time: the
    # least at which use_deep_att, deepnmt's upper encoder layers and
    # rnnsearch_deepatt's alternating stack and later stages run; the
    # widths are the config's
    "deepnmt_train": dict(model_name="deepnmt", scope_name="deepnmt",
                          cell="lstm", caencoder=False, use_deep_att=True,
                          layer_norm=True, num_encoder_layer=2,
                          num_decoder_layer=2),
    "deepatt_train": dict(model_name="rnnsearch_deepatt",
                          scope_name="rnnsearch_deepatt", cell="gru",
                          num_encoder_layer=2, num_decoder_layer=2),
}
# rnn_train 3 before the data-parallel phases came
RNN_STEPS = {"rnn_train": 2, "deepnmt_train": 2, "deepatt_train": 2}
RNN_NOTE = ("MFU over the fp32 peak (67 TFLOP/s, TF32 off): the RNN models "
            "compute in fp32 under default_dtype=bfloat16, as in the JAX "
            "package; rnn_flops: matmul FLOPs at each step's stacked shape "
            "(forward x 3 and the chunked CE's recompute)")
HOST_WORKERS = 4
RNN_PROFILE_ROWS = 4


def rnn_config(d, label):
    """The phase's settings as a config file in ``d``."""
    path = os.path.join(d, label + ".json")
    with open(path, "w") as w:
        json.dump(dict(RNN_SETTINGS, **RNN_MODELS[label]), w)
    return path


def no_kernel_serving(cfg, served, serve_launches, score_launches):
    """No JAX RNN path reaches a Pallas kernel: serving and scoring launch
    none of #1-#12."""
    if serve_launches or score_launches:
        raise AssertionError("%s: serving launched %s, scoring %s, expected "
                             "no kernel" % (cfg["model_name"], serve_launches,
                                            score_launches))


# per cell: the fetched inputs' width and the hidden products' width, in
# units of hidden_size (rnns/__init__.py: gru gate_x 2d + hide_x d, gate_h
# 2d + hide_h d; lstm 3d + d, 3d + d; sru 4d, none; atr d, d; lrn 3d,
# none; olrn 4d, none)
CELL_WIDTHS = {"gru": (3, 3), "lstm": (4, 4), "sru": (4, 0), "atr": (1, 1),
               "lrn": (3, 0), "olrn": (4, 0)}


def rnn_flops(shapes, cfg, vocab=32768):
    """Matmul FLOPs of one training step of an RNN model (``cfg`` a config
    file's values over the defaults): each microbatch at the step's stacked
    shape, forward x 3 for forward and backward, plus the chunked CE's
    recomputed logits."""
    fwd, logits = rnn_forward_flops(stacked_shape(shapes), cfg, vocab)
    return (3 * fwd + logits) * len(shapes)


def rnn_forward_flops(shape, cfg, vocab=32768):
    """(forward matmul FLOPs of one microbatch of [rows, ls, lt], those of
    its softmax logits): the time loops run over every padded position;
    the additive attention's products are the query projection, the logits
    (per-head depth -> 1 over [B, H, K, S]) and the weighted sum
    (feed_memory is never run); the chunked CE's logits run over the rows
    padded to a whole chunk."""
    from zero_tpu_torch.config import default_config

    c = default_config().override_from_dict(dict(cfg))
    b, ls, lt = shape
    d, e = c.hidden_size, c.embed_size
    kx, kh = CELL_WIDTHS[c.cell]
    mult = 2 if c.cell in ("lstm", "sru") else 1
    ns, nt = b * ls, b * lt

    def cell(n, d_in):              # fetch + step products over n positions
        return 2 * n * d_in * kx * d + 2 * n * d * kh * d

    def attention(n, length, dm, s):    # per query position over s keys
        return 2 * n * d * dm + 4 * b * length * s * dm

    def cond(n, length, d_in, dm, one2one):
        flops = cell(n, d_in) + cell(n, dm)
        if not one2one:
            flops += 2 * ns * dm * dm + attention(n, length, dm, ls)
        return flops

    name = c.model_name
    if name == "rnnsearch":
        enc_dim = d if c.caencoder else 2 * d
        enc = cell(ns, e) + (cond(ns, ls, e, d, True) if c.caencoder
                             else cell(ns, e))
        fwd = (enc + 2 * b * enc_dim * d * mult
               + cond(nt, lt, e, enc_dim, False)
               + 2 * nt * (d + enc_dim + e) * e)
    elif name == "deepnmt":
        fwd = 0
        for layer in range(c.num_encoder_layer):
            fwd += cell(ns, e)
            y_dim = d
            if layer == 0:
                if c.caencoder:
                    fwd += cond(ns, ls, e, d, True)
                else:
                    fwd += cell(ns, e)
                    y_dim = 2 * d
            fwd += 2 * ns * y_dim * e
        if e != d:
            fwd += 2 * ns * e * d
        z_dim = 2 * d if (c.num_encoder_layer == 1 and not c.caencoder) \
            else d
        fwd += c.num_decoder_layer * 2 * b * z_dim * d * mult
        for layer in range(c.num_decoder_layer):
            if layer == 0 or c.use_deep_att:
                fwd += cond(nt, lt, e, d, False)
            elif c.caencoder:
                fwd += cond(nt, lt, e, d, True)
            else:
                fwd += cell(nt, e + d)
            fwd += 2 * nt * d * e
        if c.dl4mt_redict:
            fwd += 2 * nt * (e + d) * e
    elif name == "rnnsearch_deepatt":
        depth = c.num_decoder_layer
        fwd = (cell(ns, e) + c.num_encoder_layer * cond(ns, ls, e, d, True)
               + 2 * b * d * d * mult + cell(nt, e) + 2 * ns * d * d
               + depth * (attention(nt, lt, d, ls) + cell(nt, d))
               + 2 * nt * (d + depth * d + e) * e)
    else:
        raise ValueError("not an RNN model: %s" % name)
    chunk = int(c.loss_chunk_tokens or 0)
    rows = -(-nt // chunk) * chunk if chunk > 0 else nt
    logits = 2 * rows * e * vocab
    return fwd + logits, (logits if chunk > 0 else 0)


def rnn_launches(d, config, lengths=(8, 16), rows=RNN_PROFILE_ROWS):
    """CUDA kernels that one microbatch's forward and backward launch
    (torch.profiler) at ``rows`` x L x L for each L of ``lengths``; the
    time loops make them linear in L, and their count does not depend on
    the rows. Also the dtypes of the parameters and of the encoder's
    output. The phase's model at its config, random weights from SEED."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.vocab import Vocab

    cfg = default_config().override_from_dict(load_config_file(config))
    cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d, "vocab.txt"))
    model = get_model(cfg.model_name)
    params = model.init_fn(torch.Generator().manual_seed(SEED), cfg).cuda()
    rs = np.random.RandomState(SEED)
    counts = {}
    for length in lengths:
        feats = {k: torch.as_tensor(rs.randint(3, 32768, (rows, length)),
                                    device="cuda")
                 for k in ("source", "target")}

        def microbatch():
            loss = model.train_fn(params, feats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
            loss.backward()
            for p in params.parameters():
                p.grad = None
            torch.cuda.synchronize()

        microbatch()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            microbatch()
        counts[length] = sum(1 for e in prof.events()
                             if e.device_type == DeviceType.CUDA)
    with torch.no_grad():
        encodes = model.infer_fn(cfg).encode(params, feats["source"])[
            "encodes"]
    seen = sorted({str(p.dtype) for p in params.parameters()}
                  | {str(encodes.dtype)})
    return counts, seen


def rnn_train_phase(d, da, label):
    """One of this slice's RNN models (RNN_MODELS[label], full width) with
    both kernel flags on, which it ignores, RNN_STEPS steps: ms/step,
    target tokens/s, MFU over the fp32 peak (rnn_flops), peak memory, no
    launch of #1-#12; --mode test at beam 4 (rnnsearch also at beam 1) and
    --mode score (no kernel); then the CUDA launches a time step
    (rnn_launches) and the dtypes computed in. Returns the training
    results."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    config = rnn_config(d, label)
    results, served4 = train_phase(
        d, da, config, label, no_kernel, "", ("true",), no_kernel_serving,
        steps=RNN_STEPS[label], note=RNN_NOTE, peak=PEAK_FLOPS[torch.float32],
        flops_fn=rnn_flops)
    beam1 = {}
    if label == "rnn_train":
        served, served1 = serve_checkpoint(
            d, label, (fa.launches, ff.launches, da.launches), beam=1)
        if served1:
            raise AssertionError("%s beam 1 launched %s" % (label, served1))
        beam1 = dict(beam=1, sentences_per_s=served["sentences"]
                     / served["seconds"], decode_steps=served["steps"],
                     served_bleu=served["bleu"], serve_launches=served1)
    counts, seen = rnn_launches(d, config)
    (l0, k0), (l1, k1) = sorted(counts.items())
    per_step = (k1 - k0) / (l1 - l0)
    phase(label, cuda_launches_per_microbatch={
        "%dx%dx%d" % (RNN_PROFILE_ROWS, n, n): k for n, k in counts.items()},
        cuda_launches_per_time_step=per_step, dtypes=seen, **beam1)
    if seen != ["torch.float32"]:
        raise AssertionError("%s computes in %s, expected fp32" % (label,
                                                                   seen))
    results.update(served_beam4=served4, launches_per_time_step=per_step)
    return results


def rnn_ensemble(d, da):
    """--mode ensemble at beam 4 over rnn_train's and deepnmt_train's
    checkpoints (the beam gather permutes both caches): every test line, no
    kernel."""
    from zero_tpu_torch import run
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    for c in counters:
        c.clear()
    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_test_file={0}/test.src,tgt_test_file={0}/test.tgt,"
            "test_output={0}/rnn_ensemble.txt,eval_batch_size=32,"
            "beam_size=4".format(d))
    summary = run.main(["--mode", "ensemble", "--ensemble_dirs",
                        "{0}/rnn_train_true;{0}/deepnmt_train_true".format(d),
                        "--parameters", spec])
    launches = collect(counters)
    with open(os.path.join(d, "rnn_ensemble.txt")) as r:
        lines = r.read().splitlines()
    phase("deepnmt_train", ensemble=["rnnsearch", "deepnmt"],
          sentences=summary["sentences"], bleu=summary["bleu"],
          sentences_per_s=summary["sentences"] / summary["seconds"],
          decode_steps=summary["steps"], launches=launches)
    if len(lines) != TEST_SENTENCES or summary["sentences"] \
            != TEST_SENTENCES or launches:
        raise AssertionError("rnn ensemble: %d lines, launches %s"
                             % (len(lines), launches))


def _small_rnn(name, dropout, **over):
    """_small_model (64 wide, 2+2 layers, 4 heads) as an RNN model."""
    cfg = _small_model(dropout, name)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


# small fp32 models, all six cells: (label, model, overrides)
RNN_REFERENCE = (
    ("rnnsearch_gru_caencoder", "rnnsearch", dict(cell="gru")),
    ("rnnsearch_lstm", "rnnsearch", dict(cell="lstm", caencoder=False)),
    ("deepnmt_sru_xmap_ln", "deepnmt",
     dict(cell="sru", caencoder=True, embed_size=48, layer_norm=True)),
    ("deepnmt_lrn_deep_att", "deepnmt",
     dict(cell="lrn", caencoder=False, use_deep_att=True)),
    ("deepatt_olrn", "rnnsearch_deepatt", dict(cell="olrn")),
    ("deepatt_atr_ln", "rnnsearch_deepatt", dict(cell="atr",
                                                 layer_norm=True)),
)


def rnn_reference_phase(da):
    """Small fp32 models of the three RNN models over the six cells
    (RNN_REFERENCE) with dropout 0.1, card against CPU on the same seed
    words (_card_vs_cpu: loss within 1e-6 relative, grads within 1e-5 of
    their max, identical beam-4 sequences, no kernel launch)."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    counters = (fa.launches, ff.launches, da.launches)
    for label, name, over in RNN_REFERENCE:
        model = get_model(name)
        cfg = _small_rnn(name, 0.1, **over)

        def train(params, feats, model=model, cfg=cfg):
            loss = model.train_fn(params, feats, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
            grads = torch.autograd.grad(loss, list(params.parameters()),
                                        allow_unused=True)
            return loss, [torch.zeros_like(p) if g is None else g
                          for p, g in zip(params.parameters(), grads)]

        _card_vs_cpu(label, model, cfg, _small_batch(), train, {},
                     lambda steps: {}, counters, name="rnn_reference")


def _tokenise_s(make):
    t0 = time.perf_counter()
    ds = make()
    ds.tokenize()
    return ds._id_cache, time.perf_counter() - t0


def host_phase(d):
    """The native tokeniser built with g++ into zero_tpu_torch/_build/, the
    python path, process_num=HOST_WORKERS forked workers (train.py's
    dataset) and the native path with as many threads on the 8000-pair
    training corpus: identical ids, tokens/s of each, the native counter
    exactly +1 where the native path ran and +0 where not; then the metric
    CLI and the chrF script on rnn_train's beam-4 output."""
    import contextlib
    import io

    from zero_tpu_torch import metric, native, train
    from zero_tpu_torch.config import default_config
    from zero_tpu_torch.data import Dataset
    from zero_tpu_torch.scripts import chrf
    from zero_tpu_torch.vocab import Vocab

    if not native.available():
        raise AssertionError("host: the native tokeniser did not build")
    vocab_file = os.path.join(d, "vocab.txt")
    vocab = Vocab(vocab_file)
    src, tgt = os.path.join(d, "train.src"), os.path.join(d, "train.tgt")
    params = default_config().parse(
        "process_num=%d,native_tokenizer=false,src_vocab_file=%s,"
        "tgt_vocab_file=%s,max_len=100" % (HOST_WORKERS, vocab_file,
                                           vocab_file))
    params.src_vocab = params.tgt_vocab = vocab

    def python_path():
        return Dataset(src, tgt, vocab, vocab, max_len=100, use_native=False)

    def native_path():
        return Dataset(src, tgt, vocab, vocab, max_len=100,
                       num_workers=HOST_WORKERS,
                       vocab_files=(vocab_file, vocab_file))

    runs = {}
    for label, make in (("python", python_path),
                        ("forked", lambda: train._make_dataset(
                            params, src, tgt, train=True)),
                        ("native", native_path)):
        before = native.calls["encode_corpus"]
        ids, seconds = _tokenise_s(make)
        runs[label] = (ids, seconds, native.calls["encode_corpus"] - before)
    want = [(list(s), list(t)) for s, t in runs["python"][0]]
    with open(src) as r:
        lines = sum(1 for _ in r)
    tokens = sum(len(s) + len(t) for s, t in want)
    same = {label: [(list(s), list(t)) for s, t in ids] == want
            for label, (ids, _, _) in runs.items()}
    counted = {label: n for label, (_, _, n) in runs.items()}

    def cli(main, argv):
        out = io.StringIO()
        saved = sys.argv
        sys.argv = argv
        try:
            with contextlib.redirect_stdout(out):
                main()
        finally:
            sys.argv = saved
        return out.getvalue().strip()

    hyp = os.path.join(d, "rnn_train_trained.txt")
    ref = os.path.join(d, "test.tgt")
    scores = {"otem_utem_bleu": cli(metric.main, ["metric", hyp, ref]),
              "detok_bleu": cli(metric.main, ["metric", "--detok", hyp, ref]),
              "chrf": cli(chrf.main, ["chrf", "-H", hyp, "-R", ref])}
    phase("host", library=os.path.relpath(native._load()._name, REPO),
          pairs=len(want), tokens=tokens,
          tokens_per_s={label: tokens / s for label, (_, s, _) in
                        runs.items()},
          workers=HOST_WORKERS, same_ids=same, native_calls=counted,
          metrics=scores)
    if not (all(same.values()) and counted == {"python": 0, "forked": 0,
                                               "native": 1}
            and all(scores.values()) and len(want) == lines):
        raise AssertionError("host: ids equal %s, native calls %s, metrics "
                             "%s" % (same, counted, scores))


DP_STEPS = 2
DP_WORLD = 2
DP_DEV = 8       # dev sentences: the final eval's BLEU, equal on every rank
DP_NOTE = ("two gloo ranks share the one card: they measure correctness "
           "(one state and one BLEU on every rank), not NCCL bandwidth")
DP_TRAIN_KERNELS = ("fused_attention", "fused_attention_backward",
                    "fused_ffn", "fused_ffn_backward")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dp_train_run(d, out, extra):
    """One process's --mode train of the base config (BASE_CUT, both
    kernel flags) with the final dev eval; its state is kept through the
    training loop's init_train_state. Returns its numbers, launch counts,
    its bytes of parameters, moments and EMA (its shards under ZeRO)
    beside the whole state's, ZeRO's reduce-scatter and all-gather a step
    and a checksum of the whole parameters (the float64 sum, sum of
    squares and sum of |change| since init; gathered under ZeRO-3,
    COLLECTIVE)."""
    from zero_tpu_torch import run
    from zero_tpu_torch import train as train_mod
    from zero_tpu_torch.ops.kernels import decode_attention as da
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.parallel import distributed as dist
    from zero_tpu_torch.parallel.mesh import per_rank_bytes

    held = {}
    real = train_mod.init_train_state

    def keep(*args, **kwargs):
        state = held["state"] = real(*args, **kwargs)
        # the initial whole parameters, on the host (every rank is here)
        held["init"] = [p.detach().cpu() for p in dist.host_fetchable(
            {"params": state.params}, state.layout)["params"].parameters()]
        return state

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "src_dev_file={0}/dev.src,tgt_dev_file={0}/dev.tgt,"
            "eval_batch_size={2},output_dir={1},use_flash_attention=true,"
            "use_fused_ffn=true,max_training_steps={3},disp_freq=1,"
            "save_freq=0,eval_freq=0,sample_freq=0,epoches=100{4}"
            .format(d, out, DP_DEV, DP_STEPS, extra))
    counters = (fa.launches, ff.launches, da.launches)
    for c in counters:
        c.clear()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_mod, "init_train_state", keep):
        summary = run.main(["--mode", "train", "--config", CONFIG,
                            "--parameters", spec])
    launches = collect(counters)
    state = held["state"]
    # the whole parameters: under ZeRO-3 each rank holds shards (a
    # collective: every rank gathers)
    whole = dist.host_fetchable({"params": state.params},
                                state.layout)["params"]
    params = [p.detach().double() for p in whole.parameters()]
    whole_bytes = sum(p.numel() * 4 for p in whole.parameters())
    del whole
    ends = summary["step_end_times"]
    reduce = summary["allreduce"]
    steps = max(summary["steps"], 1)
    return dict(
        zero_stage=state.zero_stage,
        per_rank_bytes={"params": per_rank_bytes(state.params),
                        "moments": per_rank_bytes(state.opt),
                        "ema": per_rank_bytes(state.ema)},
        # stage 0's: the whole parameters, moments (and Adam's count), EMA
        whole_bytes={"params": whole_bytes, "moments": 2 * whole_bytes + 4,
                     "ema": whole_bytes if state.ema is not None else 0},
        reduce_scatter_per_step={k: reduce["reduce_scatter"][k] / steps
                                 for k in ("calls", "bytes", "ms")},
        all_gather_per_step={k: reduce["all_gather"][k] / steps
                             for k in ("calls", "bytes", "ms")},
        # tensor and expert parallelism's all-reduces (parallel/
        # distributed.py copy_in and reduce_out) a step
        model_reduce_per_step={k: reduce["model_reduce"][k] / steps
                               for k in ("calls", "bytes", "ms")},
        expert_reduce_per_step={k: reduce["expert_reduce"][k] / steps
                                for k in ("calls", "bytes", "ms")},
        steps=summary["steps"], shapes=summary["shapes"],
        losses=summary["losses"], step_s=[b - a for a, b in
                                          zip(ends[:-1], ends[1:])],
        tokens=summary["target_tokens"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        allreduce_ms_per_step=reduce["ms"] / summary["steps"],
        allreduce_bytes_per_step=reduce["bytes"] // summary["steps"],
        allreduce_calls_per_step=reduce["calls"] / summary["steps"],
        train_launches={k: launches.get(k + "_tc" if k.startswith(
            "fused_attention") else k, 0) for k in DP_TRAIN_KERNELS},
        launches=launches, bleu=summary["bleu"],
        checksum=[float(sum(p.sum() for p in params)),
                  float(sum((p * p).sum() for p in params)),
                  # the update's own size, which the other two barely
                  # show at the first steps' learning rate
                  float(sum((p - p0.to(p.device, torch.float64)).abs().sum()
                            for p, p0 in zip(params, held["init"])))])


def dp_reference_run(rank, world):
    """The small fp32 model on the card, both kernel flags on, dropout off
    and on: this process's rows of dp_batch (every row without a process
    group). Returns {rate: (loss, grads summed over the processes,
    parameters after one Adam step, launches)}."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.parallel import distributed as dist
    from zero_tpu_torch.train_step import (global_batch, init_train_state,
                                           make_train_step)

    model = get_model("transformer")
    # _small_batch's six rows: the all-pad one in the second process's slot
    feats = _small_batch()
    rows = feats["source"].shape[0] // world
    local = {k: v[rank * rows:(rank + 1) * rows].cuda()
             for k, v in feats.items()}
    out = {}
    for rate in (0.0, 0.1):
        cfg = _small_model(rate)
        # Adam's epsilon: a gradient of rounding noise (a key bias's) would
        # move its weight by +-lr at 1e-9, whichever sign the noise took
        cfg.epsilon = 1e-6
        cfg.device = "cuda"
        fa.launches.clear()
        ff.launches.clear()
        params = model.init_fn(torch.Generator().manual_seed(SEED),
                               cfg).cuda()
        with global_batch(rows):
            loss = model.train_fn(params, local, cfg,
                                  torch.Generator().manual_seed(SEED))["loss"]
            grads = [g.contiguous() for g in torch.autograd.grad(
                loss, list(params.parameters()))]
        if dist.active():
            dist.all_reduce_sum_(grads)
        state = init_train_state(model, cfg,
                                 torch.Generator().manual_seed(SEED), "cuda")
        make_train_step(model, cfg)(
            state, {k: v[None] for k, v in local.items()}, 1e-3,
            torch.Generator().manual_seed(SEED))
        out[rate] = (loss.item(), [g.cpu() for g in grads],
                     [p.detach().cpu() for p in state.params.parameters()],
                     collect((fa.launches, ff.launches)))
    return out


def dp_worker(spec_path):
    """One rank of the two that share the card (chip_smoke.py --dp-worker
    SPEC): its own gloo group, then the runs of dp_train, dp_reference,
    zero_train, zero_reference, moe_dp, tp_train, tp_reference,
    tp_ml_train, ep_train, sp_train and sp_reference that SPEC's tasks
    name; writes their results (torch.save)."""
    import torch.distributed as tdist

    with open(spec_path) as r:
        spec = json.load(r)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    tdist.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:%d" % spec["port"],
        world_size=spec["world"], rank=spec["rank"])
    out = {}
    try:
        if "train" in spec["tasks"]:
            out["train"] = dp_train_run(spec["d"], spec["out"],
                                        spec["extra"])
        if "reference" in spec["tasks"]:
            out["reference"] = dp_reference_run(spec["rank"], spec["world"])
        if "zero_train" in spec["tasks"]:
            out["zero_train"] = zero_train_worker(spec["d"], spec["extra"])
        if "zero_reference" in spec["tasks"]:
            out["zero_reference"] = zero_reference_run()
        if "moe_dp" in spec["tasks"]:
            out["moe_dp"] = moe_dp_run(spec["d"], spec["rank"],
                                       spec["world"])
        if "tp_train" in spec["tasks"]:
            out["tp_train"] = dp_train_run(
                spec["d"], os.path.join(spec["d"], "tp_gloo"),
                spec["extra"] + ZERO_EXTRA + TP_EXTRA)
        if "tp_reference" in spec["tasks"]:
            out["tp_reference"] = tp_reference_run()
        if "tp_ml_train" in spec["tasks"]:
            out["tp_ml_train"] = tp_ml_run(
                os.path.join(spec["d"], "multilingual"),
                os.path.join(spec["d"], "tp_ml_gloo"),
                spec["extra"][len(BASE_CUT):] + ",mesh_model=2")
        if "ep_train" in spec["tasks"]:
            out["ep_train"] = ep_train_run(spec["d"])
        if "sp_train" in spec["tasks"]:
            out["sp_train"] = sp_train_run(
                spec["d"], os.path.join(spec["d"], "sp_gloo"),
                spec["extra"][len(BASE_CUT):] + SP_EXTRA)
        if "sp_reference" in spec["tasks"]:
            out["sp_reference"] = sp_reference_run()
    finally:
        tdist.destroy_process_group()
    torch.save(out, spec["result"])
    return 0


def dp_workers(d, tasks):
    """Run ``tasks`` on DP_WORLD gloo ranks sharing the card, each a
    subprocess of this script; returns their results in rank order."""
    port, procs, results = free_port(), [], []
    env = dict(os.environ, OMP_NUM_THREADS="4")
    for rank in range(DP_WORLD):
        spec = dict(port=port, world=DP_WORLD, rank=rank, tasks=tasks, d=d,
                    out=os.path.join(d, "dp_gloo"),
                    extra=BASE_CUT + ",dist_num_processes=%d,"
                    "dist_process_id=%d" % (DP_WORLD, rank),
                    result=os.path.join(d, "dp_rank%d.pt" % rank))
        path = os.path.join(d, "dp_rank%d.json" % rank)
        with open(path, "w") as w:
            json.dump(spec, w)
        results.append(spec["result"])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", path],
            env=env))
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise AssertionError("dp workers exited %s" % codes)
    return [torch.load(r, weights_only=False) for r in results]


def dp_numbers(runs, cfg):
    """ms/step (median over the ranks' steps after the first), global
    target tokens/s, peak memory, the all-reduce's ms and bytes a step,
    and the launch counts of one or more ranks' runs; their launches are
    held to expected_launches plus the final dev eval's encoder (one
    batch: #1 and #11 once a layer)."""
    for r in runs:
        if r["steps"] != DP_STEPS or not all(map(math.isfinite,
                                                 r["losses"])):
            raise AssertionError("dp_train: steps %d, losses %s"
                                 % (r["steps"], r["losses"]))
        want = expected_launches(cfg, r)
        for name in want:
            if name in ("fused_attention_tc", "fused_ffn"):
                want[name] += cfg["num_encoder_layer"]
        got = {k + ("_tc" if k.startswith("fused_attention") else ""): v
               for k, v in r["train_launches"].items()}
        if got != want or any(k.endswith("_ref") for k in r["launches"]):
            raise AssertionError("dp_train launches %s, expected %s"
                                 % (r["launches"], want))
    step_s = sorted(s for r in runs for s in r["step_s"])
    timed = max(sum(r["step_s"]) for r in runs)
    return dict(
        ms_per_step_median=1e3 * step_s[len(step_s) // 2],
        global_target_tokens_per_s=sum(sum(r["tokens"][1:])
                                       for r in runs) / timed,
        peak_gib=[r["peak_gib"] for r in runs],
        allreduce_ms_per_step=[r["allreduce_ms_per_step"] for r in runs],
        allreduce_bytes_per_step=runs[0]["allreduce_bytes_per_step"],
        allreduce_calls_per_step=runs[0]["allreduce_calls_per_step"],
        launches_per_rank=[r["launches"] for r in runs],
        checksums=[r["checksum"] for r in runs],
        bleu=[r["bleu"] for r in runs],
        losses=runs[0]["losses"])


DP_PHASES = {"dp_train", "dp_reference", "zero_train", "zero_reference",
             "moe_dp", "tp_train", "tp_reference", "tp_ml_train",
             "ep_train", "sp_train", "sp_reference"}
DP_TASKS = (("dp_train", "train"), ("dp_reference", "reference"),
            ("zero_train", "zero_train"), ("zero_reference",
                                           "zero_reference"),
            ("moe_dp", "moe_dp"), ("tp_train", "tp_train"),
            ("tp_reference", "tp_reference"), ("tp_ml_train", "tp_ml_train"),
            ("ep_train", "ep_train"), ("sp_train", "sp_train"),
            ("sp_reference", "sp_reference"))


def dp_train_phase(d, todo):
    """dp_train: a world of one over NCCL in this process, then two gloo
    ranks on the card, which also run the work of the other data-parallel
    phases asked for (dp_reference, zero_train, zero_reference, moe_dp),
    one after another in the same two processes. Returns (the world of
    one's launches and each rank's, or None without dp_train; the ranks'
    results; the world of one's run or None)."""
    from zero_tpu_torch.config import load_config_file

    for side in ("src", "tgt"):
        with open(os.path.join(d, "test." + side)) as r, \
                open(os.path.join(d, "dev." + side), "w") as w:
            w.writelines(r.readlines()[:DP_DEV])
    cfg = load_config_file(CONFIG)
    cfg.update(overrides(BASE_CUT))
    one = None
    if "dp_train" in todo:
        one = dp_train_run(d, os.path.join(d, "dp_nccl"), BASE_CUT
                           + ",dist_coordinator=127.0.0.1:%d,"
                           "dist_num_processes=1,dist_process_id=0"
                           % free_port())
        numbers = dp_numbers([one], cfg)
        if not (one["allreduce_calls_per_step"] > 0
                and one["bleu"] is not None and math.isfinite(one["bleu"])):
            raise AssertionError("dp_train world of one: all-reduce %s, "
                                 "BLEU %s" % (one["allreduce_calls_per_step"],
                                              one["bleu"]))
        phase("dp_train", world=1, backend="nccl", steps=DP_STEPS, **numbers)
    ranks = dp_workers(d, [task for name, task in DP_TASKS if name in todo])
    if one is None:
        return None, None, ranks, None
    numbers = dp_numbers([r["train"] for r in ranks], cfg)
    if len(set(map(tuple, numbers["checksums"]))) != 1 \
            or len(set(numbers["bleu"])) != 1 or numbers["bleu"][0] is None:
        raise AssertionError("dp_train ranks differ: checksums %s, BLEU %s"
                             % (numbers["checksums"], numbers["bleu"]))
    phase("dp_train", world=DP_WORLD, backend="gloo", steps=DP_STEPS,
          note=DP_NOTE, **numbers)
    return (one["train_launches"],
            [r["train"]["train_launches"] for r in ranks], ranks, one)


def dp_kernel_checks():
    """Every dropout kernel against its plain version on rows 3-6 of a
    global batch of 8 (ops/common.py:global_batch), rate 0.1: #1/#2 and
    #3/#4 (causal and not), #5-#7, #11/#12, in fp32 (CUDA cores) and bf16
    (tensor cores), forward outputs and input grads. A launch that
    dropped its row base would draw row 0's masks; the outputs inside the
    batch must also differ from those at base 0. Returns {case: max |kernel
    - plain|}."""
    import types

    from zero_tpu_torch.ops import common
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, h, lq, lk, dh, m = 4, 2, 40, 40, 64, 3
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        def rand(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v = (rand(b, h, lq, dh).requires_grad_() for _ in range(3))
        pad = torch.ones(b, lk, device="cuda")
        pad[1, 30:] = 0.0
        tables = types.SimpleNamespace(keys=rand(2 * m + 1, dh),
                                       values=rand(2 * m + 1, dh))
        x = rand(b * 10, 64).requires_grad_()
        w1, b1, w2, b2 = rand(64, 128) * 0.1, rand(128), rand(128, 64) * 0.1, \
            rand(64)
        cases = {}
        for causal in (False, True):
            cases["fused_causal%d" % causal] = (
                lambda c=causal: fa.fused_attention(
                    q, k, v, pad, causal=c, dropout_rate=0.1,
                    rng=SEED_WORDS),
                lambda c=causal: fa.fused_attention_ref(
                    q, k, v, pad, c, 0.1, SEED_WORDS), (q, k, v))
            cases["rpr_causal%d" % causal] = (
                lambda c=causal: fa.fused_attention(
                    q, k, v, pad, causal=c, dropout_rate=0.1,
                    rng=SEED_WORDS, rpr_tables=tables,
                    max_relative_position=m),
                lambda c=causal: fa.fused_attention_rpr_ref(
                    q, k, v, pad, tables.keys, tables.values, m, c, 0.1,
                    SEED_WORDS), (q, k, v))
            cases["streaming_causal%d" % causal] = (
                lambda c=causal: sa.streaming_attention(
                    q, k, v, pad, causal=c, dropout_rate=0.1,
                    rng=SEED_WORDS),
                lambda c=causal: sa.streaming_attention_ref(
                    q, k, v, pad, c, 0.1, SEED_WORDS), (q, k, v))
        cases["ffn"] = (lambda: ff.fused_ffn(x, w1, b1, w2, b2, SEED_WORDS,
                                             0.1),
                        lambda: ff.fused_ffn_ref(x, w1, b1, w2, b2,
                                                 SEED_WORDS, 0.1), (x,))
        for name, (kernel, plain, inputs) in cases.items():
            base0 = kernel().detach()
            with common.global_batch(3, 4, 8):
                got, want = kernel(), plain()
                dout = torch.ones_like(want)
                g_got = torch.autograd.grad(got, inputs, dout)
                g_want = torch.autograd.grad(want, inputs, dout)
            key = "%s_%s" % (name, str(dtype).split(".")[-1])
            out[key] = max(check(key, a, c, dtype, TRAIN_TOLERANCE)
                           for a, c in zip((got,) + g_got,
                                           (want,) + g_want))
            if torch.equal(base0, got.detach()):
                raise AssertionError("%s: the same masks at row base 0 and "
                                     "inside the global batch" % key)
    return out


def dp_reference_phase(ranks):
    """dp_reference: the ranks' results against one process on the global
    batch."""
    one = dp_reference_run(0, 1)
    report = {}
    for rate, (loss, grads, params, launches) in one.items():
        for rank, got in enumerate(ranks):
            g_loss, g_grads, g_params, g_launches = got[rate]
            g_scale = max(float(g.abs().max()) for g in grads)
            p_scale = max(float(p.abs().max()) for p in params)
            errs = dict(
                loss_rel_err=abs(g_loss - loss) / abs(loss),
                grad_err=max(float((a - b).abs().max())
                             for a, b in zip(g_grads, grads)) / g_scale,
                param_err=max(float((a - b).abs().max())
                              for a, b in zip(g_params, params)) / p_scale)
            report["p=%g rank %d" % (rate, rank)] = dict(
                errs, launches=g_launches)
            ran = all(k.get(n, 0) for k in (launches, g_launches)
                      for n in ("fused_attention_backward",
                                "fused_ffn_backward"))
            if not (errs["loss_rel_err"] <= 1e-6 and errs["grad_err"] <= 1e-5
                    and errs["param_err"] <= 1e-5 and ran):
                raise AssertionError("dp_reference p=%g rank %d: %s, "
                                     "launches %s, one process %s"
                                     % (rate, rank, errs, g_launches,
                                        launches))
    phase("dp_reference", world=DP_WORLD, one_process_launches={
        "p=%g" % r: v[3] for r, v in one.items()},
          row_base_max_abs_err=dp_kernel_checks(), **report)


ZERO_STAGES = (1, 2, 3)
# the EMA on (the base config keeps it off), so that its shards show
ZERO_EXTRA = ",ema_decay=0.9999"
# ZeRO's per-rank bytes at W = 2 against stage 0's (the whole state): the
# moments and the EMA from stage 1, the parameters at stage 3
ZERO_SHARE = 0.55
# each stage's parameter checksums (dp_train_run's: the sum, the sum of
# squares and the sum of |change| since init) and step losses against
# dp_train's (stage 0 on the same ranks, batches, seeds and weights),
# relative: a sum of two operands does not depend on its order, Adam is
# elementwise, and only the gnorm's order differs (stages 2-3), which the
# first step's m/sqrt(v) does not see. At the first steps' learning rate
# (~1.7e-7 and twice that) the update moves each parameter by about that
# much, so one 512-wide row updated wrongly moves the sum of |change| by
# ~1e-5 of it
ZERO_SAME = 1e-9


def zero_train_worker(d, extra):
    """zero_train on one of the two ranks: dp_train_run at zero_stage 1, 2
    and 3 in turn (each its own output directory; stage 3 writes the
    sharded checkpoint, sharded_checkpoint=auto), then stage 3 resumed
    from it for one more step, no dev eval; the restore's own-file
    slices are counted (saver.load_own_shards). Returns {stage: run} and
    the resume's {'steps', 'own_keys', 'files'}."""
    from zero_tpu_torch import saver as saver_mod

    runs = {}
    for stage in ZERO_STAGES:
        runs[stage] = dp_train_run(d, os.path.join(d, "zero%d" % stage),
                                   extra + ZERO_EXTRA
                                   + ",zero_stage=%d" % stage)
    out = os.path.join(d, "zero3")
    files = sorted(f for f in os.listdir(out) if f.startswith("model-"))
    own = []
    real = saver_mod.load_own_shards

    def counting(*args, **kwargs):
        got = real(*args, **kwargs)
        own.append(len(got))
        return got

    with mock.patch.object(saver_mod, "load_own_shards", counting):
        resumed = dp_train_run(d, out, extra + ZERO_EXTRA
                               + ",zero_stage=3,src_dev_file="
                               ",max_training_steps=%d" % (DP_STEPS + 1))
    return runs, dict(steps=resumed["steps"], own_keys=own, files=files)


def zero_reference_run():
    """The small fp32 model on the card, both kernel flags, dropout 0 and
    0.1, EMA on: this rank's rows of _small_batch, two Adam steps at each
    zero_stage 0-3 (every stage from the same seeds). Returns {(rate,
    stage): (losses, the whole moments, parameters and EMA after the
    steps, launches)}; the gather is COLLECTIVE."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.parallel import distributed as dist
    from zero_tpu_torch.saver import flat_tensors
    from zero_tpu_torch.train_step import init_train_state, make_train_step

    model = get_model("transformer")
    world, rank = dist.process_count(), dist.process_index()
    feats = _small_batch()
    rows = feats["source"].shape[0] // world
    local = {k: v[rank * rows:(rank + 1) * rows][None].cuda()
             for k, v in feats.items()}
    out = {}
    for rate in (0.0, 0.1):
        for stage in (0,) + ZERO_STAGES:
            cfg = _small_model(rate)
            cfg.epsilon = 1e-6
            cfg.ema_decay = 0.9
            cfg.zero_stage = stage
            cfg.device = "cuda"
            fa.launches.clear()
            ff.launches.clear()
            state = init_train_state(model, cfg,
                                     torch.Generator().manual_seed(SEED),
                                     "cuda")
            step_fn = make_train_step(model, cfg)
            losses = []
            for s, lr in enumerate((1e-3, 2e-3)):
                _, m = step_fn(state, local, lr,
                               torch.Generator().manual_seed(SEED + s))
                losses.append(float(m["loss"]))
            trees = dist.host_fetchable({"params": state.params,
                                         "opt": state.opt,
                                         "ema": state.ema}, state.layout)
            out[(rate, stage)] = (
                losses, {k: t.detach().cpu().clone()
                         for k, t in flat_tensors(trees).items()},
                collect((fa.launches, ff.launches)))
    return out


def moe_config(d):
    """transformer_moe as moe_train runs it (the base config at MOE_EXTRA's
    2+2, 8 experts, top-1, einsum dispatch) in fp32, dropout 0.1 (the
    expert FFN's too), Adam's epsilon 1e-6."""
    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.vocab import Vocab

    values = load_config_file(CONFIG)
    values.update(overrides(MOE_EXTRA))
    values.update(default_dtype="float32", epsilon=1e-6, device="cuda")
    cfg = default_config().override_from_dict(values)
    cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d, "vocab.txt"))
    return cfg


def moe_pass(cfg, feats, rows=None):
    """loss, grads and the parameters after one Adam step of
    transformer_moe from SEED on ``feats``: the rows of this rank's slice
    of a global batch (the gradients summed over the ranks), or, with
    ``rows`` None, the whole batch in one process."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.parallel import distributed as dist
    from zero_tpu_torch.train_step import (global_batch, init_train_state,
                                           make_train_step)

    model = get_model("transformer_moe")
    params = model.init_fn(torch.Generator().manual_seed(SEED), cfg).cuda()
    with (global_batch(rows) if rows else contextlib.nullcontext()):
        loss = model.train_fn(params, feats, cfg,
                              torch.Generator().manual_seed(SEED))["loss"]
        grads = [g.contiguous() for g in torch.autograd.grad(
            loss, list(params.parameters()))]
    if rows:
        dist.all_reduce_sum_(grads)
    del params
    state = init_train_state(model, cfg, torch.Generator().manual_seed(SEED),
                             "cuda")
    make_train_step(model, cfg)(state, {k: v[None] for k, v in feats.items()},
                                1e-3, torch.Generator().manual_seed(SEED))
    return loss.item(), grads, [p.detach() for p in
                                state.params.parameters()]


def moe_dp_run(d, rank, world):
    """moe_dp on one of the two ranks: this rank's rows of
    _full_width_batch (its last row all pad, in rank 1's slot) through
    moe_pass; rank 0 then runs the whole batch as one process (the group
    out of reach: no collective) and compares. Returns rank 0's errors and
    every rank's launches."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.parallel import distributed as dist

    cfg = moe_config(d)
    feats = _full_width_batch()
    for v in feats.values():
        v[-1] = 0
    rows = feats["source"].shape[0] // world
    fa.launches.clear()
    ff.launches.clear()
    loss, grads, params = moe_pass(
        cfg, {k: v[rank * rows:(rank + 1) * rows] for k, v in feats.items()},
        rows)
    launches = collect((fa.launches, ff.launches))
    if rank:
        return dict(launches=launches)
    with mock.patch.object(dist, "active", lambda: False):
        one_loss, one_grads, one_params = moe_pass(cfg, feats)
    g_scale = max(float(g.abs().max()) for g in one_grads)
    p_scale = max(float(p.abs().max()) for p in one_params)
    return dict(
        launches=launches, loss=loss, one_process_loss=one_loss,
        loss_rel_err=abs(loss - one_loss) / abs(one_loss),
        grad_err=max(float((a - b).abs().max())
                     for a, b in zip(grads, one_grads)) / g_scale,
        param_err=max(float((a - b).abs().max())
                      for a, b in zip(params, one_params)) / p_scale)


def zero_train_phase(d, ranks, dp_ranks, cfg, counters):
    """zero_train: each stage's numbers from the two ranks (dp_numbers'
    checks: steps, launches, equal checksums and BLEU), its bytes against
    stage 0's, its parameter checksums and step losses against dp_train's
    gloo ranks (the same batches, seeds and weights: ZERO_SAME), the
    sharded checkpoint and its resume;
    then --mode test of the stage-3 checkpoint in this process, on one
    card. Returns each stage's launches a rank."""
    from zero_tpu_torch import run

    launches = {}
    for stage in ZERO_STAGES:
        per = [r["zero_train"][0][stage] for r in ranks]
        numbers = dp_numbers(per, cfg)
        if len(set(map(tuple, numbers["checksums"]))) != 1 \
                or len(set(numbers["bleu"])) != 1:
            raise AssertionError("zero_train stage %d ranks differ: %s, %s"
                                 % (stage, numbers["checksums"],
                                    numbers["bleu"]))
        share = {k: max(r["per_rank_bytes"][k] for r in per)
                 / per[0]["whole_bytes"][k] for k in ("params", "moments",
                                                       "ema")}
        want = {"moments": ZERO_SHARE, "ema": ZERO_SHARE}
        if stage == 3:
            want["params"] = ZERO_SHARE
        low = {k: share[k] <= v for k, v in want.items()}
        gathered = all(r["all_gather_per_step"]["calls"] > 0 for r in per)
        scattered = all((r["reduce_scatter_per_step"]["calls"] > 0)
                        == (stage >= 2) for r in per)
        # the parameters after the steps, and every step's loss (the
        # second the first update's), against stage 0's on the same ranks
        diff = max(abs(a - b) / abs(b) for z, s in zip(per, dp_ranks)
                   for a, b in zip(z["checksum"] + z["losses"],
                                   s["train"]["checksum"]
                                   + s["train"]["losses"]))
        same = len(dp_ranks) == len(per) and diff <= ZERO_SAME
        phase("zero_train", zero_stage=stage, world=DP_WORLD,
              backend="gloo", steps=DP_STEPS, note=DP_NOTE,
              per_rank_bytes=[r["per_rank_bytes"] for r in per],
              whole_bytes=per[0]["whole_bytes"], share_of_stage0=share,
              reduce_scatter_per_step=[r["reduce_scatter_per_step"]
                                       for r in per],
              all_gather_per_step=[r["all_gather_per_step"] for r in per],
              dp_train_checksums=[r["train"]["checksum"] for r in dp_ranks],
              dp_train_losses=dp_ranks[0]["train"]["losses"],
              rel_diff_from_dp_train=diff, **numbers)
        if not (all(low.values()) and gathered and scattered and same):
            raise AssertionError(
                "zero_train stage %d: bytes under %g %s, all-gather %s, "
                "reduce-scatter %s, checksums and losses within %g of "
                "dp_train's %s (%g)" % (stage, ZERO_SHARE, low, gathered,
                                        scattered, ZERO_SAME, same, diff))
        launches[stage] = [r["train_launches"] for r in per]
    resumes = [r["zero_train"][1] for r in ranks]
    want_files = ["model-%d.shard%d.npz" % (DP_STEPS, i)
                  for i in range(DP_WORLD)] + [
        "model-%d.shardmeta.json" % DP_STEPS]
    for r in resumes:
        if r["files"] != sorted(want_files) or r["steps"] != 1 \
                or not r["own_keys"] or not all(r["own_keys"]):
            raise AssertionError("zero_train sharded checkpoint and resume: "
                                 "%s (expected files %s)" % (r, want_files))
    for c in counters:
        c.clear()
    out = os.path.join(d, "zero_test.txt")
    served = run.main(["--mode", "test", "--parameters",
                       "src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/"
                       "vocab.txt,src_test_file={0}/test.src,tgt_test_file="
                       "{0}/test.tgt,output_dir={0}/zero3,test_output={1},"
                       "eval_batch_size=32,beam_size=4,dist_coordinator=,"
                       "dist_num_processes=1".format(d, out)])
    served_launches = collect(counters)
    with open(out) as r:
        lines = r.read().splitlines()
    phase("zero_train", mode="test", checkpoint="sharded (stage 3)",
          resume=resumes, sentences=served["sentences"],
          bleu=served["bleu"], seconds=served["seconds"],
          launches=served_launches)
    if not (len(lines) == TEST_SENTENCES == served["sentences"]
            and math.isfinite(served["bleu"])
            and served_launches.get("decode_pool_attention")):
        raise AssertionError("zero_train --mode test of the sharded "
                             "checkpoint: %d lines, %s, launches %s"
                             % (len(lines), served, served_launches))
    return launches


def zero_reference_phase(ranks):
    """zero_reference: stages 1-3 on two ranks against stage 0 on two
    ranks: losses within 1e-6 relative, the moments and parameters (and
    the EMA) after two Adam steps within 1e-5 of their max."""
    report = {}
    for rank, got in enumerate(r["zero_reference"] for r in ranks):
        for (rate, stage), (losses, state, launches) in got.items():
            if not stage:
                continue
            ref_losses, ref, _ = got[(rate, 0)]
            errs = dict(loss_rel_err=max(abs(a - b) / abs(b) for a, b in
                                         zip(losses, ref_losses)))
            for group in ("opt/.mu", "opt/.nu", "params", "ema"):
                keys = [k for k in ref if k.startswith(group + "/")]
                scale = max(float(ref[k].abs().max()) for k in keys)
                errs[group.split(".")[-1] + "_err"] = max(
                    float((state[k] - ref[k]).abs().max())
                    for k in keys) / scale
            ran = all(launches.get(n, 0) for n in (
                "fused_attention_backward", "fused_ffn_backward"))
            report["p=%g stage %d rank %d" % (rate, stage, rank)] = dict(
                errs, launches=launches)
            if not (errs["loss_rel_err"] <= 1e-6 and ran
                    and all(v <= 1e-5 for k, v in errs.items()
                            if k != "loss_rel_err")):
                raise AssertionError("zero_reference p=%g stage %d rank %d: "
                                     "%s, launches %s" % (rate, stage, rank,
                                                          errs, launches))
    phase("zero_reference", world=DP_WORLD, **report)


def moe_dp_phase(ranks):
    """moe_dp: two ranks of transformer_moe against one process on the
    global batch, dp_reference's tolerances."""
    got = ranks[0]["moe_dp"]
    phase("moe_dp", world=DP_WORLD, rank_launches=[r["moe_dp"]["launches"]
                                                  for r in ranks], **got)
    if not (got["loss_rel_err"] <= 1e-6 and got["grad_err"] <= 1e-5
            and got["param_err"] <= 1e-5):
        raise AssertionError("moe_dp: %s" % got)


# tensor parallelism on the two gloo ranks: mesh data 1 x model 2, so both
# ranks train every batch of the world of one; each rank writes its own
# parts of the checkpoints (no whole-state gather through host memory)
TP_EXTRA = ",mesh_model=2,sharded_checkpoint=true"
# each step's loss against dp_train's world of one (bf16: the partial
# products summed over the ranks round otherwise), relative: on an H100
# the second step's differs by 2.2e-5, the same in every run; another
# part's dropout masks would move it by far more
TP_SAME = 2e-4
# a rank's bytes of parameters, moments and EMA against the whole state's
# at W_m = 2: every projection and the 32768-row embedding split
TP_SHARE = 0.55


def split_pass(cfg, feats):
    """loss, grads and the parameters after one Adam step from SEED on the
    batch ``feats``, which every process of a model or expert line holds
    whole (data degree 1): each tensor as this process holds it ({name:
    tensor}), and the layout (None in one process)."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.train_step import (global_batch, init_train_state,
                                           make_train_step)

    model = get_model(cfg.model_name)
    state = init_train_state(model, cfg, torch.Generator().manual_seed(SEED),
                             "cuda")
    names = [n for n, _ in state.params.named_parameters()]
    with global_batch(feats["target"].shape[0]):
        loss = model.train_fn(state.params, feats, cfg,
                              torch.Generator().manual_seed(SEED))["loss"]
        # the RNN models' feed_memory serves the decode only
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(state.params.parameters(),
                                 torch.autograd.grad(
                                     loss, list(state.params.parameters()),
                                     allow_unused=True))]
    make_train_step(model, cfg)(state, {k: v[None] for k, v in feats.items()},
                                1e-3, torch.Generator().manual_seed(SEED))
    return (loss.item(), dict(zip(names, grads)),
            {n: p.detach() for n, p in state.params.named_parameters()},
            state.layout)


def split_errors(got, one):
    """A split run's loss, grads and updated parameters against the one
    process's (split_pass), each whole tensor cut to the process's part:
    the loss relative, the rest relative to their largest value."""
    loss, grads, params, layout = got
    one_loss, one_grads, one_params, _ = one

    def err(mine, whole):
        scale = max(float(t.abs().max()) for t in whole.values())
        return max(float((t - layout.part(n, whole[n])).abs().max())
                   for n, t in mine.items()) / scale

    return dict(loss=loss, one_process_loss=one_loss,
                loss_rel_err=abs(loss - one_loss) / abs(one_loss),
                grad_err=err(grads, one_grads),
                param_err=err(params, one_params),
                split_leaves=len(layout.splits))


def _even_vocab(cfg):
    """``cfg`` with a 44-row vocabulary (_small_model's 43 leave the
    embeddings whole at W = 2: the divisibility fallback)."""
    from zero_tpu_torch.vocab import Vocab

    vocab = Vocab()
    while vocab.size() < 44:
        vocab.insert("w%d" % vocab.size())
    cfg.src_vocab = cfg.tgt_vocab = vocab
    return cfg


def tp_reference_cases():
    """(label, config, batch, the kernels each rank must launch) of
    tp_reference: dp_reference's small fp32 transformer and
    transformer_rpr (43 rows: whole embeddings), then at 44 rows the
    models whose tensor parallelism came later: transformer_aan (with
    use_ffn), transformer_fuse, transformer_clsr (3 languages, no
    kernel), transformer_ibdecoder, transformer_afs (speech, CTC),
    rnnsearch, deepnmt and rnnsearch_deepatt (no kernel, embeddings
    split), and transformer_moe under scan_layers at mesh_expert=2 (no
    kernel; its own init_fn ignores scan_layers, as the JAX package's).
    Adam's epsilon is dp_reference's 1e-6, CLSR's 1e-5: its gated
    ``shared`` projections take gradients of ~1e-7 of the largest, whose
    fp32 rounding (another order of the line's sums) Adam at 1e-6 would
    turn into 1.4e-5 of the largest weight in one step."""
    core = ("fused_attention", "fused_attention_backward", "fused_ffn",
            "fused_ffn_backward")
    batch = _small_batch()
    out = [("transformer", _small_model(0.1), batch, core),
           ("transformer_rpr", _small_model(0.1, "transformer_rpr"), batch,
            ("fused_attention_rpr", "fused_attention_rpr_backward"))]
    for _, cfg, _, _ in out:
        cfg.epsilon = 1e-6
    for name, over, feats, want in (
            ("transformer_aan", dict(use_ffn=True), batch, core),
            ("transformer_fuse", {}, batch, core),
            ("transformer_clsr", dict(num_languages=3, lang_id_offset=3,
                                      clsr_budget=0.3, clsr_alpha=0.7,
                                      epsilon=1e-5),
             _tagged_small_batch(3), ()),
            ("transformer_ibdecoder", {}, batch, core),
            ("transformer_afs", None, _small_speech_batch(), core),
            ("rnnsearch", {}, batch, ()),
            ("deepnmt", dict(cell="sru", use_deep_att=True), batch, ()),
            ("rnnsearch_deepatt", dict(cell="atr"), batch, ()),
            ("transformer_moe", dict(scan_layers=True, moe_num_experts=4,
                                     moe_top_k=2, moe_dispatch="einsum",
                                     mesh_model=1, mesh_expert=2),
             batch, ())):
        if over is None:
            cfg = _small_afs()
            cfg.epsilon = 1e-6
            cfg.st_context = False
            feats = {k: v for k, v in feats.items()
                     if not k.startswith("context")}
        else:
            cfg = _small_model(0.1, name)
            cfg.epsilon = 1e-6
            for k, v in over.items():
                setattr(cfg, k, v)
        out.append((name, _even_vocab(cfg), feats, want))
    return out


def tp_reference_run():
    """tp_reference on one of the two ranks: each of tp_reference_cases'
    small fp32 models (dropout 0.1: the CUDA-core #1-#4 and #11/#12 over
    each rank's heads and hidden slice, at the whole heads' and width's
    dropout index) at mesh_model=2 (transformer_moe at mesh_expert=2) on
    its whole batch, against one process (the group out of reach: no
    collective). Returns {model: errors and launches}."""
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.parallel import distributed as dist

    out = {}
    for name, cfg, feats, _ in tp_reference_cases():
        feats = {k: v.cuda() for k, v in feats.items()}
        cfg.device = "cuda"
        axis = "mesh_expert" if getattr(cfg, "mesh_expert", 1) > 1 \
            else "mesh_model"
        setattr(cfg, axis, 2)
        fa.launches.clear()
        ff.launches.clear()
        got = split_pass(cfg, feats)
        launches = collect((fa.launches, ff.launches))
        setattr(cfg, axis, 1)
        with mock.patch.object(dist, "active", lambda: False):
            one = split_pass(cfg, feats)
        out[name] = dict(split_errors(got, one), launches=launches)
    return out


def tp_reference_phase(ranks):
    """tp_reference: the two ranks against one process (loss 1e-6
    relative, grads and parameters 1e-5 of their max), every model with
    split leaves and its kernels (tp_reference_cases) launched on both
    ranks. Returns each rank's launches over every model."""
    want = {name: kernels for name, _, _, kernels in tp_reference_cases()}
    report, per_rank = {}, []
    for rank, got in enumerate(r["tp_reference"] for r in ranks):
        total = collections.Counter()
        if sorted(got) != sorted(want):
            raise AssertionError("tp_reference rank %d ran %s"
                                 % (rank, sorted(got)))
        for name, errs in got.items():
            report["%s rank %d" % (name, rank)] = errs
            total.update(errs["launches"])
            ran = all(errs["launches"].get(k, 0) for k in want[name])
            if not (errs["loss_rel_err"] <= 1e-6 and errs["grad_err"] <= 1e-5
                    and errs["param_err"] <= 1e-5 and ran
                    and errs["split_leaves"]):
                raise AssertionError("tp_reference %s rank %d: %s"
                                     % (name, rank, errs))
        per_rank.append(dict(total))
    phase("tp_reference", world=DP_WORLD, mesh="data 1 x model 2 "
          "(transformer_moe: data 1 x expert 2)", **report)
    return per_rank


def ep_train_run(d):
    """ep_train on one of the two ranks: moe_train's model (moe_config:
    fp32, 8 experts, top-1, einsum, dropout 0.1 in the experts too) at
    mesh_expert=2, each rank running its 4 experts, on the whole
    _full_width_batch (its last row all pad), against one process.
    Returns the errors, the expert all-reduces and this rank's bytes of
    parameters against the whole model's."""
    from zero_tpu_torch.parallel import distributed as dist

    cfg = moe_config(d)
    cfg.mesh_expert = 2
    feats = _full_width_batch()
    for v in feats.values():
        v[-1] = 0
    dist.take_stats()
    got = split_pass(cfg, feats)
    reduces = dist.take_stats()["expert_reduce"]
    held = sum(p.numel() for p in got[2].values())
    cfg.mesh_expert = 1
    with mock.patch.object(dist, "active", lambda: False):
        one = split_pass(cfg, feats)
    whole = sum(p.numel() for p in one[2].values())
    return dict(split_errors(got, one), expert_reduce=reduces,
                param_share=held / whole)


def ep_train_phase(ranks):
    """ep_train: the two expert ranks against one process, dp_reference's
    tolerances."""
    got = [r["ep_train"] for r in ranks]
    phase("ep_train", world=DP_WORLD, mesh="data 1 x expert 2",
          ranks=got)
    for rank, errs in enumerate(got):
        if not (errs["loss_rel_err"] <= 1e-6 and errs["grad_err"] <= 1e-5
                and errs["param_err"] <= 1e-5 and errs["split_leaves"]
                and errs["expert_reduce"]["calls"] > 0):
            raise AssertionError("ep_train rank %d: %s" % (rank, errs))


def tp_train_phase(ranks, one, cfg):
    """tp_train: the base config (BASE_CUT, both kernel flags, dropout
    0.1, update_cycle 4, the EMA on) at mesh_model=2 on the two gloo
    ranks through --mode train with the 8-sentence dev eval: dp_numbers'
    checks (steps, #1/#2/#11/#12 launches a rank as dp_train's, equal
    checksums and BLEU), each step's loss within TP_SAME of dp_train's
    world of one (the same batches and seeds), each rank's bytes at most
    TP_SHARE of the whole state's, the model line's all-reduces a step.
    Returns each rank's launches."""
    per = [r["tp_train"] for r in ranks]
    numbers = dp_numbers(per, cfg)
    share = {k: max(r["per_rank_bytes"][k] for r in per)
             / per[0]["whole_bytes"][k] for k in ("params", "moments", "ema")}
    diff = max(abs(a - b) / abs(b) for r in per
               for a, b in zip(r["losses"], one["losses"]))
    phase("tp_train", world=DP_WORLD, mesh="data 1 x model 2",
          backend="gloo", steps=DP_STEPS, note=DP_NOTE,
          per_rank_bytes=[r["per_rank_bytes"] for r in per],
          whole_bytes=per[0]["whole_bytes"], share_of_whole=share,
          model_reduce_per_step=[r["model_reduce_per_step"] for r in per],
          allreduce_calls=[r["allreduce_calls_per_step"] for r in per],
          world_of_one_losses=one["losses"], rel_diff_from_world_of_one=diff,
          **numbers)
    if not (len(set(map(tuple, numbers["checksums"]))) == 1
            and len(set(numbers["bleu"])) == 1
            and numbers["bleu"][0] is not None
            and all(v <= TP_SHARE for v in share.values())
            and diff <= TP_SAME
            and all(r["model_reduce_per_step"]["calls"] > 0 for r in per)):
        raise AssertionError(
            "tp_train: checksums %s, BLEU %s, shares %s, loss diff %g, "
            "model reduces %s" % (numbers["checksums"], numbers["bleu"],
                                  share, diff, [r["model_reduce_per_step"]
                                                for r in per]))
    return [r["train_launches"] for r in per]


# tensor parallelism of the multilingual config (tp_ml_train): 100
# languages at full width, both kernel flags, ROBT on, depth cut to
# BASE_CUT's 2+2
TP_ML_STEPS = 2
TP_ML_EXTRA = BASE_CUT + ",use_flash_attention=true,use_fused_ffn=true"
TP_ML_NOTE = ("the model computes in fp32 whatever default_dtype says (as "
              "the JAX package); ROBT's greedy decode runs on whole "
              "weights, gathered without gradient once a microbatch")


def tp_ml_run(d, out, extra):
    """--mode train of configs/multilingual_robt_opus100.json on the
    multilingual corpus in ``d`` at TP_ML_EXTRA, TP_ML_STEPS steps, no
    dev eval; ``extra`` adds the mesh and the process group. Returns its
    numbers, launch counts (#1/#2, #11/#12 and ROBT's #10), its bytes of
    parameters, moments and EMA beside the whole state's, and the model
    line's all-reduces and column gathers a step."""
    from zero_tpu_torch import run
    from zero_tpu_torch import train as train_mod
    from zero_tpu_torch.ops.kernels import decode_attention as da
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.parallel.mesh import per_rank_bytes, whole_size

    held = {}
    real = train_mod.init_train_state

    def keep(*args, **kwargs):
        state = held["state"] = real(*args, **kwargs)
        return state

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "src_train_file={0}/train.src,tgt_train_file={0}/train.tgt,"
            "output_dir={1},max_training_steps={2},disp_freq=1,save_freq=0,"
            "eval_freq=0,sample_freq=0,epoches=100".format(d, out,
                                                          TP_ML_STEPS)
            + TP_ML_EXTRA + extra)
    counters = (fa.launches, ff.launches, da.launches)
    for c in counters:
        c.clear()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_mod, "init_train_state", keep):
        summary = run.main(["--mode", "train", "--config", ML_CONFIG,
                            "--parameters", spec])
    torch.cuda.synchronize()
    state = held.pop("state")
    whole = whole_size(state.layout, state.params) * 4
    steps = max(summary["steps"], 1)
    reduce = summary["allreduce"]
    ends = summary["step_end_times"]
    return dict(
        steps=summary["steps"], losses=summary["losses"],
        shapes=summary["shapes"], tokens=summary["target_tokens"],
        step_s=[b - a for a, b in zip(ends[:-1], ends[1:])],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=collect(counters),
        per_rank_bytes={"params": per_rank_bytes(state.params),
                        "moments": per_rank_bytes(state.opt),
                        "ema": per_rank_bytes(state.ema)},
        whole_bytes={"params": whole, "moments": 2 * whole + 4,
                     "ema": whole if state.ema is not None else 0},
        per_step={kind: {k: reduce[kind][k] / steps
                         for k in ("calls", "bytes", "ms")}
                  for kind in ("model_reduce", "model_gather")},
        allreduce_per_step={k: reduce[k] / steps
                            for k in ("calls", "bytes", "ms")})


def tp_ml_train_phase(ranks, one):
    """tp_ml_train: the two model ranks (mesh data 1 x model 2) against
    the world of one on the same batches and seeds: steps, finite losses,
    each within TP_SAME of the world of one's, the launches
    ml_expected_launches counts on every rank (ROBT's encode and #10
    decode on whole weights, every layer's #1/#11 over the rank's heads
    and hidden columns), a rank's bytes at most TP_SHARE of the whole
    state's, the model line's all-reduces and column gathers (``lalt``)
    a step. Returns each rank's launches."""
    from zero_tpu_torch.config import load_config_file

    cfg = load_config_file(ML_CONFIG)
    cfg.update(overrides(TP_ML_EXTRA))
    per = [r["tp_ml_train"] for r in ranks]
    for label, r in [("world of one", one)] + [
            ("rank %d" % i, r) for i, r in enumerate(per)]:
        want = ml_expected_launches(cfg, r)
        if r["steps"] != TP_ML_STEPS or not all(map(math.isfinite,
                                                    r["losses"])) \
                or r["launches"] != want:
            raise AssertionError("tp_ml_train %s: steps %d, losses %s, "
                                 "launches %s, expected %s"
                                 % (label, r["steps"], r["losses"],
                                    r["launches"], want))
    diff = max(abs(a - b) / abs(b) for r in per
               for a, b in zip(r["losses"], one["losses"]))
    share = {k: max(r["per_rank_bytes"][k] for r in per)
             / per[0]["whole_bytes"][k] for k in ("params", "moments", "ema")}
    step_s = sorted(s for r in per for s in r["step_s"])
    timed = max(sum(r["step_s"]) for r in per)
    one_s = sorted(one["step_s"])
    phase("tp_ml_train", world=len(per), mesh="data 1 x model 2",
          backend="gloo", steps=TP_ML_STEPS, note=DP_NOTE + "; " + TP_ML_NOTE,
          languages=ML_LANGUAGES,
          stacked_shapes=[stacked_shape(s) for s in per[0]["shapes"]],
          ms_per_step_median=1e3 * step_s[len(step_s) // 2],
          target_tokens_per_s=sum(per[0]["tokens"][1:]) / timed,
          world_of_one_ms_per_step=1e3 * one_s[len(one_s) // 2],
          world_of_one_tokens_per_s=sum(one["tokens"][1:]) / sum(one_s),
          peak_gib=[r["peak_gib"] for r in per],
          world_of_one_peak_gib=one["peak_gib"],
          per_rank_bytes=[r["per_rank_bytes"] for r in per],
          whole_bytes=per[0]["whole_bytes"], share_of_whole=share,
          model_reduce_per_step=[r["per_step"]["model_reduce"] for r in per],
          model_gather_per_step=[r["per_step"]["model_gather"] for r in per],
          launches_per_rank=[r["launches"] for r in per],
          world_of_one_launches=one["launches"],
          losses=[r["losses"] for r in per],
          world_of_one_losses=one["losses"], rel_diff_from_world_of_one=diff)
    if not (diff <= TP_SAME and all(v <= TP_SHARE for v in share.values())
            and all(r["per_step"][k]["calls"] > 0 for r in per
                    for k in ("model_reduce", "model_gather"))):
        raise AssertionError("tp_ml_train: loss diff %g, shares %s, "
                             "collectives %s" % (diff, share,
                                                 [r["per_step"]
                                                  for r in per]))
    return [r["launches"] for r in per]


# ---------------------------------------------------------------------------
# sequence parallelism (mesh_seq; parallel/ring.py)
# ---------------------------------------------------------------------------

# ring kernel checks (long_kernels): (name, B, H, L, Dh, causal, padded),
# the padded case with an all-pad row; over SP_BLOCKS blocks in one
# process (ring.simulate)
SP_RING_CASES = (("ring_causal", 1, 4, 1024, 64, True, False),
                 ("ring_pad", 2, 4, 1024, 64, False, True))
SP_BLOCKS = (2, 4)
# #1/#2 over a query block and #11/#12 over a block's rows (long_kernels):
# B, H, L, Dh; the FFN's widths FFN_SHAPE[1:]
SP_BLOCK_CASE = (2, 4, 512, 64)
# sp_train: long_train's pairs cut to 2+2 layers and 2 microbatches a step
# (the script's time), mesh data 1 x seq 2, attention dropout 0 (a ring
# block draws its own masks), the others 0.1
SP_CUT = ",num_encoder_layer=2,num_decoder_layer=2,update_cycle=2"
SP_EXTRA = ",mesh_seq=2"
SP_PARAMS = ",use_fused_ffn=true,attention_dropout=0.0"
# each step's loss against the world of one, relative (bf16: the ring's
# blocks merge rounded outputs): on an H100 5.6e-6 at SP_CUT (6.3e-6 at
# 3+3); another block's dropout masks would move it by far more
SP_SAME = 5e-5
SP_MODELS = ("transformer", "transformer_rpr", "transformer_rela")


def ring_pass(ring, q, k, v, keep, do, n, causal, rate):
    """The ring over n blocks of q, k, v [B, H, L, Dh] in one process
    (ring.simulate), the kernel route: #5-#7 on CUDA tensors, their plain
    kernel-form version on CPU ones. Returns the output and dq, dk, dv,
    each joined along L."""
    lb = q.shape[2] // n

    def block(me, shift):
        sl = slice(me * lb, (me + 1) * lb)
        qb, kb, vb, tk, tv, o = ring.prepare(
            *(t[:, :, sl].contiguous() for t in (q, k, v)), keep,
            causal=causal, words=SEED_WORDS if rate else None, drop=rate,
            use_kernels=True, line=(me, n, shift))
        out, m, l = ring.ring_forward(qb, kb, vb, tk, tv, o)
        grads = ring.ring_backward(qb, kb, vb, tk, tv, out, m, l,
                                   do[:, :, sl].contiguous(), o)
        return out, grads[:3]

    res = ring.simulate(n, block)
    return (torch.cat([r[0] for r in res], dim=2),
            [torch.cat([r[1][i] for r in res], dim=2) for i in range(3)])


def ring_kernel_checks(sa, gen):
    """#5-#7 as ring blocks (parallel/ring.py's kernel route) over 2 and 4
    blocks, fp32 (CUDA cores) and bf16 (tensor cores), causal and padded
    (an all-pad row): at dropout 0.1 against the plain kernel-form ring
    with the same words, at 0 against the unsplit #5-#7 launch, forward
    and dq, dk, dv, at TOLERANCE; each block one #5, #6 and #7 (a causal
    ring skips the blocks above the diagonal). Returns {case: errors}."""
    from zero_tpu_torch.parallel import ring

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, h, L, dh, causal, padded in SP_RING_CASES:
            q, k, v, do = (torch.randn(b, h, L, dh, generator=gen).to(
                "cuda", dtype) for _ in range(4))
            keep = attention_pad(gen, b, L, padded).to("cuda")
            sfx = {"tensor_cores": "_tc", "cuda_cores": ""}[sa.route(
                "cuda", dtype, dh)]
            for n in SP_BLOCKS:
                blocks = n * (n + 1) // 2 if causal else n * n
                want = {key + sfx: blocks for key in (
                    "streaming_attention", "streaming_attention_dq",
                    "streaming_attention_dkdv")}
                for rate in (0.1, 0.0):
                    sa.launches.clear()
                    got, grads = ring_pass(ring, q, k, v, keep, do, n,
                                           causal, rate)
                    torch.cuda.synchronize()
                    launched = {k_: c for k_, c in sa.launches.items() if c}
                    if launched != want:
                        raise AssertionError("ring %s n=%d: launches %s, "
                                             "expected %s" % (name, n,
                                                              launched,
                                                              want))
                    if rate:
                        ref, refs = ring_pass(
                            ring, *(t.cpu() for t in (q, k, v, keep, do)),
                            n, causal, rate)
                        ref, refs = ref.cuda(), [g.cuda() for g in refs]
                    else:
                        leaves = [t.clone().requires_grad_()
                                  for t in (q, k, v)]
                        whole = sa.streaming_attention(*leaves, keep,
                                                       causal=causal)
                        refs = list(torch.autograd.grad(whole, leaves, do))
                        ref = whole.detach()
                    tag = "%s n=%d rate %s" % (name, n, rate)
                    out["%s %s" % (tag, str(dtype)[6:])] = [
                        check("ring " + tag + " " + part, x, y, dtype)
                        for part, x, y in zip(("out", "dq", "dk", "dv"),
                                              [got] + grads, [ref] + refs)]
    phase("long_kernels", ring_checks=out,
          against="rate 0.1: the plain kernel-form ring (same words); "
          "rate 0: the unsplit #5-#7 launch")
    return out


def seq_block_checks(gen):
    """#1/#2 and #3/#4 (RPR_MAX) over each half of the queries (qrows) and
    #11/#12 over each half of a sequence's rows (tokens), bf16, dropout
    0.1, against the matching slice of the whole launch: forward and dq
    (dx). A launch that dropped the block's offset would draw the first
    half's masks, and #3/#4 would index the first half's distances."""
    import types

    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff

    dtype, rate = torch.bfloat16, SPLIT_RATE
    b, h, L, dh = SP_BLOCK_CASE
    q, k, v, do = (torch.randn(b, h, L, dh, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    pad = attention_pad(gen, b, L, True).to("cuda")
    qq = q.clone().requires_grad_()
    whole = fa.fused_attention(qq, k, v, pad, dropout_rate=rate,
                               rng=SEED_WORDS)
    dq, = torch.autograd.grad(whole, qq, do)
    tables = types.SimpleNamespace(**{
        key: torch.randn(2 * RPR_MAX + 1, dh, generator=gen).mul(0.5).to(
            "cuda", dtype) for key in ("keys", "values")})
    rpr = dict(dropout_rate=rate, rng=SEED_WORDS, rpr_tables=tables,
               max_relative_position=RPR_MAX)
    qq = q.clone().requires_grad_()
    whole_rpr = fa.fused_attention(qq, k, v, pad, **rpr)
    dq_rpr, = torch.autograd.grad(whole_rpr, qq, do)
    _, d_in, f, d_out = FFN_SHAPE
    x = torch.randn(b, L, d_in, generator=gen).to("cuda", dtype)
    dy = torch.randn(b, L, d_out, generator=gen).to("cuda", dtype)
    w1, w2 = (torch.randn(m, n_, generator=gen).mul(0.05).to("cuda", dtype)
              for m, n_ in ((d_in, f), (f, d_out)))
    b1, b2 = (torch.randn(n_, generator=gen).mul(0.1).to("cuda", dtype)
              for n_ in (f, d_out))
    xx = x.clone().requires_grad_()
    y = ff.fused_ffn(xx, w1, b1, w2, b2, SEED_WORDS, rate)
    dx, = torch.autograd.grad(y, xx, dy)
    errs = {}
    lb = L // 2
    for lo in (0, lb):
        sl = slice(lo, lo + lb)
        qb = q[:, :, sl].contiguous().requires_grad_()
        ob = fa.fused_attention(qb, k, v, pad, dropout_rate=rate,
                                rng=SEED_WORDS, qrows=(lo, L))
        dqb, = torch.autograd.grad(ob, qb, do[:, :, sl].contiguous())
        qb = q[:, :, sl].contiguous().requires_grad_()
        ob_rpr = fa.fused_attention(qb, k, v, pad, qrows=(lo, L), **rpr)
        dqb_rpr, = torch.autograd.grad(ob_rpr, qb,
                                       do[:, :, sl].contiguous())
        xb = x[:, sl].contiguous().requires_grad_()
        yb = ff.fused_ffn(xb, w1, b1, w2, b2, SEED_WORDS, rate,
                          tokens=(lb, L, lo))
        dxb, = torch.autograd.grad(yb, xb, dy[:, sl].contiguous())
        errs["queries %d-%d" % (lo, lo + lb)] = [
            check("fused_attention qrows", ob, whole[:, :, sl], dtype),
            check("fused_attention_backward qrows dq", dqb, dq[:, :, sl],
                  dtype),
            check("fused_attention_rpr qrows", ob_rpr, whole_rpr[:, :, sl],
                  dtype),
            check("fused_attention_rpr_backward qrows dq", dqb_rpr,
                  dq_rpr[:, :, sl], dtype),
            check("fused_ffn tokens", yb, y[:, sl], dtype),
            check("fused_ffn_backward tokens dx", dxb, dx[:, sl], dtype)]
    phase("long_kernels", seq_block_checks=errs,
          note="against the whole launch's slice: 0.0 is bit-equal")
    return errs


def sp_train_run(d, out, extra):
    """--mode train of long_train's pairs (transformer-base at SP_CUT,
    bf16, both kernel flags, attention dropout 0, the others 0.1),
    LONG_STEPS steps; ``extra`` adds the mesh and the process group.
    Returns its numbers, launch counts and the seq line's collectives a
    step."""
    from zero_tpu_torch import run
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa

    spec = ("src_vocab_file={0}/vocab.txt,tgt_vocab_file={0}/vocab.txt,"
            "output_dir={1},".format(d, out) + LONG_PARAMS
            + ",src_train_file={0}/long_train.src,tgt_train_file={0}/"
            "long_train.tgt,lrate_strategy=vanilla,lrate=1e-3,"
            "max_training_steps={1},disp_freq=1,save_freq=0,eval_freq=0,"
            "sample_freq=0,epoches=100".format(d, LONG_STEPS)
            + SP_PARAMS + SP_CUT + extra)
    counters = (sa.launches, fa.launches, ff.launches)
    for c in counters:
        c.clear()
    torch.cuda.reset_peak_memory_stats()
    summary = run.main(["--mode", "train", "--config", CONFIG,
                        "--parameters", spec])
    torch.cuda.synchronize()
    steps = max(summary["steps"], 1)
    reduce = summary["allreduce"]
    ends = summary["step_end_times"]
    return dict(
        steps=summary["steps"], losses=summary["losses"],
        shapes=summary["shapes"], tokens=summary["target_tokens"],
        step_s=[b - a for a, b in zip(ends[:-1], ends[1:])],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=collect(counters),
        per_step={kind: {k: reduce[kind][k] / steps
                         for k in ("calls", "bytes", "ms")}
                  for kind in ("seq_ring", "seq_gather")},
        allreduce_per_step={k: reduce[k] / steps
                            for k in ("calls", "bytes", "ms")})


def sp_expected_launches(cfg, coord, n):
    """#5-#7 and #11/#12 a run of sp_train at seq coordinate ``coord`` of
    n (n = 1: the world of one): per microbatch an encoder self-attention
    takes n blocks, a decoder one coord + 1 (the causal skip), the cross
    attention one streaming launch (its memory is past 8192 keys), an FFN
    one launch; forward and backward."""
    microbatches = cfg["update_cycle"] * LONG_STEPS
    enc, dec = cfg["num_encoder_layer"], cfg["num_decoder_layer"]
    attn = enc * n + dec * (coord + 1) + dec if n > 1 else enc + 2 * dec
    want = {k: attn * microbatches for k in (
        "streaming_attention_tc", "streaming_attention_dq_tc",
        "streaming_attention_dkdv_tc")}
    want.update({k: (enc + dec) * microbatches
                 for k in ("fused_ffn", "fused_ffn_backward")})
    return want


def sp_train_phase(ranks, one):
    """sp_train: the two seq ranks (mesh data 1 x seq 2) against the world
    of one on the same pairs: steps, finite losses, each within SP_SAME of
    the world of one's, the launches sp_expected_launches counts, the
    ring's shifts and the encoder's gather a step. Returns each rank's
    launches."""
    from zero_tpu_torch.config import load_config_file

    cfg = load_config_file(CONFIG)
    cfg.update(overrides(SP_CUT))
    per = [r["sp_train"] for r in ranks]
    for coord, r in enumerate(per + [one]):
        n = 1 if r is one else len(per)
        want = sp_expected_launches(cfg, coord, n)
        if r["steps"] != LONG_STEPS or not all(map(math.isfinite,
                                                   r["losses"])) \
                or r["launches"] != want:
            raise AssertionError("sp_train %s: steps %d, losses %s, "
                                 "launches %s, expected %s"
                                 % ("world of one" if n == 1 else
                                    "rank %d" % coord, r["steps"],
                                    r["losses"], r["launches"], want))
    diff = max(abs(a - b) / abs(b) for r in per
               for a, b in zip(r["losses"], one["losses"]))
    step_s = sorted(s for r in per for s in r["step_s"])
    timed = max(sum(r["step_s"]) for r in per)
    one_s = sorted(one["step_s"])
    phase("sp_train", world=len(per), mesh="data 1 x seq 2", backend="gloo",
          steps=LONG_STEPS, note=DP_NOTE,
          stacked_lengths=[stacked_shape(s)[1:] for s in per[0]["shapes"]],
          ms_per_step_median=1e3 * step_s[len(step_s) // 2],
          target_tokens_per_s=sum(per[0]["tokens"][1:]) / timed,
          world_of_one_ms_per_step=1e3 * one_s[len(one_s) // 2],
          world_of_one_tokens_per_s=sum(one["tokens"][1:]) / sum(one_s),
          peak_gib=[r["peak_gib"] for r in per],
          world_of_one_peak_gib=one["peak_gib"],
          seq_ring_per_step=[r["per_step"]["seq_ring"] for r in per],
          seq_gather_per_step=[r["per_step"]["seq_gather"] for r in per],
          allreduce_per_step=[r["allreduce_per_step"] for r in per],
          launches_per_rank=[r["launches"] for r in per],
          losses=[r["losses"] for r in per],
          world_of_one_losses=one["losses"], rel_diff_from_world_of_one=diff)
    if not (diff <= SP_SAME
            and all(r["per_step"]["seq_ring"]["calls"] > 0
                    and r["per_step"]["seq_gather"]["calls"] > 0
                    for r in per)
            and max(r["peak_gib"] for r in per) < one["peak_gib"]):
        raise AssertionError("sp_train: loss diff %g, ring %s, gather %s, "
                             "peaks %s against %s"
                             % (diff, [r["per_step"] for r in per], per,
                                [r["peak_gib"] for r in per],
                                one["peak_gib"]))
    return [r["launches"] for r in per]


def _sp_batch():
    """_small_batch with its target padded to 10 positions: both lengths
    even, so the two seq ranks and one process index the same dropout
    elements."""
    feats = _small_batch()
    feats["target"] = torch.nn.functional.pad(feats["target"], (0, 1))
    return feats


def sp_reference_run():
    """sp_reference on one of the two ranks: the small fp32 transformer,
    transformer_rpr and transformer_rela (attention dropout 0, relu and
    residual dropout 0.1, both kernel flags: the CUDA-core #5-#7 as the
    softmax ring's blocks, #1/#2 (#3/#4 under RPR) on each rank's queries,
    #11/#12 on its rows) at mesh_seq=2 on _sp_batch, against one process (the group out
    of reach). Returns {model: errors and launches}."""
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.ops.kernels import fused_attention as fa
    from zero_tpu_torch.ops.kernels import fused_ffn as ff
    from zero_tpu_torch.ops.kernels import streaming_attention as sa
    from zero_tpu_torch.parallel import distributed as dist
    from zero_tpu_torch.parallel import ring
    from zero_tpu_torch.train_step import (global_batch, init_train_state,
                                           make_train_step)

    feats = {k: v.cuda() for k, v in _sp_batch().items()}
    rows = feats["source"].shape[0]
    out = {}
    for name in SP_MODELS:
        cfg = _small_model(0.1, name)
        cfg.attention_dropout = 0.0
        cfg.epsilon = 1e-6
        cfg.device = "cuda"
        runs = {}
        for seq in (2, 1):
            cfg.mesh_seq = seq
            counters = (sa.launches, fa.launches, ff.launches, ring.launches)
            for c in counters:
                c.clear()
            alone = (contextlib.nullcontext() if seq > 1 else
                     mock.patch.object(dist, "active", lambda: False))
            with alone:
                model = get_model(name)
                state = init_train_state(
                    model, cfg, torch.Generator().manual_seed(SEED), "cuda")
                params = list(state.params.parameters())
                with global_batch(rows):
                    loss = model.train_fn(
                        state.params, feats, cfg,
                        torch.Generator().manual_seed(SEED))["loss"]
                    grads = [g.contiguous() for g in
                             torch.autograd.grad(loss, params)]
                if seq > 1:
                    # each rank's gradient covers its block of the
                    # sequences
                    dist.all_reduce_sum_(grads, "seq")
                make_train_step(model, cfg)(
                    state, {k: v[None] for k, v in feats.items()}, 1e-3,
                    torch.Generator().manual_seed(SEED))
            runs[seq] = (loss.item(), grads,
                         [p.detach().clone() for p in params],
                         collect(counters))

        def err(a, b):
            scale = max(float(t.abs().max()) for t in b)
            return max(float((x - y).abs().max()) for x, y in zip(a, b)) \
                / scale

        (loss, grads, params, launches), (one_loss, one_grads, one_params,
                                          _) = runs[2], runs[1]
        out[name] = dict(loss=loss, one_process_loss=one_loss,
                         loss_rel_err=abs(loss - one_loss) / abs(one_loss),
                         grad_err=err(grads, one_grads),
                         param_err=err(params, one_params),
                         launches=launches)
    return out


def sp_reference_phase(ranks):
    """sp_reference: the two seq ranks against one process (loss 1e-6
    relative, grads and parameters 1e-5 of their max); the CUDA-core #5-#7
    (ring blocks), #1/#2 and #11/#12 launched on both ranks by the
    transformer, the plain ring by transformer_rpr and transformer_rela
    (whose FFN takes no kernel, as in the JAX package), and the CUDA-core
    #3/#4 by transformer_rpr's cross-attention on each rank's queries.
    Returns each rank's launches over the three models."""
    want = {"transformer": ("streaming_attention", "streaming_attention_dq",
                            "streaming_attention_dkdv", "fused_attention",
                            "fused_attention_backward", "fused_ffn",
                            "fused_ffn_backward"),
            "transformer_rpr": ("ring_block_ref", "fused_attention_rpr",
                                "fused_attention_rpr_backward"),
            "transformer_rela": ("ring_block_ref",)}
    report, per_rank = {}, []
    for rank, got in enumerate(r["sp_reference"] for r in ranks):
        total = collections.Counter()
        for name, errs in got.items():
            report["%s rank %d" % (name, rank)] = errs
            total.update(errs["launches"])
            ran = all(errs["launches"].get(k, 0) for k in want[name])
            if not (errs["loss_rel_err"] <= 1e-6 and errs["grad_err"] <= 1e-5
                    and errs["param_err"] <= 1e-5 and ran):
                raise AssertionError("sp_reference %s rank %d: %s"
                                     % (name, rank, errs))
        per_rank.append(dict(total))
    phase("sp_reference", world=DP_WORLD, mesh="data 1 x seq 2", **report)
    return per_rank


PHASES = ("device", "build", "kernels", "train_kernels", "serve",
          "reference", "train", "train_reference", "converge", "rpr_kernels",
          "rpr_train", "rpr_reference", "rela_train", "rela_reference",
          "aan_train", "aan_reference", "ensemble", "deep_train",
          "deep_memory", "l0drop_train", "fixup_train", "deep_reference",
          "long_kernels", "long_train", "long_reference", "scan_train",
          "moe_train", "multilingual_train", "clsr_train",
          "slice13_reference", "ib_train", "speech_train",
          "slice14_reference", "rnn_train", "deepnmt_train", "deepatt_train",
          "rnn_reference", "host", "dp_train", "dp_reference", "zero_train",
          "zero_reference", "moe_dp", "tp_train", "tp_reference",
          "tp_ml_train", "ep_train", "sp_train", "sp_reference")


def main(argv=None):
    parser = argparse.ArgumentParser("chip_smoke")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %s (device and "
                        "build always run; a subset prints no summary "
                        "lines)" % ",".join(PHASES))
    parser.add_argument("--package", metavar="DIR",
                        help="import zero_tpu_torch from DIR (a checkout of "
                        "another commit) instead of this checkout, to time "
                        "its decode kernels on the same inputs; phases "
                        "build, kernels and long_kernels (#9 only) only")
    parser.add_argument("--dp-worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.dp_worker:
        return dp_worker(args.dp_worker)
    todo = set(args.phases.split(","))
    unknown = todo - set(PHASES)
    if unknown:
        parser.error("unknown phases %s" % sorted(unknown))
    if args.package and todo - {"device", "build", "kernels", "long_kernels"}:
        parser.error("--package takes the phases build, kernels and "
                     "long_kernels only")
    if "ensemble" in todo and not {"train", "rela_train"} <= todo:
        parser.error("ensemble decodes the checkpoints of the phases train "
                     "and rela_train: give them too")
    if "clsr_train" in todo and "multilingual_train" not in todo:
        parser.error("clsr_train's ensemble decodes multilingual_train's "
                     "checkpoint: give it too")
    if "zero_train" in todo and "dp_train" not in todo:
        parser.error("zero_train holds its stages to dp_train's two ranks: "
                     "give it too")
    if "tp_train" in todo and "dp_train" not in todo:
        parser.error("tp_train holds its losses to dp_train's world of one: "
                     "give it too")
    if todo & {"deepnmt_train", "host"} and "rnn_train" not in todo:
        parser.error("deepnmt_train's ensemble and host's metrics read "
                     "rnn_train's checkpoint and output: give it too")
    full = todo == set(PHASES)
    began = time.time()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    from zero_tpu_torch.ops.kernels import cuda_build
    from zero_tpu_torch.ops.kernels import decode_attention as da

    # device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    phase("device", name=kind, nvidia_smi=smi, torch=torch.__version__,
          package=os.path.dirname(os.path.dirname(cuda_build.CSRC)),
          cuda=torch.version.cuda, count=torch.cuda.device_count(),
          matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_tf32=torch.backends.cudnn.allow_tf32)

    # build: one nvcc per source, all at once
    sources = cuda_build.SOURCES
    t0 = time.time()
    libs = cuda_build.build(*sources)
    for name in sources:
        cuda_build.load(name)
    # the bf16 FFN kernels (#11/#12), the bf16 streaming kernels (#5-#7),
    # the bf16 fused attention (#1/#2) and the bf16 RPR kernels (#3/#4) run
    # on the tensor cores: wgmma (HGMMA) in their libraries' SASS (another
    # checkout's, under --package, may predate them)
    sass = {n: tensor_core_sass(libs[n])
            for n in ("fused_ffn", "streaming_attention", "fused_attention",
                      "fused_attention_rpr")}
    for n, counts in sass.items():
        if counts is not None and not counts["HGMMA"] and not args.package:
            raise AssertionError("%s: no wgmma (HGMMA) in the SASS: %s"
                                 % (n, counts))
    # the tensor-core RPR forward (#3: forward_tc under the Rpr policy)
    rpr_fwd_tc = [line for line in cuda_build.ptxas_report(
        "fused_attention_rpr") if "forward_tc" in line and "Rpr" in line]
    phase("build", seconds=time.time() - t0,
          libraries=[os.path.relpath(libs[n], REPO) for n in sources],
          ptxas={n: cuda_build.ptxas_report(n) for n in sources},
          ptxas_spills={n: cuda_build.ptxas_spills(n) for n in sources},
          rpr_forward_tc_ptxas=rpr_fwd_tc,
          rpr_forward_tc_spills={
              k: v for k, v in cuda_build.ptxas_spills(
                  "fused_attention_rpr").items()
              if "forward_tc" in k and "Rpr" in k},
          fused_ffn_tensor_core_sass=sass["fused_ffn"],
          streaming_tensor_core_sass=sass["streaming_attention"],
          fused_attention_tensor_core_sass=sass["fused_attention"],
          fused_attention_rpr_tensor_core_sass=sass["fused_attention_rpr"])

    rows, train_rows, rpr_rows, long_rows, launches = {}, {}, {}, {}, {}
    if "kernels" in todo:
        rows = kernels_phase(da)
    if "train_kernels" in todo:
        train_rows = train_kernels_phase()
    if "rpr_kernels" in todo:
        rpr_rows = rpr_kernels_phase()
    if "long_kernels" in todo:
        long_rows = long_kernels_phase(da, streaming=not args.package)

    from zero_tpu_torch.config import default_config, load_config_file
    from zero_tpu_torch.models import get_model
    from zero_tpu_torch.saver import Saver
    from zero_tpu_torch.vocab import Vocab

    with tempfile.TemporaryDirectory() as d:
        words = write_corpus(d)
        ml_dir = os.path.join(d, "multilingual")
        if todo & {"multilingual_train", "clsr_train", "tp_ml_train"}:
            write_multilingual_corpus(ml_dir, words)
        if "serve" in todo:
            # serve transformer-base with random weights
            cfg = default_config().override_from_dict(
                load_config_file(CONFIG))
            cfg.src_vocab = cfg.tgt_vocab = Vocab(os.path.join(d,
                                                               "vocab.txt"))
            weights = get_model("transformer").init_fn(
                torch.Generator().manual_seed(SEED), cfg)
            Saver(output_dir=os.path.join(d, "model")).save(
                {"params": weights}, step=0)
            del weights
            launches["decode_pool_attention"] = serve_phase(
                da, d, 4, "decode_pool_attention")
            launches["decode_attention"] = serve_phase(
                da, d, 1, "decode_attention")
        if "reference" in todo:
            reference_phase(da)
        if todo & {"train", "rpr_train", "rela_train", "aan_train",
                   "deep_train", "deep_memory", "l0drop_train",
                   "fixup_train", "scan_train", "moe_train", "ib_train",
                   "rnn_train", "deepatt_train", "dp_train", "zero_train"}:
            write_train_corpus(d, words)
        if "train" in todo:
            launches.update(train_phase(d, da, extra=BASE_CUT)[0]
                            ["launches"])
        if "sp_train" in todo:
            # the world of one of sp_train, before the two ranks take the
            # card
            write_long_corpus(d, words)
            sp_one = sp_train_run(d, os.path.join(d, "sp_one"), "")
        if "tp_ml_train" in todo:
            # the world of one of tp_ml_train, before the two ranks take
            # the card
            tp_ml_one = tp_ml_run(ml_dir, os.path.join(d, "tp_ml_one"), "")
        if todo & DP_PHASES:
            dp_launches, dp_rank_launches, ranks, dp_one = dp_train_phase(
                d, todo)
            if "dp_reference" in todo:
                dp_reference_phase([r["reference"] for r in ranks])
            zero_cfg = load_config_file(CONFIG)
            zero_cfg.update(overrides(BASE_CUT))
            if "zero_train" in todo:
                from zero_tpu_torch.ops.kernels import fused_attention as fa
                from zero_tpu_torch.ops.kernels import fused_ffn as ff

                zero_launches = zero_train_phase(
                    d, ranks, [r for r in ranks if "train" in r], zero_cfg,
                    (fa.launches, ff.launches, da.launches))
            if "zero_reference" in todo:
                zero_reference_phase(ranks)
            if "moe_dp" in todo:
                moe_dp_phase(ranks)
            if "tp_train" in todo:
                tp_launches = tp_train_phase(ranks, dp_one, zero_cfg)
            if "tp_reference" in todo:
                tp_reference_launches = tp_reference_phase(ranks)
            if "tp_ml_train" in todo:
                tp_ml_launches = tp_ml_train_phase(ranks, tp_ml_one)
            if "ep_train" in todo:
                ep_train_phase(ranks)
            if "sp_train" in todo:
                sp_launches = sp_train_phase(ranks, sp_one)
            if "sp_reference" in todo:
                sp_reference_launches = sp_reference_phase(ranks)
        if "rpr_train" in todo:
            launches.update(train_phase(d, da, RPR_CONFIG, "rpr_train",
                                        rpr_expected_launches, BASE_CUT,
                                        serving=rpr_serving)[0]["launches"])
        if "rela_train" in todo:
            rela_launches = rela_train_phase(d, da)
        if "aan_train" in todo:
            aan_launches = train_phase(d, da, AAN_CONFIG, "aan_train",
                                       encoder_expected_launches, BASE_CUT,
                                       serving=encoder_serving)[0]["launches"]
        if "ensemble" in todo:
            ensemble_launches = ensemble_phase(d, da)
        if "deep_train" in todo:
            deep_launches = deep_train_phase(d, da)["launches"]
        if "deep_memory" in todo:
            deep_memory_phase(d, da)
        if "l0drop_train" in todo:
            l0drop_results, l0drop_served4, l0drop_served1 = \
                l0drop_train_phase(d, da)
            l0drop_launches = l0drop_results["launches"]
        if "fixup_train" in todo:
            fixup_served = fixup_train_phase(d, da)
        if "scan_train" in todo:
            scan_results, scan_served4, scan_served1, scan_restore = \
                scan_train_phase(d, da)
        try:
            if "moe_train" in todo:
                moe_results, moe_served = moe_train_phase(d, da)
        finally:
            if "scan_train" in todo:
                scan_restore()
        if "multilingual_train" in todo:
            ml_results, ml_served, _ = multilingual_train_phase(ml_dir, da)
        if "clsr_train" in todo:
            clsr_results, clsr_served, clsr_ensemble = clsr_train_phase(
                ml_dir, da)
        if "ib_train" in todo:
            ib_results, ib_served4, ib_served1 = ib_train_phase(d, da)
        if "speech_train" in todo:
            speech_dir = os.path.join(d, "speech")
            write_speech_corpus(speech_dir, words)
            speech_results, speech_served4, speech_served1, \
                speech_ensemble = speech_train_phase(speech_dir, da)
        rnn_results = {}
        for label in ("rnn_train", "deepnmt_train", "deepatt_train"):
            if label in todo:
                rnn_results[label] = rnn_train_phase(d, da, label)
            if label == "deepnmt_train" and label in todo:
                rnn_ensemble(d, da)
        if "host" in todo:
            host_phase(d)
        if "long_train" in todo:
            write_long_corpus(d, words)
            launches.update(long_train_phase(d, da))
    if "train_reference" in todo:
        train_reference_phase()
    if "rpr_reference" in todo:
        rpr_reference_phase(da)
    if "rela_reference" in todo:
        rela_reference_phase(da)
    if "aan_reference" in todo:
        aan_reference_phase(da)
    if "deep_reference" in todo:
        deep_reference_phase(da)
    if "long_reference" in todo:
        long_reference_phase(da)
    if "slice13_reference" in todo:
        slice13_reference_phase(da)
    if "slice14_reference" in todo:
        slice14_reference_phase(da)
    if "rnn_reference" in todo:
        rnn_reference_phase(da)
    if "converge" in todo:
        with tempfile.TemporaryDirectory() as d:
            converge_phase(d)
    if not full:
        return 0

    kernels = []
    decode_src = "zero_tpu_torch/csrc/decode_attention.cu"
    # decode: bf16 at the serve phase's shapes (one split), and beside them
    # long_train's serving shape at a full 8192-position cache (split)
    for name, line in (("decode_pool_attention", 288),
                       ("decode_attention", 366)):
        r = rows[(name, torch.bfloat16)]
        lr = rows[(name, "long")]
        kernels.append(dict(
            name=name, route="cuda", source=decode_src,
            replaces="zero_tpu/ops/kernels/decode_attention.py:%d" % line,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            splits=r["splits"],
            long={"case": "B%d_T%d" % (LONG_DECODE_B, LONG_DECODE_T),
                  **{k: lr[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "library_ms", "bound_ms",
                                        "splits")}}))
    # #8's relu mode: ReLA's beam-4 serving and the ensemble's ReLA model
    # launch it (serving's shape, bf16; no library call takes relu weights)
    r = rows[("decode_pool_attention[relu]", torch.bfloat16)]
    kernels[0]["relu"] = dict(
        launches=rela_launches["decode_pool_attention_relu"],
        ensemble_launches=ensemble_launches["decode_pool_attention_relu"],
        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "splits")})
    kernels[0]["ensemble_launches"] = ensemble_launches[
        "decode_pool_attention"]
    # this slice's serving: transformer_l0drop at beam 4 (#8) and 1 (#10),
    # transformer_fixup at beam 4 (#8)
    kernels[0]["l0drop_serve_launches"] = l0drop_served4[
        "decode_pool_attention"]
    kernels[0]["fixup_serve_launches"] = fixup_served["decode_pool_attention"]
    kernels[1]["l0drop_serve_launches"] = l0drop_served1["decode_attention"]
    # scan_layers' serving (l0drop, stacked) at beam 4 (#8) and 1 (#10);
    # transformer_moe, transformer_multilingual and transformer_clsr decode
    # through #10 at beam 4 (rows folded), the ensemble of the last two
    # too, and ROBT's greedy decode in every multilingual training step
    kernels[0]["scan_serve_launches"] = scan_served4["decode_pool_attention"]
    kernels[1].update(
        scan_serve_launches=scan_served1["decode_attention"],
        moe_serve_launches=moe_served["decode_attention"],
        multilingual_serve_launches=ml_served["decode_attention"],
        clsr_serve_launches=clsr_served["decode_attention"],
        multilingual_clsr_ensemble_launches=clsr_ensemble[
            "decode_attention"],
        multilingual_robt_train_launches=ml_results["launches"][
            "decode_attention"],
        # ROBT's greedy decode on whole weights on each of the two model
        # ranks (tp_ml_train)
        tp_ml_train_rank_launches=[r["decode_attention"]
                                   for r in tp_ml_launches],
        # transformer_afs serves through #10 at beam 4 (rows folded over
        # the classic cache) and beam 1, and in its ensemble with itself;
        # transformer_ibdecoder's pair step takes no decode kernel
        speech_serve_launches=speech_served4["decode_attention"],
        speech_serve_beam1_launches=speech_served1["decode_attention"],
        speech_ensemble_launches=speech_ensemble["decode_attention"],
        ib_serve_launches=ib_served4.get("decode_attention", 0)
        + ib_served1.get("decode_attention", 0))
    # training kernels: bf16 at rate 0.1, as the train phase runs them;
    # attention at the encoder self-attention case, the FFN at N=4096 and
    # at the train phase's largest stacked shape; the library yardstick is
    # timed with dropout off
    for name, source, replaces, key in (
            ("fused_attention_tc", "fused_attention.cu",
             "fused_attention.py:488", ("self_pad",)),
            ("fused_attention_backward_tc", "fused_attention.cu",
             "fused_attention.py:525", ("self_pad",)),
            ("fused_ffn", "fused_ffn.cu", "fused_ffn.py:186", (FFN_SHAPE[0],)),
            ("fused_ffn_backward", "fused_ffn.cu", "fused_ffn.py:214",
             (FFN_SHAPE[0],)),
            ("fused_ffn", "fused_ffn.cu", "fused_ffn.py:186", (FFN_LARGE[0],)),
            ("fused_ffn_backward", "fused_ffn.cu", "fused_ffn.py:214",
             (FFN_LARGE[0],))):
        # #1's and #2's rows are keyed by kernel, their JSON rows by their
        # launch keys
        kernel = name[:-3] if name.endswith("_tc") else name
        r = train_rows[(kernel,) + key + (torch.bfloat16, 0.1)]
        lib = train_rows[(kernel,) + key + (torch.bfloat16, 0.0)][
            "library_ms"]
        row = dict(
            name=name, route="cuda", source="zero_tpu_torch/csrc/" + source,
            replaces="zero_tpu/ops/kernels/" + replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=lib)
        if name.startswith("fused_ffn"):
            row["case"] = "N%d_%d_%d_%d" % ((key[0],) + FFN_SHAPE[1:])
        # transformer_aan's encoder runs the same kernels (aan_train), and
        # so do the deep config's models (deep_train: transformer_fuse's
        # encoder; l0drop_train: every layer; both under use_remat)
        row["aan_train_launches"] = aan_launches[name]
        row["deep_train_launches"] = deep_launches[name]
        row["l0drop_train_launches"] = l0drop_launches[name]
        # scan_layers (l0drop, stacked) runs this route; the multilingual
        # encoder (fp32) the CUDA-core route of #1/#2, under the counter
        # without the suffix; MoE and CLSR train with no kernel
        row["scan_train_launches"] = scan_results["launches"][name]
        row["multilingual_train_launches"] = ml_results["launches"][kernel]
        row["moe_train_launches"] = moe_results["launches"].get(name, 0)
        row["clsr_train_launches"] = clsr_results["launches"].get(name, 0)
        # transformer_ibdecoder: its bf16 encoder on this route, its fp32
        # decoder on the CUDA-core route (the counter without the suffix);
        # transformer_afs (the config's fused FFN off) on this route
        row["ib_train_launches"] = ib_results["launches"][name]
        if name != kernel:
            row["ib_train_cuda_core_launches"] = ib_results["launches"][
                kernel]
        row["speech_train_launches"] = speech_results["launches"].get(name,
                                                                      0)
        # data parallelism: the world of one over NCCL, and each of the two
        # gloo ranks on the card (dp_train)
        row["dp_train_launches"] = dp_launches[kernel]
        row["dp_train_rank_launches"] = [r[kernel] for r in dp_rank_launches]
        # ZeRO stages 1-3 on the two gloo ranks (zero_train)
        row["zero_train_rank_launches"] = {
            "stage%d" % stage: [r[kernel] for r in per]
            for stage, per in zero_launches.items()}
        # tensor parallelism at mesh_model=2 on the two gloo ranks, each
        # over its heads and hidden slice (tp_train), and the CUDA-core
        # route of the small fp32 models (tp_reference)
        row["tp_train_rank_launches"] = [r[kernel] for r in tp_launches]
        row["tp_reference_rank_launches"] = [
            r.get(kernel, 0) for r in tp_reference_launches]
        # the multilingual config (fp32: the CUDA-core route) at
        # mesh_model=2 on the two gloo ranks, ROBT's encode on whole
        # weights (tp_ml_train)
        row["tp_ml_train_rank_launches"] = [r.get(kernel, 0)
                                            for r in tp_ml_launches]
        # sequence parallelism at mesh_seq=2 on the two gloo ranks: each
        # rank's block of the long pairs (sp_train: the cross attention
        # streams there, so #1/#2 take none) and the CUDA-core route of
        # the small fp32 models (sp_reference: #1/#2 over a rank's
        # queries, #11/#12 over its rows)
        row["sp_train_rank_launches"] = [r.get(name, 0)
                                         for r in sp_launches]
        row["sp_reference_rank_launches"] = [
            r.get(kernel, 0) for r in sp_reference_launches]
        if "parent_ms" in r:
            row.update(tensor_cores=True, parent_ms=r["parent_ms"])
        kernels.append(row)
    # RPR kernels: bf16 at rate 0.1, encoder self-attention at m 16; the
    # library column is SDPA WITHOUT relative positions (a floor, not the
    # same function), composite_ms the use_flash_attention=false path. #3
    # and #4 are the tensor-core kernels, parent_ms the CUDA-core ones on
    # the same inputs in this run
    for name, line in (("fused_attention_rpr_tc", 580),
                       ("fused_attention_rpr_backward_tc", 624)):
        kernel = name[:-3] if name.endswith("_tc") else name
        r = rpr_rows[(kernel, "self_pad", torch.bfloat16, 0.1)]
        r0 = rpr_rows[(kernel, "self_pad", torch.bfloat16, 0.0)]
        row = dict(
            name=name, route="cuda",
            source="zero_tpu_torch/csrc/fused_attention_rpr.cu",
            replaces="zero_tpu/ops/kernels/fused_attention.py:%d" % line,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r0["library_ms"],
            library="scaled_dot_product_attention without RPR (floor)",
            composite_ms=r0["composite_ms"])
        if "parent_ms" in r:
            row.update(tensor_cores=True, parent_ms=r["parent_ms"])
        # transformer_rpr at mesh_model=2 on the two gloo ranks, CUDA-core
        # route (tp_reference)
        row["tp_reference_rank_launches"] = [
            r.get(kernel, 0) for r in tp_reference_launches]
        # transformer_rpr's cross-attention over each of the two seq
        # ranks' queries, CUDA-core route (sp_reference)
        row["sp_reference_rank_launches"] = [
            r_.get(kernel, 0) for r_ in sp_reference_launches]
        kernels.append(row)
    # streaming kernels: bf16 at rate 0.1 on the encoder-like case (pad
    # mask, an all-pad row), as long_train runs them; SDPA with dropout off.
    # #5-#7 are the tensor-core kernels, parent_ms the CUDA-core ones that
    # ran before them, on the same inputs in this run
    for name, line in (("streaming_attention_tc", 308),
                       ("streaming_attention_dq_tc", 353),
                       ("streaming_attention_dkdv_tc", 371)):
        r = long_rows[(name, "pad_8320", 0.1)]
        row = dict(
            name=name, route="cuda",
            source="zero_tpu_torch/csrc/streaming_attention.cu",
            replaces="zero_tpu/ops/kernels/streaming_attention.py:%d" % line,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            library_ms=long_rows[(name, "pad_8320", 0.0)]["library_ms"],
            tensor_cores=True, parent_ms=r["parent_ms"])
        # sequence parallelism: every softmax ring block of sp_train (and
        # its cross attention past 8192 keys) a rank, and the CUDA-core
        # ring blocks of sp_reference
        row["sp_train_rank_launches"] = [r_.get(name, 0)
                                         for r_ in sp_launches]
        row["sp_reference_rank_launches"] = [
            r_.get(name[:-3], 0) for r_ in sp_reference_launches]
        kernels.append(row)
    # the cross-attention decode kernel stays unwired, as in the JAX
    # package: no launch on the main path; long-memory shape, bf16
    r = long_rows[("decode_cross_attention", CROSS_CASES[-1][2])]
    kernels.append(dict(
        name="decode_cross_attention", route="cuda", source=decode_src,
        replaces="zero_tpu/ops/kernels/decode_attention.py:329",
        launches=launches.get("decode_cross_attention", 0),
        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=r["library_ms"], composite_ms=r["composite_ms"],
        splits=r["splits"], wired=False))
    # this slice's RNN models launch none of #1-#12 in training, serving
    # and scoring (the phases fail on any launch)
    for row in kernels:
        row["rnn_launches"] = sum(
            r["launches"].get(row["name"], 0)
            + r["served_beam4"].get(row["name"], 0)
            for r in rnn_results.values())
    print(json.dumps({"kernels": kernels}))
    phase("total", seconds=time.time() - began)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
