#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --near-tie-readings`` builds the kernels and
prints only the readings phase 19's NEAR_TIE bound is set from:
near_tie_readings. ``--full-depth`` runs the model slices that
SLICE_LAYERS cuts at their published depths, past the time limit.)

Phases (any failure exits non-zero; nothing is caught and turned into a
pass):
1. build the CUDA kernels from tpullm_torch/csrc (build seconds, registers
   and spills from ptxas);
2. hold each kernel against its plain PyTorch version at Llama-3-8B Q4_K
   shapes (and Q6_K for the matmuls; B also on wqkv at the server's
   512-row prefill chunk), and kernels A, B and F at the
   Mixtral-8x7B path's own shapes (an expert indexed out of its (L, E)
   stack as the path does, the 32000-row lm_head, F on layer 1 of a
   stack), kernel C at the engine's prefill shape and at the server's
   last chunk of its 6000-token prompt (query slots 5632-6143 over an
   8192-slot view), kernel D at the 8B layer (M = 4, plain and folded;
   its yardstick is the same layer through the port's unfused path), and
   time kernel, plain version, one PyTorch library call as a yardstick,
   and the roofline bound; check the matmul kernels (A, B and
   F) for every K-major type at one shape; kernel E (decode attention) at
   the server slice's decode shape on bf16 and int8 K/V and at the engine
   slice's on bf16 (timed beside SDPA and the einsum path the model takes
   with E off), and its flag cases (T = 1, 4 and 8, windows, softcap,
   sinks, a row with no visible key) at head dims 128 and 256; the KV
   store kernel (one launch a layer for every cache write of forward) at
   the server's decode step and a 512-row prefill chunk on its int8
   cache, and at the 8B and Mixtral engines' decode step and 4x512
   prefill on their bf16 cache (there beside one ``index_put_`` a bank),
   bit for bit against its plain version; A and B at Qwen3-8B's new
   weights (gate/up N 24576, down K 12288, the 151936-row lm_head over
   152064 padded rows) and at Qwen2.5-7B's widths (K 3584 and 18944), D at
   Qwen3-8B's layer, C and E at Qwen2.5-7B's heads (a GQA group of 7);
3. full-width 8B with 2 layers: one 128-token prefill + 2 greedy decode
   steps through the kernels, against the plain path on a CPU copy in f32
   (tolerance: 4x the error of the same plain path in bf16); then the
   server layout on an int8 cache (per-slot prefills through slot0, 2
   decode steps at per-row depths through kernel E) with the same rule
   (every parity run: PARITY_STEPS decode steps, cut from 4, then 2);
4. the slice: the 32-layer 8B model answers 4 requests (prompts of 512,
   300, 200 and 100 tokens, 32 greedy decode steps) through
   InferenceEngine.generate, each decode step a replay of the engine's
   CUDA graph, with every kernel's launch count above 0 (a replay adds the
   counts of its capture); one eager pass of the same requests
   (cuda_graphs=False) must give the same tokens and launch counts; then
   the server slice on the same model: ServerContext (4 slots of 8192,
   int8 KV, kernel E through TPULLM_FLASH_DECODE=1, each decode step a
   replay of the server's CUDA graph, a byte-level BPE tokenizer at
   Llama-3's layout from utils/synth.py:synth_bpe_vocab) behind the HTTP
   front end answers a burst of 6 concurrent token-id requests (prompts of
   6000 to 40 tokens, 64 new tokens each, one streamed, one sampled) and a
   sequential pair that must reuse its prefix, with A-E and the store
   kernel launched; the burst again with kernel E off (the einsum path);
   the text and chat part with E on: /tokenize of a ~6000-token text
   (host ms) against the in-process encode, /detokenize back,
   /apply-template, and a burst of 4 concurrent chat completions
   (streamed, with tools, with a stop string, with <|eot_id|> forced),
   each prompt's length and text checked against the tokenizer and A-E
   launched; a profile of the 6000-token
   prompt's prefill alone (device ms by kernel), and each way one decode
   chunk as graph replays against the same chunk as eager steps (same
   tokens and launch counts) and the chunk profile as graph replays (one
   cudaGraphLaunch a step) and as eager steps;
5. where a decode step's time goes, on the slice's model and batch, as
   graph replays and as eager steps: the spread of ms/step over single
   steps, the CPU share of the main thread, of the process and of its
   busiest threads, a fixed host-only workload timed before and after, the
   CPUs' busy and steal shares, ms per step back to back between CUDA
   events, the device-busy time, kernels and runtime launch calls per step
   under torch.profiler, and peak memory with the graph pool; then one
   profiled prefill: each kernel's device time, the device time outside
   the kernels and the device's idle share;
6. the 8B model is freed; full-width Mixtral-8x7B with 1 layer: one
   128-token prefill (ragged MoE through kernel F) + 1 greedy decode step
   (the selected experts through kernel A's expert-skip variant) against
   the plain path on a CPU copy in f32, with phase 3's tolerance rule,
   counting the (token, layer) routings that differ between the card and
   the CPU;
7. the MoE slice: the 32-layer Mixtral-8x7B model answers phase 4's 4
   requests through InferenceEngine.generate (graph replays; each rate the
   median of 3 samples), with kernels A, B, C, F and A's skip variant
   launched and D not, and once eagerly with the same tokens and launch
   counts;
8. phase 5's decode-step (graph replays; the eager one left out for the
   script's time limit) and prefill profiles on the MoE slice (the
   prefill's device time outside the kernels is the routing's cost);
9. the dense decoder's flags at full width: Qwen3-8B with 2 layers (per-head
   QK norms, untied 151936-row lm_head) against the CPU as phase 3; a
   2-layer run at Qwen2.5-7B's width (q/k/v biases, G = 7, depth cut from
   28; kernel E in its decode steps, kernel D never) the same way; the
   36-layer Qwen3-8B model answers phase 4's 4 requests (graph replays,
   then eagerly: the same tokens and launch counts, A-D and the store
   launched); then its server (4 slots of 4096, int8 KV, kernel E, a
   byte-level BPE tokenizer at Qwen2's layout with ChatML) answers a burst
   of 4 token-id completions and 2 chat completions, one of them stopped
   at <|im_end|>, with A-E and the store launched;
10. the Qwen MoE archs at full width: Qwen3-30B-A3B (qwen3moe: 128
   experts of 768, top-8, q 4096 wide over a 2048-wide stream, Q6_K down
   experts) and Qwen2-57B-A14B's widths (qwen2moe: 64 experts of 2560 and
   a shared expert of 20480 with its sigmoid gate, biases), each with 1
   layer against the CPU as phase 6; then the 48-layer Qwen3-30B-A3B
   model: kernel rows on its own weights (A's expert-skip variant at M = 1
   and 4, bit for bit against A called on each listed expert and timed
   beside A over all 128 experts; F at 128 experts on a 4x512 prefill,
   with its padding share; C and E at a GQA group of 8), the slice and its
   decode (3 skip launches a layer a step, whatever E is) and prefill
   profiles, and its server (4 slots of 4096, int8 KV, kernel E, a
   Qwen2-layout tokenizer): 4 token-id completions and 2 chats, one
   stopped at <|im_end|>, with A-C, E, F, the store and the skip launched;
11. the gemma family at full width (head dim 256, gelu, the embedding
   scale, softcaps, windows, tied lm_heads): Gemma-7B's width with 2
   layers (kernel D with gelu) against the CPU as phase 3 (Gemma-2-9B's
   and Gemma-3-4B's run in phase 12); kernel rows at Gemma-2-9B's weights and heads (C at head dim 256
   with softcap 50 and windows of 0, 256 and 4096; E with window and
   softcap; the store) and D at Gemma-7B's layer; then the 42-layer
   Gemma-2-9B model: the slice with E on (every prefill attention call
   routed to C, none to the einsum path; A, B, C, E and the store
   launched, D not) and its decode profile, and its server (4 slots of
   8192, int8 KV, full-context KV on every layer as --swa-full gives it,
   E on): 4 token-id completions of 6000/2000/700/40 tokens, the 6000 past
   the 4096 window, and a decode chunk, graph against eager and profiled
   as graph replays;
12. the iSWA ring (the server CLI's default for bf16 and f32 KV: the SWA
   layers on a ring of window + prefill_chunk slots): ring rows at
   Gemma-2-9B's heads (the store with wrap, a 512-row chunk across the end
   of a 4608-slot ring, bit for bit beside one index_put_ a bank; E over
   the ring at rows 12000/6000/2000/40 and C over it for a 512-row chunk at
   11488, window 4096, softcap 50, beside flex_attention with the ring
   mask; C's ring at head dim 128 beside SDPA); Gemma-2-9B with 2 layers
   and Gemma-3-4B's width with 6 (5 SWA layers at their own rope base
   under linear scaling 8), the window cut to 256 and prefill_chunk 128 (a
   384-slot ring), prompts of 896 and 500 tokens, the ring engine's path
   and the card's full cache each against the CPU f32 path (phase 3's
   rule) and against each other, every ring-layer call on C or E, E in the
   decode steps of both; then phase 11's 42-layer
   Gemma-2-9B behind serve() on ServerContext(iswa=True): 4 slots of
   16384, bf16 KV, prefill_chunk 512, E on, the dual cache's KV bytes
   beside the full cache's, token-id completions of 12000/6000/2000/40
   tokens and a follow-up that reuses the 12000-token prefix, every
   request 200 and no ring-layer call on the einsum path, peak memory,
   then a decode chunk at those depths, graph against eager and profiled
   as graph replays;
13. the layernorm, bias and parallel-residual decoders at full width, the
   Gemma weights freed first: Command-R 35B (layernorm without bias, the
   parallel block off the attention's norm, 64/64 heads of 128, logit
   scale 0.0625, a tied 256000-row lm_head) and StarCoder2-15B's width
   (layernorm, q/k/v, output and FFN biases, the ungated gelu FFN), each
   with 1 layer against the CPU as phase 3, D never launched; kernel rows
   at Command-R's shapes (A and B on its five weights, C and E at a GQA
   group of 1, the store at 64 kv heads); then the 40-layer Command-R 35B
   model: the slice with E on (A, B, C, E and the store launched, D not;
   every prefill attention call on C), its decode profile as graph replays
   and a prefill profile, and its server (4 slots of 8192, int8 KV, E on):
   token-id completions of 6000/2000/700/40 tokens, every request 200,
   and a decode chunk, graph against eager and profiled as graph replays;
14. the decoders without RoPE at full width, Command-R freed first:
   StarCoder-15B (a learned 8192 x 6144 f32 position table, multi-query
   attention: 48 query heads over one kv head of 128, a GQA group of 48,
   layernorm and biases, the ungated gelu FFN, a tied 49152-row lm_head)
   and BLOOM-7b1's width (ALiBi through kernels C and E, the embedding's
   layernorm, biases, 32/32 heads), each with 1 layer against the CPU as
   phase 3 (BLOOM with prompts of 896 and 500 and E on, so that C and E
   both run ALiBi; every C and E call of both on its kernel, none on the
   einsum path), D never launched; kernel rows at StarCoder's shapes (A
   and B on its five weights, C and E at G = 48, the store at one kv
   head) and C and E with ALiBi at BLOOM-7b1's heads (each also timed
   without the slopes; C beside SDPA with a float mask and flex_attention
   with ALiBi as its score_mod, E beside SDPA with a float mask); then
   the 40-layer
   StarCoder-15B model: the slice with E on (A, B, C, E and the store
   launched, D not; every attention call on C or E), its decode profile as
   graph replays and a prefill profile, and its server (4 slots of 8192,
   bf16 KV, the CLI's default, E on): token-id completions of
   6000/2000/700/40 tokens, every request 200, and a decode chunk, graph
   against eager and profiled as graph replays;
15. leading dense layers and the MoE router's selection bias at full
   width, StarCoder freed first: ERNIE-4.5-21B-A3B (layer 0 dense, 64
   experts of 1536, top-6 by softmax with the selection bias and
   renormalized, an ungated shared expert of 3072, 20/4 heads of 128, a
   tied 103424-row lm_head) with 2 layers against the CPU as phase 6, the
   bias live (the picks of at least half the rows differ from a copy with
   it zeroed) and the decode step's combine weights taken from the unbiased
   probabilities; kernel rows on the 28-layer model's weights (the expert
   skip on gate and down at M = 1, 4 and 16, F at 64 experts for the 4x512
   prefill, C and E at a GQA group of 5); the 28-layer slice (graph, then
   eager: the same tokens and launches; A, B, C, F, the store and the skip
   launched, D not), its decode profile (81 skip launches a step) and a
   prefill profile; its server (4 slots of 4096, int8 KV, E on): token-id
   completions of 2000/700/300/40 tokens, every request 200, and a decode
   chunk profiled;
16. MLA, the compressed-KV attention, at full width, ERNIE freed first:
   DeepSeek-V2-Lite (16 heads, a direct wq, kv_lora 512 + rope 64: one
   kv head of K 576 and V 512 in the cache; YaRN x40 with its mscale^2 in
   the attention's scale; layer 0 dense, 64 experts of 1408, top-6,
   shared 2816) with 2 layers against the CPU as phase 6, split
   absorption banks on the bf16 cache and a legacy attn_kv_b split by the
   loader on the int8 one; the context shift (only the k_pe tail rotated)
   against a re-prefill of the kept tokens on both caches; then the model
   cut to 7 of its 27 layers (for the script's time limit): kernel rows on
   its weights (A and B on wq, wkv_a and wo, the store at
   one head of 576/512), the einsum MLA attention at the server's step
   beside SDPA, and the expert loop's ms a MoE layer (the expert down
   planar Q8_0 at K 1408: no K-major tile, so no skip or F); the slice
   with 4 greedy steps (graph, then eager: the same tokens and launches;
   A, B and the store launched, C, D, E, F and the skip not), its decode
   profile (A's launches and one store a layer a step) and a prefill profile;
   its server (4 slots of 4096, int8 KV): token-id completions of
   480/200/80/40 tokens, 4 new each, every request 200, and a decode
   chunk profiled;
17. the combined [gate; up] and the per-layer SWA array at full width,
   DeepSeek freed first: Phi-4 (arch phi3: the fused attn_qkv and the
   combined ffn_up of 2 x 17920 rows as its file holds them, through the
   loader's fuse step, which renames the combined tensor ffn_gateup; 40/10
   heads of 128, an untied 100352-row lm_head) with 2 layers against the
   CPU as phase 3 (D and E in the decode steps); 4 Phi-4-width layers
   with the aperiodic SWA array (1, 0, 1, 1), the window cut to 128, on
   the iSWA ring in bf16 and on the full cache against the CPU as phase
   12b; kernel rows on Phi-4's weights (A and B on wqkv, wo, the combined
   gate/up, down and the lm_head at K 5120 and 17920; D at its layer; C at
   G = 4; E at the int8 server step; the store at 10 kv heads); the
   40-layer slice with E on (A, B, C, D, E and the store launched, F not;
   D, E and the store once a layer a decode step), its decode profile as
   graph replays and eagerly, and a prefill profile; its server (4 slots
   of 8192, int8 KV): token-id completions of 6000/2000/700/40 tokens,
   every request 200, D launched, and a decode chunk profiled;
18. attention sinks, gpt-oss's clamped SwiGLU with the experts' and the
   router's biases, planar MXFP4 and kernel E at head dim 64 at full
   width, Phi-4 freed first: gpt-oss-20b (24 layers, 2880 wide, 64/8 heads
   of 64, 32 MXFP4 experts of 2880 top-4 with their biases, planar at K
   2880 as q/k/v, the embedding and the 201088-row lm_head are in Q8_0,
   wo K-major; per-head sinks; the SWA array 1, 0, 1, ... with a window
   of 128; YaRN x32) with 1 layer against the CPU as phase 3 (E in the
   decode step); kernel rows on its weights and heads (A and B on wo, E
   at head dim 64 with sinks at the q8 server's, the ring server's and
   the engine's steps beside SDPA with the sink as one more key, the store
   at 8 kv heads of 64, the planar expert loop a MoE layer and the planar
   lm_head) on the model cut to 6 of its 24 layers (for the script's time
   limit); its slice with E on and 8 greedy steps (graph, then
   eager; A, B, E and the store launched, C, D, F and the skip not; every
   prefill attention call on the einsum path, as sinks keep C off, every
   decode call on E), its decode profile (A, E and the store once a layer
   a step) with the loop's and the lm_head's share of the step, and a
   prefill profile; its bf16 iSWA-ring server and its q8 server (4 slots
   of 4096, a BPE tokenizer of pre-type gpt-4o), each answering token-id
   completions of 480/200/80/40 tokens and a ~200-token text;
19. the iRoPE decoders at full width, gpt-oss freed first:
   Llama-4-Scout-17B-16E (arch llama4: 5120 wide, 40/8 heads of 128, 16
   experts of 8192 top-1 by sigmoid and an ungated shared expert of 8192
   on every layer, chunks of 8192 on 3 layers of 4 and NoPE with the
   attention temperature on the 4th, the L2 QK norm, a 202048-row untied
   lm_head; its config parsed from the keys a converted file holds,
   llama4.attention.sliding_window 8192 among them) with 4 layers (one
   iRoPE period: layer 3 NoPE) against the CPU as phase 6; kernel rows on
   the model cut to 12 of its 48 layers (the 48 would not fit beside the
   cache: ~79.8 GB of Q4_K): A at M = 4 on wqkv, wo, the shared expert's
   gate and down and the lm_head, B on wqkv at M = 2048, the skip at 16
   experts top-1 (gate and down, M = 1, 4, 16), F at 2048 top-1
   assignments, C chunked over a 16384-slot view for a 512-row block at
   8000-8511 (the chunk boundary inside it) beside SDPA with the chunk
   mask, E chunked at its heads (int8 and bf16, rows at 12000/9000/8200/40
   of 16384); the slice with E on (graph, then eager; A, B, C, E, F, the
   store and the skip launched, D not; every chunked prefill call on C),
   its decode profile (the skip 3 a layer, A 5 a layer and the lm_head, E
   and the store once a layer a step) and a prefill profile; its q8 server
   (4 slots of 16384, E on): token-id completions of 9000/2000/700/40
   tokens, 8 new each, every request 200, the 9000-token prompt past the
   8192 chunk and the temperature floor, and a decode chunk graph against
   eager and profiled.
20. the other MoE families at full width, Scout freed first:
   GroveMoE-Inst (arch grovemoe: Qwen3-30B-A3B's widths, 128 experts of 768
   top-8 picked by sigmoid and weighted by the softmax, and the chunk-expert
   bank: 64 chunk experts of 128, chunk = pick // 2, reading the routed
   experts' output, scaled by 0.05; its chunk down planar Q8_0 at K 128,
   so the bank runs the loop over every chunk) with 1 layer against the CPU
   as phase 6, the rows that name one chunk twice counted; kernel rows on
   the model cut to 6 of its 48 layers: A at M = 4 on one chunk's gate
   (128 x 2048), the chunk bank's ms a layer (a graph replay at M = 4,
   eagerly at the 4x512 prefill; no kernel of its own), C and E at
   grok-1's heads (48/8 of 128, softcap 30) at phase 2's engine prefill
   and server decode shapes beside flex_attention; the slice (9 tokens a
   request; graph, then eager; A, B, C, F, the store and
   the skip launched, D not), its decode profile (the skip 3 a layer; A on
   wqkv, wo and each chunk's gate and up a layer and the lm_head; the store
   once a layer) with the chunk bank's share of the step, and a prefill
   profile; its server as phase 10's (4 slots of 4096, int8 KV, E on, a
   Qwen2-layout tokenizer): 4 token-id completions (480/200/80/40 tokens,
   16 new each) and 2 chats;
21. the per-layer-embedding Gemmas at full width, GroveMoE-Inst freed
   first: Gemma-3n-E4B (arch gemma3n: AltUp over 4 streams with the router's
   tanh modalities, the rank-64 LAuReL bypass, the Gaussian top-k cut on the
   first 10 layers, the per-layer token stream of 35 x 256 from a
   262144-row table, the weightless V norm, 20 owning layers and 15
   shared-KV layers that read banks 18 and 19, window 512 with every 5th
   layer full, SWA rope base 1e4, softcap 30, tied 262400-row lm_head) with
   10 layers, 5 of them owning (one shared layer of each kind), against the
   CPU as phase 3; kernel rows: A and B on the per-layer input gate (256 x
   2048) and the stream's projection (8960 x 2048), C at the engine's
   prefill and E at the server's int8 and the engine's bf16 decode steps at
   8/2 heads of 256 (G 4) with the window of 512, and the plain products
   (the planar per-layer projection at K 256, the f32 LAuReL pair and AltUp
   projections) timed; the 35-layer slice with E on (17 tokens a request;
   graph, then eager: the same tokens and launch counts; A, B, C, E and the
   store launched, D not), its decode profile (A five times a layer and
   twice more, the store once an owning layer and never on a shared one,
   E once a layer) and a prefill profile; its server as phase 11's (4 slots
   of 4096, int8 KV, E on, prompts 2000/700/300/40 past the window) with a
   Qwen2-layout tokenizer of 262400 rows, 4 token-id completions and 2
   chats.
22. the dense singles' full-width model, Gemma-3n-E4B freed first:
   Apertus-8B (arch apertus: 4096 wide, 32 layers, 32/8 heads of 128, an
   ungated xIELU FFN of 21504 on every layer with the JAX synth's per-layer
   parameters, per-head q/k RMS norms, rope base 1.2e7, vocab 131072; its
   config checked against config_from_gguf of the keys and xielu.* arrays a
   converted file holds) with 2 layers against the CPU as phase 3; kernel
   rows: A and B on up (21504 x 4096) and down (4096 x 21504) beside cuBLAS,
   and xIELU's ms at M = 4 and 2048 against its byte bound; the 32-layer
   slice with E on (4x512 prefill, 32 greedy steps, graph then eager: the
   same tokens and launch counts; A, B, C, E and the store launched, D not:
   xIELU's ungated FFN closes it), its decode profile (A four times a layer
   and the lm_head, E and the store once a layer; the step's device ms by
   kernel, xIELU's share from its row) and a prefill profile; its q8 server
   (4 slots of 4096, E on, 4 token-id requests of 2000/700/300/40 tokens, 32
   new each, every one 200);
   22b. the other three at published width, 2 layers each, against the CPU
   as phase 3 with their route through D: Chameleon-7B (per-head layernorm
   q/k norms; down planar Q4_K at K 11008, so D is off), BitNet b1.58 2B-4T
   (every projection planar TQ2_0 with the sub-norms and scales: D off; the
   planar TQ2_0 products at gate and down timed beside cuBLAS and their
   bound) and CogVLM2-Llama3-19B's text side, loaded from a GGUF file
   written here with its vision expert's five tensors a layer: the device
   bytes the load adds are the params' and not the vis_* tensors' (D on).
The model slices of phases 7-8, 10, 13-18 and 20 run cut in depth for the
script's time limit (SLICE_LAYERS: DeepSeek-V2-Lite 5 of 27 layers and
gpt-oss-20b 4 of 24; Mixtral-8x7B 8 of 32, Qwen3-30B-A3B 12 of 48 and
GroveMoE-Inst 6 of 48, Command-R 35B, StarCoder-15B and Phi-4 10 of 40,
ERNIE-4.5-21B-A3B 7 of 28), where the text above gives a published depth;
every check holds per layer, and the parity runs keep their depth;
Llama-4-Scout's slice runs 12 of its 48 layers (SCOUT_SLICE_LAYERS).
Weights are random, drawn from fixed seeds
(tpullm_torch/utils/synth.py:synth_kmajor_q4k_fast with centred=True, each
Q4_K group centred like trained weights so activations stay in range
through 32 layers and greedy tokens vary, every weight drawn on the card
with a torch.Generator, in seconds where numpy took ~12 s a model;
synth_mixtral_q4k adds Mixtral's F32 router and Q4_K experts, drawn on the
card; the Qwen models take synth_kmajor_q4k_fast's arch rows, with their
q/k norms or biases, the Gemma models with head_dim 256, post-norms and a
tied lm_head, Command-R and StarCoder2 with their layernorms, biases and
blocks, StarCoder-15B and BLOOM-7b1 with their position table, ALiBi and
embedding norm, the Qwen MoE models, ERNIE and GroveMoE-Inst (with its
chunk bank) synth_moe_q4k's, and
DeepSeek-V2-Lite synth_mla_q4k's, drawn on the card, Phi-4 with
gguf_layout, gpt-oss-20b synth_gptoss's and Llama-4-Scout synth_moe_q4k's
with its generator, Gemma-3n-E4B synth_gemma3n's, Apertus-8B synth_kmajor_q4k_fast's,
Chameleon-7B and BitNet synth_dense_single's, all drawn on the card;
CogVLM2's file's blocks drawn on the card too). The last
lines are the kernel table as JSON (each row's launches on the run of its
path: the 8B engine slice, the 8B server slice for kernel E, the Mixtral
slice, the Qwen3-8B slice, the Qwen2.5-7B-width run, the Qwen3-30B-A3B
slice and server, the Gemma-2-9B slice, server and ring server, the
Gemma-7B-width run, the Command-R 35B slice and server, the StarCoder-15B
slice and server, the BLOOM-7b1-width run, the ERNIE-4.5-21B-A3B slice and
server, the DeepSeek-V2-Lite slice and server, the Phi-4 slice and
server, the gpt-oss-20b slice and servers, the Llama-4-Scout slice and
server, the GroveMoE-Inst slice and server, the Gemma-3n-E4B slice and
server, the Apertus-8B slice and server), the card's name
and power limit, and the result line.
"""
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor flop/s and
# f32 flop/s outside the tensor cores (where ALiBi's FMA a score runs)
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# Llama-3-8B shape (bench.py:34)
VOCAB, D, N_LAYER, H, HKV, HD, N_FF = 128256, 4096, 32, 32, 8, 128, 14336
# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1 config.json): the same attention
# widths, vocab 32000, 8 experts of n_ff 14336, top-2
M_VOCAB, M_EXPERT, M_USED = 32000, 8, 2

# Qwen3-8B (Qwen/Qwen3-8B config.json): hidden 4096, 36 layers, 32/8 heads of
# 128 (the 8B's attention widths), intermediate 12288, vocab 151936 (the
# lm_head's arrays padded to 152064), rope_theta 1e6, rms_norm_eps 1e-6,
# untied embeddings, neox RoPE, per-head q/k RMS norms
QWEN3 = dict(arch="qwen3", vocab_size=151936, n_embd=D, n_layer=36, n_head=H, n_head_kv=HKV,
             n_ff=12288, rope_base=1e6, rms_eps=1e-6, exact_vocab=True)
# Qwen2.5-7B (Qwen/Qwen2.5-7B config.json): hidden 3584, 28 layers, 28/4 heads
# of 128 (a GQA group of 7), intermediate 18944, vocab 152064, rope_theta
# 1e6, rms_norm_eps 1e-6, q/k/v biases
QWEN25 = dict(arch="qwen2", vocab_size=152064, n_embd=3584, n_layer=28, n_head=28, n_head_kv=4,
              n_ff=18944, rope_base=1e6, rms_eps=1e-6, exact_vocab=True)
QWEN25_LAYERS = 2  # the Qwen2.5-7B-width run's depth, cut from 28
# Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json): hidden 2048, 48 layers, 32/4
# heads of 128 (q 4096 wide over the 2048-wide stream), 128 experts of
# moe_intermediate_size 768, top-8, norm_topk_prob, intermediate_size 6144
# (no dense layer reads it), vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6,
# untied; Q4_K attention and gate/up, Q6_K down experts (Q4_K has no K tile
# at 768; a Q4_K_M file gives down more bits on some layers)
QWEN3MOE = dict(arch="qwen3moe", vocab_size=151936, n_embd=2048, n_layer=48, n_head=32,
                n_head_kv=4, head_dim=128, n_ff=6144, n_ff_exp=768, n_expert=128,
                n_expert_used=8, down_qtype="Q6_K", rope_base=1e6, rms_eps=1e-6,
                exact_vocab=True)
# GroveMoE-Inst (inclusionAI/GroveMoE-Inst config.json; llama.cpp's
# convert_hf_to_gguf.py GroveMoeModel writes experts_per_group,
# expert_group_scale and expert_chunk_feed_forward_length): Qwen3-30B-A3B's
# widths above (hidden 2048, 48 layers, 32/4 heads of 128 with per-head q/k
# norms, 128 experts of 768, top-8, norm_topk_prob, vocab 151936, rope_theta
# 1e6, rms_norm_eps 1e-6) and the chunk-expert bank: 64 chunk experts of 128,
# one a group of 2 experts, scaled by 0.05. Q4_K as Qwen3-30B-A3B's, the
# chunk gate/up Q4_K K-major at K 2048, the chunk down Q8_0 at K 128, planar
# (no K-major tile there; llama.cpp's quantizer writes Q8_0 for the Q6_K
# rows whose K is not a multiple of 256). The values are recalled, not read
# from the published files (PERF.md §6)
GROVEMOE = dict(QWEN3MOE, arch="grovemoe", n_group_experts=2, n_ff_chexp=128,
                expert_group_scale=0.05)
GROK_HEADS = (48, 8)  # grok-1: 48 query heads, 8 kv heads of 128
GROK_SOFTCAP = 30.0
# Qwen2-57B-A14B (Qwen/Qwen2-57B-A14B config.json): hidden 3584, 28 layers,
# 28/4 heads of 128, 64 experts of moe_intermediate_size 2560, top-8, not
# renormalized, a shared expert of 20480 with its sigmoid gate, q/k/v
# biases, vocab 151936, rope_theta 1e6, rms_norm_eps 1e-6; all Q4_K
QWEN2MOE = dict(arch="qwen2moe", vocab_size=151936, n_embd=3584, n_layer=28, n_head=28,
                n_head_kv=4, n_ff=18944, n_ff_exp=2560, n_expert=64, n_expert_used=8,
                n_ff_shexp=20480, rope_base=1e6, rms_eps=1e-6, exact_vocab=True)

# Gemma-2-9B (google/gemma-2-9b config.json): hidden 3584, 42 layers, 16/8 heads
# of head_dim 256 (q 4096 wide over the 3584-wide stream), intermediate 14336,
# vocab 256000, tied embeddings, gelu (tanh), post-attention and post-FFN
# norms, sliding_window 4096 on every other layer (the GGUF's pattern 2:
# layer il is SWA where (il + 1) % 2), attn_logit_softcapping 50,
# final_logit_softcapping 30, query_pre_attn_scalar 256 (= head_dim: the
# scale 1/sqrt(head_dim)), rope_theta 1e4, rms_norm_eps 1e-6; the arch row
# gives the embedding scale sqrt(3584) and the softcaps
GEMMA2 = dict(arch="gemma2", vocab_size=256000, n_embd=3584, n_layer=42, n_head=16, n_head_kv=8,
              head_dim=256, n_ff=14336, rms_eps=1e-6, exact_vocab=True, tied=True,
              cfg_fields=dict(sliding_window=4096))
# Gemma-3-4B (google/gemma-3-4b-pt config.json, text_config): hidden 2560, 34
# layers, 8/4 heads of 256 (q 2048 wide), intermediate 10240, vocab 262208,
# tied, per-head q/k norms and the post-norms, sliding_window 1024 with every
# 6th layer global (the arch row's pattern 6), rope_theta 1e6 with linear
# scaling 8, rope_local_base_freq 1e4 (the GGUF's rope.freq_base_swa),
# rms_norm_eps 1e-6
GEMMA3_4B = dict(arch="gemma3", vocab_size=262208, n_embd=2560, n_layer=34, n_head=8,
                 n_head_kv=4, head_dim=256, n_ff=10240, rope_base=1e6, rms_eps=1e-6,
                 exact_vocab=True, tied=True,
                 cfg_fields=dict(sliding_window=1024, rope_base_swa=1e4,
                                 rope_scaling="linear", rope_scale=8.0))
# Gemma-7B (google/gemma-7b config.json): hidden 3072, 28 layers, 16/16 heads
# of 256 (q 4096 wide), intermediate 24576, vocab 256000, tied, gelu (tanh),
# no window and no post-norms, so its decode takes kernel D (gelu, folded)
GEMMA7B = dict(arch="gemma", vocab_size=256000, n_embd=3072, n_layer=28, n_head=16,
               n_head_kv=16, head_dim=256, n_ff=24576, rms_eps=1e-6, exact_vocab=True,
               tied=True)
GEMMA_PARITY_WINDOW = 256  # the window of the parity runs, cut so prompts pass it
GEMMA_SERVER_PROMPTS = [6000, 2000, 700, 40]  # the Gemma-2-9B burst: past its 4096 window

TOL_QMM_NMSE = 1e-5  # same bf16 weights, f32 sums in another order, bf16 out
TOL_ATTN_NMSE = 1e-4  # p rounded to bf16 before vs after normalization
TOL_LAYER_NMSE = 1e-4  # kernel rounds weights to bf16, plain keeps f32
TOL_DECODE_NMSE = 1e-4  # p rounded to bf16 per 16-slot chunk vs once per row
# bf16 path on the card vs the f32 plain path on the CPU: at most this many
# times the NMSE of the same plain path run in bf16 on the CPU (the error
# that bf16 arithmetic alone brings on these inputs)
TOL_E2E_FACTOR = 4.0

# greedy decode steps of each parity run against the CPU after its prefill
# (phases 3, 9-17), cut from 4, then 2, for the script's time limit: a
# step's CPU bf16 reference takes 1-5 s at these vocabularies; one step
# still runs every decode kernel of its path (D, E, the skip)
PARITY_STEPS = 1
# the depth of the parity runs of Qwen2-57B-A14B's, Command-R 35B's and
# StarCoder2-15B's widths, and of Mixtral-8x7B's,
# Qwen3-30B-A3B's, StarCoder-15B's and BLOOM-7b1's, cut for the script's
# time limit: no check of theirs needs a second layer (none takes D)
ONE_LAYER = 1
# the depth of the model slices cut for the script's time (with phases
# 19-21; from 32, 48, 40, 40, 28, 27, 40, 24 and 48 layers):
# DeepSeek-V2-Lite at about a fifth and gpt-oss-20b at a sixth, ~5.5 s a
# layer each; GroveMoE-Inst at an eighth (~2.8 s a layer of its slice and
# server), the others at a quarter, 0.7-1.3 s a layer (PERF.md §6).
# (Llama-4-Scout's slice is SCOUT_SLICE_LAYERS, 12 of 48.) Each check of
# these phases holds per layer, and their parity runs keep their depth;
# --full-depth runs the published depths (past the time limit).
SLICE_LAYERS = {"Mixtral-8x7B": 8, "Qwen3-30B-A3B": 12, "Command-R 35B": 10,
                "StarCoder-15B": 10, "ERNIE-4.5-21B-A3B": 7, "DeepSeek-V2-Lite": 5,
                "Phi-4": 10, "gpt-oss-20b": 4, "GroveMoE-Inst": 6}
FULL_DEPTH = False  # --full-depth


def slice_depth(label: str, published: int) -> int:
    """The depth ``label``'s model slice runs at: SLICE_LAYERS', or the
    ``published`` one under --full-depth."""
    return published if FULL_DEPTH else SLICE_LAYERS[label]
# phase 5: synchronized decode steps timed one by one (cut from 64 for the
# script's time limit), then steps profiled
DECODE_STEPS, PROFILED_STEPS = 32, 8

SOURCES = {
    "qmm_splitk": ("tpullm_torch/csrc/qmm.cu", "tpullm/ops/qmm.py:181"),
    "qmm": ("tpullm_torch/csrc/qmm_prefill.cu", "tpullm/ops/qmm.py:239"),
    "flash_attention": ("tpullm_torch/csrc/flash_attention.cu",
                        "tpullm/ops/flash_attention.py:28"),
    "layer_kernel": ("tpullm_torch/csrc/layer_kernel.cu", "tpullm/ops/layer_kernel.py:182"),
    "moe_gmm": ("tpullm_torch/csrc/qmm_prefill.cu", "tpullm/ops/moe_gmm.py:33"),
    "flash_decode": ("tpullm_torch/csrc/flash_decode.cu", "tpullm/ops/flash_decode.py:41"),
    # the port's own kernel: no pallas_call, the work XLA fuses into _store
    "kv_store": ("tpullm_torch/csrc/kv_store.cu", "tpullm/models/llama.py:803"),
    # A's expert-skip variant: the lax.cond around each expert's A calls
    "qmm_experts": ("tpullm_torch/csrc/qmm.cu", "tpullm/models/llama.py:447"),
}
DENSE_KERNELS = ("qmm_splitk", "qmm", "flash_attention", "layer_kernel", "kv_store")
# and no layer_kernel
MOE_KERNELS = ("qmm_splitk", "qmm", "flash_attention", "moe_gmm", "kv_store", "qmm_experts")
# a MoE server's (phases 10 and 20): kernel E on
MOE_SERVER_KERNELS = MOE_KERNELS + ("flash_decode",)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def short_kernel(mangled: str) -> str:
    m = re.search(r"(qmm_splitk_kernel|qmm_reduce|qmm_wgmma_kernel|flash_kernel|layer_kernel|"
                  r"moe_gmm_kernel|flash_decode_kernel|flash_decode_merge|kv_store_kernel|"
                  r"qmm_experts_kernel|qmm_experts_reduce|qmm_experts_combine)"
                  r"(?:ILi(\d+)E(?:Li(\d+)E)?(?:Li(\d+)E)?)?", mangled)
    if not m:
        return mangled
    args = [a for a in m.groups()[1:] if a]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_per_weight(lib_path) -> dict:
    """Kernel A's instances in the built library -> {short name: (SASS
    instructions in the loop that holds its products, those of them that a
    forward branch inside it can skip and that hold no product, weights a
    thread takes in one pass, the instructions off those branches a
    weight)}, from ``cuobjdump -sass``:
    the innermost backward-branch loop that holds tensor-core products
    (HMMA: 8 weights a thread, once for each n8 tile of batch rows) or,
    without them, f32 FMAs (one for each of the MT batch rows a weight
    meets). A static count: such branches hold the code that runs once a
    scale group and the loads skipped at the slab's end. {} where cuobjdump
    is missing or gives nothing."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          timeout=300).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = short_kernel(block.split(None, 1)[0])
        if not name.startswith("qmm_splitk_kernel"):
            continue
        ins, labels, pending = [], {}, []
        for line in block.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
            if m:
                addr = int(m.group(1), 16)
                labels.update((p, addr) for p in pending)
                pending = []
                ins.append((addr, m.group(2)))
        key = "HMMA" if any("HMMA" in t for _, t in ins) else "FFMA"
        loops = []
        for addr, t in ins:
            b = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", t)
            if b:
                tgt = labels.get(b.group(1)) if b.group(1).startswith(".") else int(b.group(1), 16)
                if tgt is not None and tgt <= addr:
                    loops.append((tgt, addr))
        body = lambda lo, hi: [t for a, t in ins if lo <= a <= hi]
        hot = [(lo, hi) for lo, hi in loops if any(key in t for t in body(lo, hi))]
        inner = [(lo, hi) for lo, hi in hot
                 if not any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in hot)]
        if not inner:
            continue
        lo, hi = max(inner, key=lambda r: sum(key in t for t in body(r[0], r[1])))
        n_ins = len(body(lo, hi))
        n_key = sum(key in t for t in body(lo, hi))
        cond = set()
        for addr, t in ins:
            b = re.search(r"@!?U?P\d\s+BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", t)
            if b and lo <= addr < hi:
                tgt = labels.get(b.group(1)) if b.group(1).startswith(".") else int(b.group(1), 16)
                span = [(a, t2) for a, t2 in ins if addr < a < tgt]
                if tgt is not None and addr < tgt <= hi and not any(key in t2 for _, t2 in span):
                    cond.update(a for a, _ in span)
        mt = int(re.search(r"<(\d+)", name).group(1))
        weights = n_key * 8 * 8 // mt if key == "HMMA" else n_key // mt
        out[name] = (n_ins, len(cond), weights, (n_ins - len(cond)) / max(weights, 1))
    return out


class Timer:
    """Median per-launch time from CUDA events, L2 flushed before each
    launch (a decode step finds its weights cold: 32 layers x ~150 MB).
    A spin of HOLD_CYCLES on the card before the start event keeps the
    card busy while the host prepares the launch, so the interval holds
    the card's time only and not the wrapper's host time."""

    HOLD_CYCLES = 4_000_000  # ~2.3 ms at 1.755 GHz

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.HOLD_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        ms = sorted(s.elapsed_time(e) for s, e in events)
        return ms[len(ms) // 2]


def nmse(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean() / (b ** 2).mean().clamp_min(1e-30))


def weight_bytes(qt) -> int:
    """Bytes of a K-major weight's arrays (all of its stacked slices)."""
    return sum(v.nbytes for v in qt.data.values())


def bound_of(nbytes: float, flops: float, fp32_flops: float = 0.0):
    """(bound ms, what bounds it) on the H100's peaks: ``flops`` on the
    tensor cores in bf16, ``fp32_flops`` outside them, on their own pipe
    (so the larger of the two times, not their sum)."""
    ops_s = max(flops / BF16_FLOPS, fp32_flops / FP32_FLOPS)
    by = "bytes" if nbytes / HBM_BPS >= ops_s else "operations"
    return max(nbytes / HBM_BPS, ops_s) * 1e3, by


FLEX = None  # flex_attention compiled once, the softcapped rows' library call


def flex_call(torch, q, k, v, mask, scale, softcap, alibi=None):
    """The library call of a softcapped or ALiBi row of kernel C or E: one
    call of ``torch.nn.attention.flex_attention`` (compiled once, here
    only; the port never calls it) on q (B, H, T, D) and K/V (B, Hkv, S, D)
    that computes masked_attention's function: scores times ``scale``, then
    softcap * tanh(s / softcap), or with ``alibi`` = (slopes (H,), key
    positions (B, S), query positions (B, T)) s + slope_h * (key position -
    query position), under the (B, T, S) boolean ``mask`` as a block mask,
    built here and not timed, as SDPA's dense mask is not. Inductor's and
    Triton's caches go to the gitignored build directory. -> a callable
    giving (B, H, T, D)."""
    global FLEX
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "tpullm_torch" / "_build" / sub))
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if FLEX is None:
        import torch._dynamo

        # one compile a row's shapes and score_mod: past dynamo's default of 8
        # it would run flex_attention uncompiled
        for name in ("recompile_limit", "cache_size_limit"):
            if hasattr(torch._dynamo.config, name):
                setattr(torch._dynamo.config, name, max(64, getattr(torch._dynamo.config, name)))
        FLEX = torch.compile(flex_attention, dynamic=False)
    B, _, T, _ = q.shape
    block_mask = create_block_mask(lambda b, h, i, j: mask[b, i, j], B, None, T, k.shape[2],
                                   device=q.device)

    if alibi is not None:
        sl, kvp, pos = (t.float().contiguous() for t in alibi)

        def score_mod(s, b, h, i, j):
            return s + sl[h] * (kvp[b, j] - pos[b, i])
    else:
        def score_mod(s, b, h, i, j):
            return torch.tanh(s / softcap) * softcap

    q, k, v = (t.contiguous() for t in (q, k, v))
    return lambda: FLEX(q, k, v, score_mod=score_mod, block_mask=block_mask, scale=scale,
                        enable_gqa=True)


def launch_split(torch, timer, run, names, iters=10):
    """Device ms a call of each kernel in ``names`` (CUDA base names, for
    kernel A qmm_splitk_kernel and qmm_reduce, for kernel E its main and
    merge launches), apart: one torch.profiler pass over ``iters`` calls,
    L2 flushed before each as the Timer does."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            run()
        torch.cuda.synchronize()
    split = dict.fromkeys(names, 0.0)
    for name, ms, _ in device_kernels(prof):
        base = name.split("<")[0]
        if base in split:
            split[base] += ms / iters
    return split


def qmm_row(torch, timer, entries, kname, label, x, qt, w_bf16, path="8B", run=None):
    """One row of kernel A or B: the kernel (through ``run``, the path's own
    call, where given) against its plain version on x (..., K) and qt's
    K-major arrays, timed beside the plain version and torch.matmul on the
    pre-dequantized bf16 weight ``w_bf16``; the bound reads qt's bytes once.
    The log line gives the kernel's share of its bound (bound / ms) and its
    time over the library call's, and a digest of its output bits (two
    checkouts' kernels compared bit for bit on the same inputs); for kernel
    A also whether two calls give the same bits and the device ms of its
    two launches apart."""
    from tpullm_torch.ops.qmm import qmm_kmajor, qmm_plain

    run = run or (lambda: qmm_kmajor(x, qt.data, qt.qtype, qt.n_out, torch.bfloat16))
    plain = lambda: qmm_plain(x, qt.data, qt.qtype, qt.n_out, torch.bfloat16)
    got, want = run(), plain()
    same = bool(torch.equal(got, run()))
    torch.cuda.synchronize()
    bits = hashlib.sha1(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:12]
    err = nmse(torch, got, want)
    mae = float((got.float() - want.float()).abs().max())
    K, N = x.shape[-1], qt.n_out
    M = x.numel() // K
    bound, by = bound_of(weight_bytes(qt) + M * K * 2 + M * N * 2, 2.0 * M * N * K)
    ms = timer(run, 20 if M <= 32 else 10)
    pms = timer(plain, 3, warmup=1)
    lms = timer(lambda: torch.matmul(x, w_bf16.t()), 10)
    split = (launch_split(torch, timer, run, ("qmm_splitk_kernel", "qmm_reduce"))
             if kname == "qmm_splitk" else {})
    log(f"kernel {label}: nmse {err:.3e} (tol {TOL_QMM_NMSE:g}) repeat identical {same} "
        f"max_abs_err {mae:.4g} ms {ms:.4f} plain_ms {pms:.4f} library_ms {lms:.4f} "
        f"bound_ms {bound:.4f} ({by}) share_of_bound {bound / ms:.3f} x_library {ms / lms:.2f}"
        + "".join(f" {k}_ms {v:.4f}" for k, v in split.items()) + f" bits {bits}")
    if not (err < TOL_QMM_NMSE and same):
        raise AssertionError(f"{label}: nmse {err} (tol {TOL_QMM_NMSE}), repeat identical {same}")
    entries.append(dict(
        name=label, route="cuda", source=SOURCES[kname][0], replaces=SOURCES[kname][1],
        kernel=kname, path=path, max_abs_err=mae, ms=ms, plain_ms=pms, library_ms=lms,
        bound_ms=bound, bound_by=by, bits=bits, **({"device_ms": split} if split else {})))


def attn_row(torch, timer, entries, g, B, T, S, n_past, vf, path="8B", heads=(H, HKV), hd=HD,
             softcap=0.0, window=0, ring=0, alibi=0.0, chunked=False):
    """One row of kernel C at ``heads`` (query, kv; Llama-3-8B's unless
    given), head dim ``hd``, a logit softcap and a window on real positions
    where given: query slots n_past ..
    n_past + T - 1 of each batch row over an S-slot cache, K/V live from
    valid_from to the last query slot. Held against masked_attention (NMSE
    on rows with a visible key, padding rows exactly 0, two calls
    bit-identical) and timed beside it and SDPA. SDPA takes a dense mask
    over the view; where valid_from is 0 everywhere it also takes the live
    key prefix under a lower-right causal bias (which may reach a fused
    backend), with K/V of the group's heads as they are and expanded, and
    the fastest call is the yardstick. The bound reads q of the rows with a
    visible key, writes o once, reads each batch row's live K/V rows once,
    and counts 4 D flops a visible (query head, key) pair. A softcap row's
    library call is flex_attention over the same mask (``flex_call``), held
    against the plain version as the SDPA calls are. With ``ring`` (= S)
    K/V are an iSWA ring bank and every mask is the ring mask (position p
    at slot p % ring, visible inside the window). With ``alibi`` (the
    config's alibi_max_bias) the slopes' term is on every score, in the
    kernel, the plain version and the library calls (SDPA with the bias and
    mask as one bf16 float mask, and flex_attention with ALiBi as its
    score_mod, each held against the plain version: the faster of those
    within tolerance is the yardstick); the kernel is also timed on the same
    inputs without the slopes, and the bound counts the term's FMA a
    visible (query head, key) pair at the f32 rate. With ``chunked`` the
    window is llama4's chunk (swa_chunked) in the kernel, the plain version
    and every mask."""
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.ops.flash_attention import flash_attention, masked_attention

    H, HKV = heads
    HD = hd
    vf = torch.tensor(vf, device="cuda")
    q = torch.randn((B, T, H, HD), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((B, HKV, S, HD), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((B, HKV, S, HD), generator=g, device="cuda").to(torch.bfloat16)
    qs = n_past + torch.arange(T, device="cuda")[None].expand(B, T)
    pos = (qs - vf[:, None]).clamp_min(0)
    kvp = torch.arange(S, device="cuda")[None] - vf[:, None]
    cfg = ModelConfig(n_head=H, n_head_kv=HKV, head_dim=HD, head_dim_v=HD,
                      attn_logit_softcap=softcap, sliding_window=window, swa_chunked=chunked)
    cfg0 = cfg
    rk = {"ring": ring} if ring else {}  # a checkout without the ring takes the rest
    if chunked:
        rk["chunked"] = True
    if alibi:  # a checkout without ALiBi takes the rest
        from tpullm_torch.ops.flash_attention import alibi_of

        cfg = dataclasses.replace(cfg, use_rope=False, alibi_max_bias=alibi)
        rk["slopes"] = alibi_of(cfg, "cuda")
    run = lambda: flash_attention(q, k, v, qs, kvp, pos, vf, cfg, bool(window),
                                  **({"ring": ring} if ring else {}))
    plain = lambda: masked_attention(q, k, v, qs, kvp, pos, vf, 1.0 / math.sqrt(HD), softcap,
                                     window, **rk)
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    live = qs >= vf[:, None]
    errs = [nmse(torch, got[b][live[b]], want[b][live[b]]) for b in range(B)]
    pad_zero = all(torch.count_nonzero(got[b][~live[b]]) == 0 for b in range(B))
    same = torch.equal(got, again)
    bits = hashlib.sha1(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:12]
    mae = float((got.float() - want.float()).abs().max())
    slot = torch.arange(S, device="cuda")
    if ring:
        from tpullm_torch.ops.flash_attention import ring_mask

        mask = ring_mask(slot[None, None, :], qs[:, :, None], vf[:, None, None], window, ring)
    else:
        mask = (slot[None, None, :] <= qs[:, :, None]) & (slot[None, None, :] >= vf[:, None, None])
    if window and not ring:
        mask &= (kvp[:, None, :] >= (pos[:, :, None] // window) * window if chunked
                 else kvp[:, None, :] > pos[:, :, None] - window)
    flops = 4.0 * HD * int(mask.sum()) * H
    # each batch row's K/V rows that some query sees, read once
    kv_rows = int(mask.any(dim=1).sum()) * HKV
    nbytes = 2 * (int(live.sum()) * H * HD + B * T * H * HD + 2 * kv_rows * HD)
    bound, by = bound_of(nbytes, flops, 2.0 * int(mask.sum()) * H if alibi else 0.0)
    ms = timer(run, 20)
    ms0 = timer(lambda: flash_attention(q, k, v, qs, kvp, pos, vf, cfg0, bool(window),
                                        **({"ring": ring} if ring else {})), 20) if alibi else None
    pms = timer(plain, 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt_ = q.transpose(1, 2)
    am = mask[:, None]
    calls = {"masked": lambda: sdpa(qt_, k, v, attn_mask=am, enable_gqa=True)}
    lib_errs = {}
    if alibi:  # the bias over (B, H, T, S) in the operands' bf16, -inf where masked
        bias = rk["slopes"][None, :, None, None] * (kvp[:, None, None, :] - pos[:, None, :, None])
        fm = bias.masked_fill(~am, -math.inf).to(torch.bfloat16)
        del bias
        calls = {"sdpa_float_mask": lambda: sdpa(qt_, k, v, attn_mask=fm, enable_gqa=True),
                 "flex_attention": flex_call(torch, qt_, k, v, mask, 1.0 / math.sqrt(HD), 0.0,
                                             (rk["slopes"], kvp, pos))}
        for name, call in list(calls.items()):
            lib_errs[name] = nmse(torch, call().transpose(1, 2)[live], want[live])
            if not lib_errs[name] < TOL_ATTN_NMSE:
                del calls[name]  # not the same function within the tolerance
        if not calls:
            raise AssertionError(f"no library call within tolerance: {lib_errs}")
    elif softcap:
        calls = {"flex_attention": flex_call(torch, qt_, k, v, mask, 1.0 / math.sqrt(HD),
                                             softcap)}
    elif not any(vf.tolist()) and not window and not ring:
        from torch.nn.attention.bias import causal_lower_right

        n_kv = n_past + T
        kl, vl = k[:, :, :n_kv], v[:, :, :n_kv]
        ke, ve = (t.repeat_interleave(H // HKV, dim=1) for t in (kl, vl))
        bias = causal_lower_right(T, n_kv)
        calls["lower_right"] = lambda: sdpa(qt_, kl, vl, attn_mask=bias, enable_gqa=True)
        calls["lower_right_expanded"] = lambda: sdpa(qt_, ke, ve, attn_mask=bias)
    for name, call in list(calls.items())[0 if softcap else 1:] if not alibi else []:
        e = nmse(torch, call().transpose(1, 2)[live], want[live])
        if not e < TOL_ATTN_NMSE:
            raise AssertionError(f"library call {name}: nmse {e} against the plain version")
    lib = {name: timer(call, 20) for name, call in calls.items()}
    lms = min(lib.values())
    label = (f"flash_attention[B={B},H={H},Hkv={HKV},T={T},slots={n_past}+,S={S},D={HD}"
             + (f",softcap={softcap:g}" if softcap else "") + (f",alibi={alibi:g}" if alibi else "")
             + (f",{'chunk' if chunked else 'window'}={window}" if window else "")
             + (f",ring={ring}" if ring else "") + "]")
    log(f"kernel {label}: nmse {max(errs):.3e} (tol {TOL_ATTN_NMSE:g}) padding rows zero "
        f"{pad_zero} repeat identical {same} max_abs_err {mae:.4g} ms {ms:.4f} "
        f"plain_ms {pms:.4f} library_ms {lms:.4f} bound_ms {bound:.4f} ({by}) share_of_bound "
        f"{bound / ms:.3f} x_library {ms / lms:.2f} library calls "
        + " ".join(f"{n} {t:.4f}" for n, t in lib.items()) + f" bits {bits}"
        + (f"; library nmse {({n: f'{e:.2e}' for n, e in lib_errs.items()})}; ms without "
           f"the slopes {ms0:.4f} (ALiBi x{ms / ms0:.3f})" if alibi else ""))
    if max(errs) >= TOL_ATTN_NMSE or not pad_zero or not same:
        raise AssertionError(f"{label}: nmse {errs}, padding rows zero {pad_zero}, "
                             f"repeat identical {same}")
    entries.append(dict(
        name=label, route="cuda", source=SOURCES["flash_attention"][0],
        replaces=SOURCES["flash_attention"][1], kernel="flash_attention", path=path,
        max_abs_err=mae, ms=ms, plain_ms=pms, library_ms=lms,
        library=min(lib, key=lib.get) if alibi else "flex_attention" if softcap else "SDPA",
        bound_ms=bound, bound_by=by, bits=bits,
        **({"ms_without_alibi": ms0} if alibi else {})))
    del q, k, v, got, again, want, mask, am, calls
    torch.cuda.empty_cache()


def matmul_rows(torch, timer, entries, kernels=("qmm_splitk", "qmm")):
    """Phase 2's rows of kernels A and B (or of those named) at Llama-3-8B's
    weights: A at decode (M = 4) and at its largest padded M (32, gateup),
    B at prefill (M = 2048) and at the server's 512-row chunk (wqkv). Every
    row's inputs are drawn whether it runs or not, so each row sees the
    same inputs in every run; returns the generator for the rest of the
    phase."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.quant.kmajor import dequant_kmajor_torch
    from tpullm_torch.utils.synth import random_kmajor

    g = torch.Generator(device="cuda").manual_seed(1234)
    g32 = torch.Generator(device="cuda").manual_seed(32)
    pools = {"wqkv": ([D, HKV * HD, HKV * HD], D), "wo": ([D], H * HD),
             "gateup": ([N_FF, N_FF], D), "down": ([D], N_FF), "lm_head": ([VOCAB], D)}
    checks = [(GGMLType.Q4_K, name) for name in pools]
    checks += [(GGMLType.Q6_K, name) for name in ("wqkv", "down")]
    for qtype, name in checks:
        parts, K = pools[name]
        qt = random_kmajor(qtype, parts, K, (), g, "cuda")
        w_bf16 = dequant_kmajor_torch(qt.data, qtype, torch.bfloat16)  # library yardstick
        shapes = [("qmm_splitk", 4), ("qmm", 2048)]
        if (qtype, name) == (GGMLType.Q4_K, "wqkv"):
            shapes.append(("qmm", 512))  # B at the server's prefill chunk
        if (qtype, name) == (GGMLType.Q4_K, "gateup"):
            shapes.append(("qmm_splitk", 32))  # A's largest padded M
        for kname, M in shapes:
            gx = g32 if M == 32 else g  # the M = 32 row leaves the other rows' draws as they were
            x = torch.randn((M, K), generator=gx, device="cuda").to(torch.bfloat16)
            if kname in kernels:
                qmm_row(torch, timer, entries, kname, f"{kname}[{name},{qtype.name},M={M}]",
                        x, qt, w_bf16)
            del x
        del qt, w_bf16
        torch.cuda.empty_cache()
    return g


def layer_rows(torch, timer, entries, g, M=4, n_ff=N_FF, path="8B", d=D, heads=(H, HKV), hd=HD,
               act="silu"):
    """Phase 2's rows of kernel D at Llama-3-8B's widths (or, with n_ff and
    path, Qwen3-8B's: the same attention, n_ff 12288), Q4_K, plain and
    folded: held against its plain version (NMSE, two calls bit-identical)
    and timed beside it and beside the same layer through the port's own
    unfused path (models/llama.py: qmm on wo with the residual, rms_norm,
    ffn with the residual; folded, also rms_norm and qmm on the next
    layer's wqkv), the launches D saves. No single library call computes
    D's function, so library_ms is null. The bound reads one layer's
    weights, att, resid and the outputs once. ``d``, ``heads``, ``hd`` and
    ``act`` give another model's layer (Gemma-7B's: gelu)."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.models.llama import ffn, rms_norm
    from tpullm_torch.ops.layer_kernel import _plain as layer_plain
    from tpullm_torch.ops.layer_kernel import ffn_block, ffn_block_qkv
    from tpullm_torch.ops.qmm import qmm
    from tpullm_torch.utils.synth import random_kmajor

    L = 2
    D = d
    H, HKV = heads
    HD = hd
    qtype = GGMLType.Q4_K
    cfg = ModelConfig(n_embd=D, n_layer=L, n_head=H, n_head_kv=HKV, head_dim=HD,
                      head_dim_v=HD, n_ff=n_ff, act_fn=act)
    qw = {"wo": random_kmajor(qtype, [D], H * HD, (L,), g, "cuda"),
          "ffn_gateup": random_kmajor(qtype, [n_ff, n_ff], D, (L,), g, "cuda"),
          "ffn_down": random_kmajor(qtype, [D], n_ff, (L,), g, "cuda"),
          "wqkv": random_kmajor(qtype, [H * HD, HKV * HD, HKV * HD], D, (L,), g, "cuda")}
    norms = 1 + 0.1 * torch.randn((2, L, D), generator=g, device="cuda")
    att = (0.5 * torch.randn((M, 1, H * HD), generator=g, device="cuda")).to(torch.bfloat16)
    x = torch.randn((M, 1, D), generator=g, device="cuda").to(torch.bfloat16)
    bf = torch.bfloat16

    def unfused(fold):
        y = x + qmm(att, qw["wo"], bf, 0)
        y = y + ffn(rms_norm(y, norms[0, 0], cfg.rms_eps), qw, 0, cfg, bf)
        if not fold:
            return y
        return y, qmm(rms_norm(y, norms[1, 1], cfg.rms_eps), qw["wqkv"], bf, 1)

    for fold in (False, True):
        if fold:
            run = lambda: ffn_block_qkv(att, x, norms[0, 0], norms[1], qw, 0, cfg)
            plain = lambda: layer_plain(att, x, norms[0, 0], qw, 0, cfg, norms[1])
        else:
            run = lambda: ffn_block(att, x, norms[0, 0], qw, 0, cfg)
            plain = lambda: layer_plain(att, x, norms[0, 0], qw, 0, cfg)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        errs = [nmse(torch, a, b) for a, b in zip(got, want)]
        mae = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        used = ["wo", "ffn_gateup", "ffn_down"] + (["wqkv"] if fold else [])
        wb = sum(weight_bytes(qw[k]) for k in used) // L  # one layer's
        ncols = sum(qw[k].data["q"].shape[-1] * qw[k].shape[-1] for k in used)
        flops = 2.0 * M * ncols
        nbytes = wb + M * (H * HD + 2 * D) * 2 + (M * qw["wqkv"].n_out * 2 if fold else 0)
        bound, by = bound_of(nbytes, flops)
        ms = timer(run, 20)
        pms = timer(plain, 3, warmup=1)
        ums = timer(lambda: unfused(fold), 20)
        label = (f"layer_kernel[{'folded' if fold else 'plain'},Q4_K,M={M}"
                 + ("]" if path == "8B" else f",{path}]"))
        log(f"kernel {label}: nmse {max(errs):.3e} (tol {TOL_LAYER_NMSE:g}) repeat identical "
            f"{same} max_abs_err {mae:.4g} ms {ms:.4f} plain_ms {pms:.4f} library_ms null "
            f"bound_ms {bound:.4f} ({by}) share_of_bound {bound / ms:.3f} unfused_ms {ums:.4f} "
            f"x_unfused {ms / ums:.2f}")
        if max(errs) >= TOL_LAYER_NMSE or not same:
            raise AssertionError(f"{label}: nmse {errs}, repeat identical {same}")
        entries.append(dict(
            name=label, route="cuda", source=SOURCES["layer_kernel"][0],
            replaces=SOURCES["layer_kernel"][1], kernel="layer_kernel", path=path,
            max_abs_err=mae,
            ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound, bound_by=by,
            share_of_bound=bound / ms, unfused_ms=ums))
    del qw
    torch.cuda.empty_cache()


def phase_kernels(torch, timer, entries):
    """Phase 2: every kernel vs its plain version at 8B shapes, timed."""
    from tpullm_torch.ops import _cuda
    from tpullm_torch.ops.qmm import qmm_kmajor, qmm_plain
    from tpullm_torch.utils.synth import random_kmajor

    g = matmul_rows(torch, timer, entries)

    # C: prefill flash attention at the slice's shape (4 prompts bucketed to
    # 512) and at the server's last chunk of its 6000-token prompt
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412])
    attn_row(torch, timer, entries, g, B=1, T=512, S=8192, n_past=5632, vf=[0],
             path="8B server")

    # every K-major type through A and B at the wo shape (errors only)
    from tpullm_torch.quant.kmajor import KM_SPECS

    for qtype in KM_SPECS:
        qt = random_kmajor(qtype, [D], H * HD, (), g, "cuda")
        errs = []
        for M in (4, 2048):
            x = torch.randn((M, H * HD), generator=g, device="cuda").to(torch.bfloat16)
            got = qmm_kmajor(x, qt.data, qtype, qt.n_out, torch.bfloat16)
            want = qmm_plain(x, qt.data, qtype, qt.n_out, torch.bfloat16)
            torch.cuda.synchronize()
            errs.append(nmse(torch, got, want))
        log(f"type {qtype.name}: qmm_splitk nmse {errs[0]:.3e}, qmm nmse {errs[1]:.3e} "
            f"(tol {TOL_QMM_NMSE:g}) at {D}x{H * HD}")
        if max(errs) >= TOL_QMM_NMSE:
            raise AssertionError(f"{qtype.name}: nmse {errs}")

    # D: the decode layer kernel at M = 4, plain and folded
    layer_rows(torch, timer, entries, g)
    _cuda.reset_counts()


def weight_rows(torch, timer, entries, g, weights, path, ms=(("qmm_splitk", 4), ("qmm", 2048))):
    """Rows of kernels A and B, each (kernel, M) of ``ms``, on random Q4_K
    weights of a path's model: each (name, parts, K) of ``weights`` drawn
    from ``g`` in turn (one part at its logical rows over the padded
    arrays, as loaded), then each row's x."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops.qtensor import QTensor
    from tpullm_torch.quant.kmajor import dequant_kmajor_torch
    from tpullm_torch.utils.synth import random_kmajor

    qtype = GGMLType.Q4_K
    for name, parts, K in weights:
        qt = random_kmajor(qtype, parts, K, (), g, "cuda")
        if len(parts) == 1:
            qt = QTensor(qtype, (parts[0], K), qt.data)
        w_bf16 = dequant_kmajor_torch(qt.data, qtype, torch.bfloat16)[: qt.n_out]
        for kname, M in ms:
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            qmm_row(torch, timer, entries, kname,
                    f"{kname}[{name} {qt.n_out}x{K},{qtype.name},M={M},{path}]", x, qt, w_bf16,
                    path=path)
            del x
        del qt, w_bf16
        torch.cuda.empty_cache()


def phase_qwen_kernels(torch, timer, entries):
    """Phase 2's rows at the Qwen phase's shapes, Q4_K, each at the M its
    path gives it: kernels A and B on Qwen3-8B's new weights (gate/up N
    24576, down K 12288, the lm_head's 151936 rows over 152064 padded) at
    the slice's decode (M = 4) and prefill (M = 2048), and at Qwen2.5-7B's
    widths (wqkv at 28/4 heads, gate/up and down: K 3584 and 18944) at its
    parity run's decode (M = 2) and prefill (M = 256); kernel D at
    Qwen3-8B's layer (M = 4, plain and folded); kernels C and E at
    Qwen2.5-7B's heads (a GQA group of 7) at that run's prefill (B 2, T 128,
    S 256) and first decode step (bf16 K/V, queries at slot 128 from
    valid_from 0 and 28)."""
    from tpullm_torch.ops import _cuda

    g = torch.Generator(device="cuda").manual_seed(1515)
    q3, q25 = QWEN3, QWEN25
    d25, hd25 = q25["n_embd"], q25["n_head_kv"] * HD
    weight_rows(torch, timer, entries, g, [("gateup", [q3["n_ff"]] * 2, D),
                                           ("down", [D], q3["n_ff"]),
                                           ("lm_head", [q3["vocab_size"]], D)], "Qwen3-8B")
    weight_rows(torch, timer, entries, g, [("wqkv", [d25, hd25, hd25], d25),
                                           ("gateup", [q25["n_ff"]] * 2, d25),
                                           ("down", [d25], q25["n_ff"])], "Qwen2.5-7B",
                (("qmm_splitk", 2), ("qmm", 256)))
    layer_rows(torch, timer, entries, g, n_ff=q3["n_ff"], path="Qwen3-8B")
    attn_row(torch, timer, entries, g, B=2, T=128, S=256, n_past=0, vf=[0, 28],
             path="Qwen2.5-7B", heads=(q25["n_head"], q25["n_head_kv"]))
    decode_row(torch, timer, entries, g, "Qwen2.5-7B run", 256, [128, 128], [0, 28], False,
               heads=(q25["n_head"], q25["n_head_kv"]), path="Qwen2.5-7B")
    _cuda.reset_counts()


def moe_matmul_rows(torch, timer, entries, kernels=("qmm_splitk", "qmm")):
    """Phase 2's rows of kernels A and B (or of those named) at the
    Mixtral-8x7B path's weights: A on an expert's gate (or up) and down,
    indexed out of an (L, E) stack by the path's _expert_mm (layer 1, the
    last expert), and A and B on the 32000-row lm_head. As matmul_rows,
    every row's inputs are drawn; returns the generator."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.models.llama import _expert_mm, expert_weight
    from tpullm_torch.quant.kmajor import dequant_kmajor_torch
    from tpullm_torch.utils.synth import random_kmajor

    g = torch.Generator(device="cuda").manual_seed(4321)
    E, q4k = M_EXPERT, GGMLType.Q4_K

    def dequant(qt):
        return dequant_kmajor_torch(qt.data, qt.qtype, torch.bfloat16)

    for name, parts, K in (("expert gate/up", [N_FF], D), ("expert down", [D], N_FF)):
        stack = random_kmajor(q4k, parts, K, (2, E), g, "cuda")
        qt = expert_weight(stack, 1, E - 1)
        x = torch.randn((4, 1, K), generator=g, device="cuda").to(torch.bfloat16)
        if "qmm_splitk" in kernels:
            qmm_row(torch, timer, entries, "qmm_splitk",
                    f"qmm_splitk[{name},Q4_K,M=4,expert {E - 1} of layer 1]", x, qt,
                    dequant(qt), path="mixtral",
                    run=lambda: _expert_mm(x, stack, 1, E - 1, torch.bfloat16))
        if "qmm_experts" in kernels:  # the decode step's path: top-2 of 8 at M = 4
            skip_row(torch, timer, entries, name.split()[-1].split("/")[0], stack, 1, 4, g,
                     used=M_USED, path="mixtral")
        del stack, qt, x
    lm = random_kmajor(q4k, [M_VOCAB], D, (), g, "cuda")
    w_bf16 = dequant(lm)
    for kname, M in (("qmm_splitk", 4), ("qmm", 2048)):
        x = torch.randn((M, D), generator=g, device="cuda").to(torch.bfloat16)
        if kname in kernels:
            qmm_row(torch, timer, entries, kname, f"{kname}[lm_head {M_VOCAB},Q4_K,M={M}]", x,
                    lm, w_bf16, path="mixtral")
        del x
    del lm, w_bf16
    torch.cuda.empty_cache()
    return g


def gmm_row(torch, timer, entries, name, qt, layer, xs, te, live, A, path):
    """One row of kernel F on ``layer`` of the (L, E) stack qt over the
    expert-sorted rows xs (tile experts te, live tiles ``live``, A
    assignment rows): against its plain version (NMSE, two calls
    bit-identical), timed beside it and torch._grouped_mm on the layer's
    experts pre-dequantized over the live rows (the library yardstick); the
    bound reads the layer's experts once and the rows this routing needs,
    not the padding. Logs the live tiles and their padding share."""
    from tpullm_torch.models.llama import expert_weight
    from tpullm_torch.ops.moe_gmm import TM, grouped_qmm, grouped_qmm_plain
    from tpullm_torch.quant.kmajor import dequant_kmajor_torch

    E, N, K = qt.data["q"].shape[-3], qt.n_out, xs.shape[1]
    run = lambda: grouped_qmm(xs, te, qt, N, layer, live)
    plain = lambda: grouped_qmm_plain(xs, te, qt, N, layer)
    got, want = run(), plain()
    again = run()
    torch.cuda.synchronize()
    err = nmse(torch, got, want)
    mae = float((got.float() - want.float()).abs().max())
    same = bool(torch.equal(got, again))
    layers = qt.data["q"].shape[0]
    bound, by = bound_of(weight_bytes(qt) // layers + A * K * 2 + A * N * 2, 2.0 * A * N * K)
    ms = timer(run, 10)
    pms = timer(plain, 3, warmup=1)
    wd = torch.stack([dequant_kmajor_torch(expert_weight(qt, layer, e).data, qt.qtype,
                                           torch.bfloat16)[:N] for e in range(E)])
    n_live = int(live[0])
    offs = torch.cumsum(torch.bincount(te[:n_live].long(), minlength=E) * TM, 0)
    offs = offs.to(torch.int32)
    try:
        lib_fn = lambda: torch._grouped_mm(xs[: n_live * TM], wd.transpose(1, 2), offs=offs)
        lib_fn()
        library = "torch._grouped_mm"
    except (AttributeError, RuntimeError) as exc:
        ends = [0] + offs.tolist()
        lib_fn = lambda: [torch.matmul(xs[a:b], wd[e].t())
                          for e, (a, b) in enumerate(zip(ends[:-1], ends[1:]))]
        library = f"torch.matmul per expert ({type(exc).__name__} from _grouped_mm)"
    lms = timer(lib_fn, 10)
    label = (f"moe_gmm[{name},{qt.qtype.name},E={E},Mp={xs.shape[0]},"
             f"live={n_live * TM}]")
    log(f"kernel {label}: nmse {err:.3e} (tol {TOL_QMM_NMSE:g}) repeat identical {same} "
        f"max_abs_err {mae:.4g} ms {ms:.4f} plain_ms {pms:.4f} library_ms {lms:.4f} "
        f"({library}) bound_ms {bound:.4f} ({by}; {A} assignment rows) "
        f"share_of_bound {bound / ms:.3f} x_library {ms / lms:.2f} live tiles {n_live} of "
        f"{TM} rows, padding share {1 - A / (n_live * TM):.3f}")
    if err >= TOL_QMM_NMSE or not same:
        raise AssertionError(f"{label}: nmse {err}, repeat identical {same}")
    entries.append(dict(
        name=label, route="cuda", source=SOURCES["moe_gmm"][0],
        replaces=SOURCES["moe_gmm"][1], kernel="moe_gmm", path=path,
        max_abs_err=mae, ms=ms, plain_ms=pms, library_ms=lms, library=library,
        bound_ms=bound, bound_by=by, live_tiles=n_live,
        padding_share=1 - A / (n_live * TM)))
    del wd, got, want, again


def phase_moe_kernels(torch, timer, entries):
    """Phase 2 at the Mixtral-8x7B path's own shapes: kernel A on an
    expert's gate (or up) and down at decode (M = 4, the expert indexed out
    of an (L, E) stack by the path's _expert_mm) and on the 32000-row
    lm_head, kernel B on that lm_head at prefill (M = 2048), and kernel F at
    the prefill's shapes (4 prompts bucketed to 512 = 2048 tokens, top-2 of
    8 experts: 4096 assignments, 6144 rows with the static padding of
    256-row tiles) on layer 1 of a 2-layer (L, E) stack, each row with its
    share of the bound and its ratio to the library call as B's rows; then
    every K-major type through F at one shape. Rows taken from a stack use
    layer 1 and the last expert, so the layer and expert offsets both
    count."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.models.llama import expert_weight
    from tpullm_torch.ops.moe_gmm import (TM, grouped_qmm, grouped_qmm_plain, live_tiles,
                                          sort_by_expert)
    from tpullm_torch.quant.kmajor import KM_SPECS, dequant_kmajor_torch
    from tpullm_torch.utils.synth import random_kmajor

    g = moe_matmul_rows(torch, timer, entries, ("qmm_splitk", "qmm", "qmm_experts"))
    E, used, q4k = M_EXPERT, M_USED, GGMLType.Q4_K

    def dequant(qt):
        return dequant_kmajor_torch(qt.data, qt.qtype, torch.bfloat16)

    def ragged(M, K, routing="random"):
        top_i = torch.rand((M, E), generator=g, device="cuda").argsort(-1)[:, :used]
        if routing == "skewed":  # 3/4 of the tokens to expert 5 and their second pick to 0
            top_i[: 3 * M // 4] = torch.tensor([5, 0], device="cuda")
        order, dest, te, Mp = sort_by_expert(top_i, E, M)
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        xs = torch.zeros((Mp, K), dtype=torch.bfloat16, device="cuda")
        xs[dest] = x[order // used]
        return xs, te, live_tiles(dest, te, Mp)

    M = 2048
    for name, parts, K in (("gate/up", [N_FF], D), ("down", [D], N_FF)):
        qt = random_kmajor(q4k, parts, K, (2, E), g, "cuda")
        xs, te, live = ragged(M, K)
        gmm_row(torch, timer, entries, f"{name} of layer 1", qt, 1, xs, te, live, M * used,
                "mixtral")
        del qt, xs
        torch.cuda.empty_cache()

    # every K-major type through F at 4096 x 4096: random routing on (E,)
    # experts, skewed routing on layer 1 of (2, E)
    for qtype in KM_SPECS:
        errs = []
        for routing, lead, layer in (("random", (E,), None), ("skewed", (2, E), 1)):
            qt = random_kmajor(qtype, [D], D, lead, g, "cuda")
            xs, te, live = ragged(256, D, routing)
            got = grouped_qmm(xs, te, qt, D, layer, live)
            want = grouped_qmm_plain(xs, te, qt, D, layer)
            torch.cuda.synchronize()
            errs.append(nmse(torch, got, want))
        log(f"type {qtype.name}: moe_gmm nmse random {errs[0]:.3e}, skewed on layer 1 "
            f"{errs[1]:.3e} (tol {TOL_QMM_NMSE:g}) at E={E} {D}x{D}")
        if max(errs) >= TOL_QMM_NMSE:
            raise AssertionError(f"{qtype.name} moe_gmm: nmse {errs}")
        del qt


def decode_operands(torch, g, B, T, Hq, Hk, S, hd, slots, q8, vf=None):
    """Kernel E's operands: q (B, T, Hq, hd) bf16; K/V (B, Hk, S, hd) as
    layer 1 of a 2-layer stacked cache, bf16 or int8 with f32 row scales
    (strided views, as the path reads them); token t of row b at slot
    slots[b] + t."""
    q = torch.randn((B, T, Hq, hd), generator=g, device="cuda").to(torch.bfloat16)
    if q8:
        kv = torch.randint(-127, 128, (2, 2, B, Hk, S, hd), generator=g, device="cuda",
                           dtype=torch.int8)
        sc = torch.rand((2, 2, B, Hk, S), generator=g, device="cuda") * 0.03
        k, v, ks, vs = kv[0, 1], kv[1, 1], sc[0, 1], sc[1, 1]
    else:
        kv = torch.randn((2, 2, B, Hk, S, hd), generator=g, device="cuda").to(torch.bfloat16)
        k, v, ks, vs = kv[0, 1], kv[1, 1], None, None
    qs = torch.tensor(slots, device="cuda")[:, None] + torch.arange(T, device="cuda")[None]
    vf = torch.zeros(B, dtype=torch.int64, device="cuda") if vf is None else \
        torch.tensor(vf, device="cuda")
    return q, k, v, ks, vs, qs, qs - vf[:, None], vf


def decode_row(torch, timer, entries, g, where, S, slots, vf, q8, heads=(H, HKV),
               path="8B server", hd=HD, softcap=0.0, window=0, ring=0, alibi=0.0,
               sinks=False, chunked=False):
    """One row of kernel E at ``heads`` (Llama-3-8B's 32/8 of 128 unless
    given; T = 1), head dim ``hd``, a softcap and a window where given, over
    an S-slot view, row b's query at slots[b] with keys from vf[b]: against
    its plain version (NMSE 1e-4, two calls bit-identical), timed beside
    the plain version, the library call over the bf16 views (pre-dequantized
    for int8): SDPA with a boolean mask, or with a softcap flex_attention
    over the same mask (``flex_call``, held against the plain version), and
    the einsum path
    the model takes with E off (masked_attention over the same views), with
    the device ms of E's main and merge launches apart (profiler) and a
    digest of its output bits. The bound reads each row's visible K/V rows
    (and 8 B of scales a (head, slot) for int8) and q once and writes o
    once; 4 D flops a visible (query head, key) pair. The merge's device ms
    is 0 since the merge runs in the main launch (an older checkout's
    separate merge launch shows there). With ``ring`` (= S) K/V are an iSWA
    ring bank, row b's query at position slots[b], and every mask (the
    library call's and the einsum path's) is the ring mask. With ``alibi``
    (the config's alibi_max_bias) the slopes' term is on every score, in
    the kernel, the plain version, the einsum path and the library call:
    SDPA with the bias and mask as one bf16 float mask, held against the
    plain version (flex_attention with ALiBi as its score_mod ran 1.2-1.4x
    slower than it at all four of phase 14's E rows on an H100 80GB HBM3 at
    700 W, and its compiles cost the script ~20 s, so it is left out here); the
    kernel is also timed on the same inputs without the slopes, and the
    bound counts the term's FMA a visible (query head, key) pair at the f32
    rate. With ``sinks`` each head's sink logit (N(0, 4), gpt-oss's) joins
    every row's softmax in the kernel, the plain version and the einsum
    path; the library call is SDPA over the bf16 views with one zero key and
    value row more, whose score the float mask sets to the sink (rounded to
    bf16 there), held against the plain version within 1e-3. With
    ``chunked`` the window is llama4's chunk (swa_chunked) in the kernel,
    the plain version, the einsum path and the library call's mask."""
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.models.llama import dequant_view
    from tpullm_torch.ops.flash_attention import masked_attention
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    H, HKV = heads
    HD = hd
    B = len(slots)
    scale = 1.0 / math.sqrt(HD)
    cfg = ModelConfig(n_head=H, n_head_kv=HKV, head_dim=HD, head_dim_v=HD,
                      attn_logit_softcap=softcap, swa_chunked=chunked)
    cfg0 = cfg
    q, k, v, ks, vs, qs, pos, vft = decode_operands(torch, g, B, 1, H, HKV, S, HD, slots, q8,
                                                    vf)
    rk = {"ring": ring} if ring else {}  # a checkout without the ring takes the rest
    sk = torch.randn(H, generator=g, device="cuda") * 2.0 if sinks else None
    skw = {"sinks": sk} if sinks else {}
    ak = {}  # and one without ALiBi the rest
    if alibi:
        from tpullm_torch.ops.flash_attention import alibi_of

        cfg = dataclasses.replace(cfg, use_rope=False, alibi_max_bias=alibi)
        ak["slopes"] = alibi_of(cfg, "cuda")
    run = lambda: flash_decode(q, k, v, qs, pos, vft, cfg, window, k_scales=ks, v_scales=vs,
                               **rk, **skw)
    plain = lambda: flash_decode_plain(q, k, v, qs, pos, vft, scale, softcap, window, chunked,
                                       sk, ks, vs, **rk, **ak)
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    err = nmse(torch, got, want)
    same = bool(torch.equal(got, again))
    bits = hashlib.sha1(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:12]
    mae = float((got.float() - want.float()).abs().max())
    # visible slots of the rows
    rows = sum(min(n + 1 - f, (n - f) % window + 1 if chunked else window or n + 1,
                   ring or n + 1) for n, f in zip(slots, vft.tolist()))
    kv_bytes = rows * HKV * 2 * HD * (1 if q8 else 2) + (rows * HKV * 8 if q8 else 0)
    bound, by = bound_of(kv_bytes + 2 * B * H * HD * 2, 4.0 * HD * H * rows,
                         2.0 * H * rows if alibi else 0.0)
    ms = timer(run, 20)
    ms0 = timer(lambda: flash_decode(q, k, v, qs, pos, vft, cfg0, window, k_scales=ks,
                                     v_scales=vs, **rk), 20) if alibi else None
    pms = timer(plain, 3, warmup=1)
    split = launch_split(torch, timer, run, ("flash_decode_kernel", "flash_decode_merge"))
    kd = dequant_view(k, ks, torch.bfloat16) if q8 else k
    vd = dequant_view(v, vs, torch.bfloat16) if q8 else v
    slot = torch.arange(S, device="cuda")
    if ring:
        from tpullm_torch.ops.flash_attention import ring_mask

        mask = ring_mask(slot[None, None, None, :], qs[:, None, :, None],
                         vft[:, None, None, None], window, ring)
    else:
        mask = (slot[None, None, None, :] <= qs[:, None, :, None]) & \
            (slot[None, None, None, :] >= vft[:, None, None, None])
    kvp = slot[None] - vft[:, None]
    if window and not ring:
        mask &= (kvp[:, None, None, :] >= (pos[:, None, :, None] // window) * window if chunked
                 else kvp[:, None, None, :] > pos[:, None, :, None] - window)
    qt = q.transpose(1, 2)
    lib_errs, lib = {}, {}
    if alibi:  # the bias over (B, H, 1, S) in the operands' bf16, -inf where masked
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bias = ak["slopes"][None, :, None, None] * (kvp[:, None, None, :] - pos[:, None, :, None])
        fm = bias.masked_fill(~mask, -math.inf).to(torch.bfloat16)
        calls = {"sdpa_float_mask": lambda: sdpa(qt, kd, vd, attn_mask=fm, enable_gqa=True)}
        for name, c in calls.items():
            lib_errs[name] = nmse(torch, c().transpose(1, 2), want)
            if lib_errs[name] < TOL_DECODE_NMSE:  # the same function within the tolerance
                lib[name] = timer(c, 20)
        if not lib:
            raise AssertionError(f"no library call within tolerance: {lib_errs}")
        library = min(lib, key=lib.get)
        call = calls[library]
    elif softcap:
        library, call = "flex_attention", flex_call(torch, qt, kd, vd, mask[:, 0], scale,
                                                    softcap)
        lib_err = nmse(torch, call().transpose(1, 2), want)
        if not lib_err < TOL_DECODE_NMSE:
            raise AssertionError(f"flex_attention: nmse {lib_err} against the plain version")
    elif sinks:  # the sink as one more key: a zero K/V row whose score the mask sets
        zero = torch.zeros((B, HKV, 1, HD), dtype=torch.bfloat16, device="cuda")
        kz, vz = torch.cat([kd, zero], 2), torch.cat([vd, zero], 2)
        fm = torch.zeros(mask.shape, device="cuda").masked_fill(~mask, -math.inf)
        fm = torch.cat([fm.expand(B, H, 1, S), sk[None, :, None, None].expand(B, H, 1, 1)],
                       -1).to(torch.bfloat16)
        library, call = "SDPA_sink_key", lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kz, vz, attn_mask=fm, enable_gqa=True)
        lib_err = nmse(torch, call().transpose(1, 2), want)
        if not lib_err < 1e-3:
            raise AssertionError(f"SDPA with the sink key: nmse {lib_err} against the plain "
                                 "version")
    else:
        library, call = "SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kd, vd, attn_mask=mask, enable_gqa=True)
    lms = lib[library] if alibi else timer(call, 20)
    ems = timer(lambda: masked_attention(q, kd, vd, qs, kvp, pos, vft, scale, softcap, window,
                                         **rk, **ak, **skw,
                                         **({"chunked": True} if chunked else {})), 10)
    label = (f"flash_decode[{'int8' if q8 else 'bf16'},{where},B={B},H={H},Hkv={HKV},T=1,"
             f"S={S},D={HD},slots {'/'.join(map(str, slots))},valid_from "
             f"{'/'.join(map(str, vft.tolist()))}"
             + (f",softcap={softcap:g}" if softcap else "") + (f",alibi={alibi:g}" if alibi else "")
             + (f",{'chunk' if chunked else 'window'}={window}" if window else "")
             + (f",ring={ring}" if ring else "") + (",sinks" if sinks else "") + "]")
    log(f"kernel {label}: nmse {err:.3e} (tol {TOL_DECODE_NMSE:g}) repeat identical {same} "
        f"max_abs_err {mae:.4g} ms {ms:.4f} plain_ms {pms:.4f} library_ms {lms:.4f} "
        f"({library}, bf16 views) einsum_ms {ems:.4f} bound_ms {bound:.5f} ({by}; {rows} "
        f"slots x {HKV} heads) share_of_bound {bound / ms:.3f} x_library {ms / lms:.2f} "
        f"x_einsum {ms / ems:.3f}" + "".join(f" {n}_ms {t:.4f}" for n, t in split.items())
        + f" bits {bits}"
        + (f"; library calls {({n: f'{t:.4f}' for n, t in lib.items()})} nmse "
           f"{({n: f'{e:.2e}' for n, e in lib_errs.items()})}; ms without the slopes "
           f"{ms0:.4f} (ALiBi x{ms / ms0:.3f})" if alibi else ""))
    if not (err < TOL_DECODE_NMSE and same):
        raise AssertionError(f"{label}: nmse {err}, repeat identical {same}")
    entries.append(dict(
        name=label, route="cuda", source=SOURCES["flash_decode"][0],
        replaces=SOURCES["flash_decode"][1], kernel="flash_decode", path=path,
        max_abs_err=mae, ms=ms, plain_ms=pms, library_ms=lms, library=library,
        bound_ms=bound, bound_by=by, einsum_ms=ems, device_ms=split, bits=bits,
        **({"ms_without_alibi": ms0} if alibi else {})))
    del q, k, v, ks, vs, kd, vd, mask, got, again, want, call
    torch.cuda.empty_cache()


def decode_flag_cases(torch, g, hd):
    """Kernel E's flag cases at head dim hd (B = 4, 32/8 heads, a 2048-slot
    view, rows at slots 1500/600/90/5 from valid_from 0/3/1/7, so the last
    row has no visible key at T = 1): T 1/4/8 x bf16/int8 x plain, window,
    chunked window, softcap with sinks; each within NMSE 1e-4 of the plain
    version, two calls bit-identical, the empty row exactly 0."""
    from tpullm_torch.models.config import ModelConfig
    from tpullm_torch.ops.flash_decode import flash_decode, flash_decode_plain

    errs = {}
    for T in (1, 4, 8):
        for q8 in (False, True):
            for flags in ("plain", "window", "chunked", "softcap+sinks"):
                window = {"window": 200, "chunked": 128}.get(flags, 0)
                c = ModelConfig(n_head=H, n_head_kv=HKV, head_dim=hd, head_dim_v=hd,
                                attn_logit_softcap=30.0 if flags == "softcap+sinks" else 0.0,
                                swa_chunked=flags == "chunked")
                sk = torch.randn(H, generator=g, device="cuda") if "sinks" in flags else None
                q, k, v, ks, vs, qs, pos, vf = decode_operands(
                    torch, g, 4, T, H, HKV, 2048, hd, [1500, 600, 90, 5], q8, vf=[0, 3, 1, 7])
                got = flash_decode(q, k, v, qs, pos, vf, c, window, sk, k_scales=ks,
                                   v_scales=vs)
                again = flash_decode(q, k, v, qs, pos, vf, c, window, sk, k_scales=ks,
                                     v_scales=vs)
                want = flash_decode_plain(q, k, v, qs, pos, vf, 1.0 / math.sqrt(hd),
                                          c.attn_logit_softcap, window, c.swa_chunked, sk,
                                          ks, vs)
                torch.cuda.synchronize()
                key = f"D={hd},T={T},{'int8' if q8 else 'bf16'},{flags}"
                errs[key] = nmse(torch, got, want)
                zero = T > 1 or int(torch.count_nonzero(got[3])) == 0
                if not (errs[key] < TOL_DECODE_NMSE and torch.equal(got, again) and zero):
                    raise AssertionError(f"flash_decode {key}: nmse {errs[key]}, repeat "
                                         f"identical {torch.equal(got, again)}, empty row 0 {zero}")
    log(f"kernel flash_decode flag cases (D={hd}, B=4, S=2048, slots 1500/600/90/5): max nmse "
        f"{max(errs.values()):.3e} (tol {TOL_DECODE_NMSE:g}) over {len(errs)} cases, repeats "
        f"identical, the row with no visible key 0")


def decode_rows(torch, timer, entries):
    """Kernel E's timed rows: the server slice's decode shape (an 8192-slot
    view, rows at slots 6000/2000/700/40) on bf16 and int8 K/V, and the
    engine slice's (bf16, a 1024-slot view, the left-padded 512/300/200/
    100-token prompts at their 16th decode step: every row at slot 527,
    valid_from 0/212/312/412). Returns the generator."""
    g = torch.Generator(device="cuda").manual_seed(99)
    for q8 in (False, True):
        decode_row(torch, timer, entries, g, "server", 8192, [6000, 2000, 700, 40],
                   [0, 0, 0, 0], q8)
    decode_row(torch, timer, entries, g, "engine", 1024, [527] * 4, [0, 212, 312, 412], False)
    return g


def phase_flash_decode(torch, timer, entries):
    """Phase 2, kernel E: its timed rows (decode_rows), then its flag cases
    at head dims 128 and 256."""
    g = decode_rows(torch, timer, entries)
    for hd in (HD, 2 * HD):
        decode_flag_cases(torch, g, hd)


def store_row(torch, timer, entries, g, where, path, T, slots, b0, S, q8, heads=(H, HKV),
              hd=HD, ring=0, hdv=None):
    """One row of the KV store kernel for one layer (Llama-3-8B's and
    Mixtral's 8 kv heads of 128, 4 cache rows of S slots): bf16 K rows and
    V rows sliced out of a fused QKV output (as forward passes them), batch
    row b from slots[b], into cache rows from b0, on the int8 cache (``q8``:
    quantized, with f32 row scales) or the bf16 one. Held bit for bit
    against its plain version on values and scales; timed beside it. On the
    bf16 cache the store is one ``index_put_`` a bank, timed as library_ms
    and held bit for bit too; no PyTorch call quantizes and stores, so on
    the int8 cache library_ms is null. The bound reads each K/V value once
    (2 B) and the slots, and writes each once (int8 with its row's two f32
    scales, or bf16). ``heads`` and ``hd`` give another model's widths.
    With ``ring`` (= S) the banks are an iSWA ring: row t at slot
    (slots[b] + t) % ring, the library call's indices taken the same way.
    ``hdv``: V rows of another width than K's (MLA: K [c_kv; k_pe] 576, V
    c_kv 512, one kv head)."""
    from tpullm_torch.ops.kv_store import kv_store, kv_store_plain

    H, HKV = heads
    HD = hd
    HDV = hdv or hd
    B, B_cache = len(slots), 4
    y = (torch.randn((B, T, H * HD + HKV * (HD + HDV)), generator=g, device="cuda") * 2).to(
        torch.bfloat16)
    k = y[..., H * HD: (H + HKV) * HD].reshape(B, T, HKV, HD)
    v = y[..., (H + HKV) * HD:].reshape(B, T, HKV, HDV)
    k = k.contiguous()  # RoPE's output is contiguous; V stays a slice
    bank_dtype = torch.int8 if q8 else torch.bfloat16
    banks = [torch.zeros((B_cache, HKV, S, d), dtype=bank_dtype, device="cuda")
             for d in (HD, HDV)]
    banks += ([torch.zeros((B_cache, HKV, S), device="cuda") for _ in range(2)] if q8
              else [None, None])
    twin = [None if b is None else b.clone() for b in banks]
    slot = torch.tensor(slots, dtype=torch.int64, device="cuda")
    rk = {"ring": ring} if ring else {}  # a checkout without the ring takes the rest
    run = lambda: kv_store(banks[0], banks[1], k, v, slot, b0, banks[2], banks[3], **rk)
    plain = lambda: kv_store_plain(twin[0], twin[1], k, v, slot, b0, twin[2], twin[3], **rk)
    run()
    plain()
    torch.cuda.synchronize()
    live = [(a, b) for a, b in zip(banks, twin) if a is not None]
    same = all(torch.equal(a, b) for a, b in live)
    mae = max(float((a.float() - b.float()).abs().max()) for a, b in live)
    lms = lib_same = None
    if not q8:  # one index_put_ a bank, its indices made before the timing
        sl = slot[:, None] + torch.arange(T, device="cuda")[None, :]  # all inside the cache
        if ring:
            sl = sl % ring
        idx = ((b0 + torch.arange(B, device="cuda"))[:, None, None].expand(B, T, HKV),
               torch.arange(HKV, device="cuda")[None, None, :].expand(B, T, HKV),
               sl[:, :, None].expand(B, T, HKV))
        lib = [torch.zeros_like(b) for b in banks[:2]]
        library = lambda: (lib[0].index_put_(idx, k), lib[1].index_put_(idx, v))
        library()
        torch.cuda.synchronize()
        lib_same = torch.equal(lib[0], banks[0]) and torch.equal(lib[1], banks[1])
        lms = timer(library, 20)
    rows = B * T * HKV
    bound, by = bound_of(rows * (HD + HDV) * (2 + bank_dtype.itemsize)
                         + (rows * 2 * 4 if q8 else 0) + B * 8, 0.0)
    ms = timer(run, 20)
    pms = timer(plain, 3, warmup=1)
    label = (f"kv_store[{'int8' if q8 else 'bf16'},{where},B={B},T={T},Hkv={HKV},"
             f"D={HD if HDV == HD else f'{HD}/{HDV}'},"
             f"S={S},slots {'/'.join(map(str, slots))},cache rows from {b0}"
             + (f",ring={ring}" if ring else "") + "]")
    log(f"kernel {label}: bit-identical to plain {same} max_abs_err {mae:.4g} ms {ms:.4f} "
        f"plain_ms {pms:.4f} library_ms {'null' if lms is None else f'{lms:.4f}'} "
        f"(bit-identical {lib_same}) bound_ms {bound:.5f} ({by}) share_of_bound "
        f"{bound / ms:.3f}")
    if not same or lib_same is False:
        raise AssertionError(f"{label}: the kernel's banks differ from the plain version's "
                             f"({same}) or the library call's ({lib_same})")
    entries.append(dict(
        name=label, route="cuda", source=SOURCES["kv_store"][0],
        replaces=SOURCES["kv_store"][1], kernel="kv_store", path=path,
        max_abs_err=mae, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound, bound_by=by))


ENGINE_DECODE_SLOT = 540  # a decode step of phase 4's chunk: prompts bucketed to 512


def phase_kv_store(torch, timer, entries):
    """Phase 2, the KV store kernel at each path's shapes, bit-exact against
    the plain version: on the server's int8 cache of 8192 slots its decode
    step (4 rows at slots 6000/2000/700/40, one token each) and a 512-row
    prefill chunk (slots 5632-6143 of cache row 2); on the engines' bf16
    cache of 1024 slots (8B and Mixtral-8x7B: the same kv heads) the
    prefill of 4 rows bucketed to 512, and a decode step with every row at
    one slot."""
    g = torch.Generator(device="cuda").manual_seed(13)
    store_row(torch, timer, entries, g, "server decode", "8B server", 1,
              [6000, 2000, 700, 40], 0, 8192, True)
    store_row(torch, timer, entries, g, "server prefill chunk", "8B server", 512, [5632], 2,
              8192, True)
    for where, path in (("8B engine", "8B"), ("Mixtral engine", "mixtral")):
        store_row(torch, timer, entries, g, f"{where} decode", path, 1,
                  [ENGINE_DECODE_SLOT] * 4, 0, 1024, False)
        store_row(torch, timer, entries, g, f"{where} prefill", path, 512, [0] * 4, 0, 1024,
                  False)


def plain_cpu_copy(torch, params):
    """The model on the CPU for the plain path, with each K-major weight but
    the embedding dequantized once to a dense f32 QTensor of the same type.
    The plain path dequantizes K-major weights to f32 then casts to the
    compute dtype (qmm_plain); a dense weight is cast the same way
    (QTensor.dequant) and held in the same memory order, so the products
    are bit-identical, without
    dequantizing the 128256-row lm_head and each layer's weights on every
    call. The weights are dequantized on the card and copied to the host:
    dequant_kmajor_torch is exact f32 products and sums, one op at a time,
    so the card's bits are the CPU's (tests/test_torch_gpu.py holds them
    equal for every K-major type) in a fraction of the host's time."""
    from tpullm_torch.ops.qtensor import QTensor

    def conv(k, v):
        if isinstance(v, dict):
            return {n: conv(n, t) for n, t in v.items()}
        if isinstance(v, list):  # the layer groups (a dense lead, MoE layers)
            return [conv(k, t) for t in v]
        if isinstance(v, QTensor) and v.layout == "kmajor" and k not in (
                "tok_embd", "per_layer_tok_embd"):  # the tables: gathered, not multiplied
            # stored K-major in memory, as dequant_kmajor_torch returns it:
            # the same operand layout, so the same BLAS summation order
            w = v.dequant(torch.float32).transpose(-1, -2).contiguous().cpu().transpose(-1, -2)
            torch.cuda.empty_cache()
            return QTensor(v.qtype, v.shape, {"w": w})
        return v.to("cpu")

    return {k: conv(k, v) for k, v in params.items()}


def phase_parity(torch, label="8B", seed=7, flash_decode=None, lens=(128, 100), S=256,
                 last_only=False, synth=None, **model):
    """Phase 3 (and the Qwen and Gemma phases' parity runs): a model cut to
    a few layers at full width (``model``: synth_kmajor_q4k_fast's keywords,
    by default the 8B's with 2 layers), kernels on the card vs the plain
    path on a CPU copy, on the same tokens (teacher-forced with the card's
    greedy picks): a prefill of 2 prompts of ``lens`` tokens (left-padded
    to the longer) and PARITY_STEPS decode steps over an S-slot cache, the decode
    steps with TPULLM_FLASH_DECODE set to ``flash_decode``; with
    ``last_only`` the prefill computes the lm_head at the last position
    alone (logits_idx), sparing the CPU a 256000-row product a token.
    ``synth``: the model's synth function in place of
    synth_kmajor_q4k_fast (phase 21's synth_gemma3n), given ``model`` with
    the generator. -> the card's launch counts."""
    import numpy as np

    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.ops import _cuda
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    spec = dict(vocab_size=VOCAB, n_embd=D, n_layer=2, n_head=H, n_head_kv=HKV, n_ff=N_FF,
                generator=torch.Generator(device="cuda").manual_seed(seed))
    spec.update(model)
    vocab = spec["vocab_size"]
    t0 = time.perf_counter()
    if synth is None:
        cfg, params = synth_kmajor_q4k_fast(**spec, seed=seed, centred=True, device="cuda")
    else:
        cfg, params = synth(**spec, device="cuda")
    torch.cuda.synchronize()
    t_synth = time.perf_counter() - t0
    cpu = plain_cpu_copy(torch, params)
    t_copy = time.perf_counter() - t0 - t_synth
    rng = np.random.default_rng(3)
    B, T = len(lens), max(lens)
    tok = np.zeros((B, T), np.int64)
    posn = np.zeros((B, T), np.int64)
    for b, n in enumerate(lens):
        tok[b, T - n:] = rng.integers(0, vocab, n)
        posn[b, T - n:] = np.arange(n)
    vf = np.asarray([T - n for n in lens], np.int64)
    sides = {}
    for name, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.float32),
                             ("cpu_bf16", "cpu", torch.bfloat16)):
        p = params if dev == "cuda" else cpu
        sides[name] = dict(p=p, dev=dev, cache=KVCache.create(cfg, B, S, dtype, dev),
                           dtype=dtype, vf=torch.from_numpy(vf).to(dev))
    errs, ref_errs, agree = [], [], []
    cur_tok = torch.from_numpy(tok)
    cur_pos = torch.from_numpy(posn)
    slot, T_step = 0, T
    _cuda.reset_counts()
    try:
        with torch.inference_mode():
            for step in range(PARITY_STEPS + 1):
                set_flash_decode(flash_decode if step else None)
                out = {}
                for name, s in sides.items():
                    dev = s["dev"]
                    t0 = time.perf_counter()
                    lg, _ = forward(s["p"], cfg, cur_tok.to(dev), cur_pos.to(dev), s["cache"],
                                    slot, s["vf"], s["dtype"],
                                    kv_view_len=None if step == 0 else S,
                                    logits_idx=T_step - 1 if last_only else None)
                    out[name] = lg[:, -1].float().cpu()
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    s.setdefault("sec", []).append(time.perf_counter() - t0)
                errs.append(nmse(torch, out["card"], out["cpu"]))
                ref_errs.append(nmse(torch, out["cpu_bf16"], out["cpu"]))
                agree.append((out["card"].argmax(-1) == out["cpu"].argmax(-1)).tolist())
                nxt = out["card"].argmax(-1)
                slot += T_step
                T_step = 1
                cur_tok = nxt[:, None].to(torch.int64)
                cur_pos = torch.tensor([[n + step] for n in lens], dtype=torch.int64)
    finally:
        set_flash_decode(None)
    counts = dict(_cuda.COUNTS)
    tol = TOL_E2E_FACTOR * max(ref_errs)
    width = {k: v for k, v in spec.items() if k != "n_layer"}
    log(f"parity {spec['n_layer']}-layer {label} {width} (prefill T={T}, prompts {list(lens)}, "
        f"S={S} + {PARITY_STEPS} decode steps"
        f"{', TPULLM_FLASH_DECODE=' + flash_decode if flash_decode else ''}): card vs CPU f32 "
        f"logits nmse per step {[f'{e:.3e}' for e in errs]}; CPU bf16 vs CPU f32 "
        f"{[f'{e:.3e}' for e in ref_errs]}; tol {tol:.3e} ({TOL_E2E_FACTOR:g}x the "
        f"largest); greedy agree {agree}; card s {[round(x, 3) for x in sides['card']['sec']]} "
        f"cpu f32 s {[round(x, 2) for x in sides['cpu']['sec']]} cpu bf16 s "
        f"{[round(x, 2) for x in sides['cpu_bf16']['sec']]}; synth {t_synth:.1f} s, CPU copy "
        f"{t_copy:.1f} s; launches {counts}")
    if not all(math.isfinite(e) for e in errs + ref_errs) or max(errs) >= tol:
        raise AssertionError(f"{label} parity: nmse {errs}, tolerance {tol}")
    _cuda.reset_counts()
    del params, cpu, sides
    torch.cuda.empty_cache()
    return counts


def server_prefill(params, cfg, cache, slot, prompt, dtype, chunk=512):
    """One slot's prompt through the server's own prefill step
    (server/context.py:prefill_chunk, the body of ServerContext._prefill_step),
    in chunks of up to ``chunk`` tokens as the server feeds them. -> the last
    chunk's logits (1, vocab) f32 on the CPU."""
    from tpullm_torch.server.context import prefill_chunk

    for n_past in range(0, len(prompt), chunk):
        lg = prefill_chunk(params, cfg, cache, slot, n_past, prompt[n_past: n_past + chunk],
                           dtype)
    return lg[:, 0].float().cpu()


def phase_server_parity(torch):
    """Phase 3b: the server layout at full width, 2 layers of the 8B model,
    on an int8 cache of 4 slots x 1024: per-slot prefills through slot0
    (prompts of 700, 300, 100 and 40 tokens, the 700 in two chunks), then
    PARITY_STEPS decode steps with a per-row cache_pos, kernel E on the card
    (TPULLM_FLASH_DECODE=1), against the plain path on a CPU copy in f32 on
    its own int8 cache, teacher-forced with the card's greedy picks;
    tolerance 4x the NMSE of the same plain path in bf16 (phase 3's rule)."""
    import numpy as np

    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.ops import _cuda
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    cfg, params = synth_kmajor_q4k_fast(vocab_size=VOCAB, n_embd=D, n_layer=2, n_head=H,
                                        n_head_kv=HKV, n_ff=N_FF, seed=8, centred=True,
                                        device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(8))
    cpu = plain_cpu_copy(torch, params)
    rng = np.random.default_rng(5)
    lens = [700, 300, 100, 40]
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in lens]
    S, n_steps = 1024, PARITY_STEPS
    sides = {name: dict(p=params if dev == "cuda" else cpu, dev=dev, dtype=dt,
                        cache=KVCache.create(cfg, len(lens), S, "q8", dev))
             for name, dev, dt in (("card", "cuda", torch.bfloat16),
                                   ("cpu", "cpu", torch.float32),
                                   ("cpu_bf16", "cpu", torch.bfloat16))}
    errs, ref_errs, agree = [], [], []
    _cuda.reset_counts()
    set_flash_decode("1")
    try:
        with torch.inference_mode():
            out = {}
            for name, sd in sides.items():
                out[name] = torch.cat([server_prefill(sd["p"], cfg, sd["cache"], i, pr, sd["dtype"])
                                       for i, pr in enumerate(prompts)])
                sd["sec"] = []
            cp = torch.tensor(lens)
            for step in range(n_steps + 1):
                errs.append(nmse(torch, out["card"], out["cpu"]))
                ref_errs.append(nmse(torch, out["cpu_bf16"], out["cpu"]))
                agree.append((out["card"].argmax(-1) == out["cpu"].argmax(-1)).tolist())
                if step == n_steps:
                    break
                tok = out["card"].argmax(-1)
                for name, sd in sides.items():
                    dev = sd["dev"]
                    t0 = time.perf_counter()
                    lg, _ = forward(sd["p"], cfg, tok[:, None].to(dev), cp[:, None].to(dev),
                                    sd["cache"], cp.to(dev),
                                    torch.zeros(len(lens), dtype=torch.int64, device=dev),
                                    sd["dtype"], kv_view_len=S)
                    out[name] = lg[:, -1].float().cpu()
                    sd["sec"].append(time.perf_counter() - t0)
                cp = cp + 1
    finally:
        set_flash_decode(None)
    counts = dict(_cuda.COUNTS)
    tol = TOL_E2E_FACTOR * max(ref_errs)
    log(f"server parity 2-layer 8B (q8 cache, per-slot prefills of {lens} tokens through "
        f"slot0, then {n_steps} decode steps at per-row depths with kernel E): card vs CPU "
        f"f32 logits nmse [prefill, steps] {[f'{e:.3e}' for e in errs]}; CPU bf16 vs CPU f32 "
        f"{[f'{e:.3e}' for e in ref_errs]}; tol {tol:.3e} ({TOL_E2E_FACTOR:g}x the largest); "
        f"greedy agree {agree}; card decode s {[round(x, 3) for x in sides['card']['sec']]}; "
        f"launches {counts}")
    if not all(math.isfinite(e) for e in errs + ref_errs) or max(errs) >= tol:
        raise AssertionError(f"server parity: nmse {errs}, tolerance {tol}")
    if counts["flash_decode"] != 2 * n_steps:
        raise AssertionError(f"server parity: kernel E launched {counts['flash_decode']} "
                             f"times, expected {2 * n_steps}")
    _cuda.reset_counts()
    del params, cpu, sides
    torch.cuda.empty_cache()


def synth_moe(spec: dict, **kw):
    """synth_moe_q4k of a model spec (QWEN3MOE, QWEN2MOE: the down experts'
    type by name), with ``kw`` over it."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.utils.synth import synth_moe_q4k

    spec = dict(spec, **kw)
    if "down_qtype" in spec:
        spec["down_qtype"] = GGMLType[spec["down_qtype"]]
    return synth_moe_q4k(**spec)


# phase 19's top-1 parity: a (token, layer) routing that the CPU f32 path
# would pick otherwise must be a near-tie there, its picks' probabilities
# within this of each other. Set from near_tie_readings on the H100: the
# healthy card's largest gap 0.0149 over seeds 53-57 (0.0074 at the
# parity's seed 53), a planted router fault's (the router reading the
# residual stream ahead of ffn_norm) 0.104 at seed 53 (PERF.md §6)
NEAR_TIE = 0.03


def phase_moe_parity(torch, label="Mixtral-8x7B", spec=None, seed=7, n_layer=2,
                     force_routing=False):
    """Phase 6 (and phases 10 and 15's parity runs): a full-width MoE model
    cut to ``n_layer`` layers (Mixtral-8x7B, or ``spec``, a synth_moe spec), kernels
    on the card vs the plain path on a CPU copy (teacher-forced with the
    card's greedy picks): a 128-token prefill (ragged MoE, kernel F) and 1
    decode step (the selected experts, A's expert-skip variant). Counts the
    (token, layer) top-k sets that differ between the card and the CPU f32
    path. Where the MoE layers carry the router's selection bias
    (moe_probs_b), each step also runs on the card once more on a copy with
    the bias set to zero (its launches taken back; it writes the same K/V,
    which no MoE output feeds), and the bias must be live: the selected
    experts differ from the copy's on at least half of the real prefill
    rows and of the decode rows; and the decode step's combine weights
    (what moe_decode is handed) must be the router's unbiased probabilities
    at the biased picks, renormalized and scaled, and not the biased ones.
    With ``force_routing`` (phase 19's top-1 of 16: a routing the two paths
    split on swaps a whole expert's output, so the logits' NMSE would test
    bf16's tie-breaking, not the kernels) the CPU sides take the card's
    picks (teacher-forced routing, as the tokens are); each routing the CPU
    f32 path would pick otherwise is counted as before and must be a
    near-tie there (its probabilities of the two picks within NEAR_TIE).
    With a chunk-expert bank (n_group_experts: GroveMoE) the real rows
    whose card picks name one chunk twice (two picks in one group, their
    chunk's weights summed) are counted, and the prefill must hold some.
    -> the card's launch counts."""
    from unittest import mock

    import numpy as np

    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.ops import _cuda
    from tpullm_torch.utils.synth import synth_mixtral_q4k

    if spec is None:
        cfg, params = synth_mixtral_q4k(vocab_size=M_VOCAB, n_embd=D, n_layer=n_layer,
                                        n_head=H, n_head_kv=HKV, n_ff=N_FF, n_expert=M_EXPERT,
                                        n_expert_used=M_USED, seed=seed, device="cuda")
    else:
        cfg, params = synth_moe(spec, n_layer=n_layer, seed=seed, device="cuda")
    vocab = cfg.vocab_size
    cpu = plain_cpu_copy(torch, params)
    rng = np.random.default_rng(3)
    B, T, S = 2, 128, 256
    lens = [128, 100]
    tok = np.zeros((B, T), np.int64)
    posn = np.zeros((B, T), np.int64)
    for b, n in enumerate(lens):
        tok[b, T - n:] = rng.integers(0, vocab, n)
        posn[b, T - n:] = np.arange(n)
    vf = np.asarray([T - n for n in lens], np.int64)
    sides = {}
    for name, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.float32),
                             ("cpu_bf16", "cpu", torch.bfloat16)):
        p = params if dev == "cuda" else cpu
        sides[name] = dict(p=p, dev=dev, cache=KVCache.create(cfg, B, S, dtype, dev),
                           dtype=dtype, vf=torch.from_numpy(vf).to(dev))
    top_k = llama.top_k
    groups = params["layers"].get("__groups__") or [params["layers"]]
    bias = next((gl["moe_probs_b"] for gl in groups if "moe_probs_b" in gl), None)
    free = None
    if bias is not None:  # the copy with the bias set to zero (the same other tensors)
        free = dict(params, layers={"__groups__": [
            dict(gl, moe_probs_b=torch.zeros_like(gl["moe_probs_b"])) if "moe_probs_b" in gl
            else gl for gl in groups]})
    combine = []  # the card's decode step: (w, top_i) handed to moe_decode
    moe_decode = llama.moe_decode
    forced = []  # with force_routing: the card's picks of this step, in call order

    def routed(probs, k):
        return forced.pop(0).to(probs.device) if forced else top_k(probs, k)

    def recorded(*a):
        combine.append((a[1].float().cpu(), a[2].cpu()))
        return moe_decode(*a)

    _cuda.reset_counts()
    errs, ref_errs, agree, flips, live, sels, twice = [], [], [], [], [], [], []
    cur_tok = torch.from_numpy(tok)
    cur_pos = torch.from_numpy(posn)
    slot, T_step = 0, T
    # each layer's routing: the router probabilities the path hands top_k
    ties = []  # each forced step's largest probability gap of a routing the CPU picks otherwise
    with mock.patch.object(llama, "top_k", wraps=routed) as spy, mock.patch.object(
            llama, "moe_decode", recorded), torch.inference_mode():
        for step in range(2):
            out, picked = {}, {}
            if bias is not None:
                spy.reset_mock()
                with _cuda.counts_taken_back({}):
                    forward(free, cfg, cur_tok.cuda(), cur_pos.cuda(), sides["card"]["cache"],
                            slot, sides["card"]["vf"], torch.bfloat16,
                            kv_view_len=None if step == 0 else S)
                picked["card_free"] = [top_k(*c.args).cpu().sort(-1).values
                                       for c in spy.call_args_list]
                combine.clear()
            card_picks = []
            for name, s in sides.items():
                dev = s["dev"]
                if force_routing and name != "card":
                    forced[:] = card_picks
                spy.reset_mock()
                t0 = time.perf_counter()
                lg, _ = forward(s["p"], cfg, cur_tok.to(dev), cur_pos.to(dev), s["cache"],
                                slot, s["vf"], s["dtype"], kv_view_len=None if step == 0 else S)
                out[name] = lg[:, -1].float().cpu()
                if dev == "cuda":
                    torch.cuda.synchronize()
                s.setdefault("sec", []).append(time.perf_counter() - t0)
                picked[name] = [top_k(*c.args).cpu().sort(-1).values
                                for c in spy.call_args_list]
                if dev == "cuda":
                    sels.append([c.args[0].float().cpu() for c in spy.call_args_list])
                    card_picks = [top_k(*c.args).cpu() for c in spy.call_args_list]
                if force_routing and name == "cpu":
                    # CPU f32 probability mass of its own picks over the card's, (B, T) a call
                    gaps = [c.args[0].float().gather(-1, top_k(*c.args)).sum(-1)
                            - c.args[0].float().gather(-1, mine).sum(-1)
                            for c, mine in zip(spy.call_args_list, card_picks)]
            # real tokens only: left padding routes too, but is masked
            real = torch.zeros(cur_tok.shape, dtype=torch.bool)
            for b, n in enumerate(lens):
                real[b, cur_tok.shape[1] - (n if step == 0 else 1):] = True
            flips.append(sum(int(((a != c).any(-1) & real).sum())
                             for a, c in zip(picked["card"], picked["cpu"])))
            if cfg.n_group_experts:
                used_ch = min(cfg.n_expert_used, cfg.n_expert // cfg.n_group_experts)
                ids = [p[..., :used_ch] // cfg.n_group_experts for p in card_picks]
                twice.append(sum(int(((c[..., :, None] == c[..., None, :]).triu(1).any(-1)
                                      .any(-1) & real).sum()) for c in ids))
            if force_routing:
                ties.append(max(float(g[real].max()) for g in gaps))
            if bias is not None:
                live.append(sum(int(((a != c).any(-1) & real).sum())
                                for a, c in zip(picked["card"], picked["card_free"])))
            errs.append(nmse(torch, out["card"], out["cpu"]))
            ref_errs.append(nmse(torch, out["cpu_bf16"], out["cpu"]))
            agree.append((out["card"].argmax(-1) == out["cpu"].argmax(-1)).tolist())
            nxt = out["card"].argmax(-1)
            slot += T_step
            T_step = 1
            cur_tok = nxt[:, None].to(torch.int64)
            cur_pos = torch.tensor([[n + step] for n in lens], dtype=torch.int64)
    counts = dict(_cuda.COUNTS)
    tol = TOL_E2E_FACTOR * max(ref_errs)
    n_moe = cfg.n_layer - cfg.n_layer_dense_lead
    n_routes = [sum(lens) * n_moe, B * n_moe]
    width = {k: v for k, v in (spec or {}).items() if k not in ("n_layer", "generator")}
    log(f"parity {n_layer}-layer {label} {width} (prefill T={T} + 1 decode step): card vs CPU f32 "
        f"logits nmse per step {[f'{e:.3e}' for e in errs]}; CPU bf16 vs CPU f32 "
        f"{[f'{e:.3e}' for e in ref_errs]}; tol {tol:.3e} ({TOL_E2E_FACTOR:g}x the largest); "
        f"(token, layer) routings differing card vs CPU f32 {flips} of {n_routes}; "
        f"greedy agree {agree}; "
        + (f"routing teacher-forced to the card's picks, the CPU f32 path's own picks' "
           f"probability over the card's at most {[f'{g:.2e}' for g in ties]} (near-tie "
           f"bound {NEAR_TIE:g}); " if force_routing else "")
        + (f"(token, layer) rows naming one chunk twice {twice} of {n_routes}; "
           if twice else "")
        + f"card s {[round(x, 3) for x in sides['card']['sec']]} "
        f"cpu f32 s {[round(x, 2) for x in sides['cpu']['sec']]} cpu bf16 s "
        f"{[round(x, 2) for x in sides['cpu_bf16']['sec']]}; launches {counts}")
    if not all(math.isfinite(e) for e in errs + ref_errs) or max(errs) >= tol:
        raise AssertionError(f"{n_layer}-layer {label} parity: nmse {errs}, tolerance {tol}, "
                             f"routing flips {flips}")
    if cfg.n_group_experts and not twice[0]:
        raise AssertionError(f"{n_layer}-layer {label} parity: no prefill row names one chunk "
                             "twice, so the parity does not hold the summed chunk weights")
    if force_routing and not max(ties) < NEAR_TIE:
        raise AssertionError(f"{n_layer}-layer {label} parity: a routing the CPU f32 path "
                             f"picks otherwise is no near-tie: probability gaps {ties}")
    if bias is not None:
        # the decode step's one MoE call: the biased probabilities top_k got
        # and the weights moe_decode got
        (w, top_i), = combine
        used = top_i.shape[-1]
        w, top_i = w.reshape(-1, used), top_i.reshape(-1, used).long()
        sel = sels[-1][0].reshape(top_i.shape[0], -1)
        b = bias[-1].float().cpu()

        def weights(p):
            wt = torch.gather(p, -1, top_i)
            if cfg.expert_weights_norm:
                wt = wt / wt.sum(-1, keepdim=True).clamp_min(1e-9)
            return wt * cfg.expert_weights_scale

        w_err = float((w - weights(sel - b)).abs().max())
        w_biased = float((w - weights(sel)).abs().max())
        log(f"parity {n_layer}-layer {label}: selection bias (std {float(b.std()):.4g}) live: "
            f"(token, MoE layer) routings that the zeroed copy picks otherwise {live} of "
            f"{n_routes}; decode combine weights against the unbiased probabilities' "
            f"max |diff| {w_err:.3e}, against the biased ones' {w_biased:.3e}")
        if not (2 * live[0] >= n_routes[0] and 2 * live[1] >= n_routes[1]
                and w_err < 1e-5 and w_biased > 1e-3):
            raise AssertionError(f"{n_layer}-layer {label}: selection bias live {live} of "
                                 f"{n_routes}, "
                                 f"combine weights off the unbiased probabilities by {w_err}, "
                                 f"off the biased ones by {w_biased}")
    missing = [k for k in MOE_KERNELS if counts[k] <= 0]
    if missing or counts["layer_kernel"]:
        raise AssertionError(f"{n_layer}-layer {label} parity: kernels not launched {missing}, "
                             f"layer kernel {counts['layer_kernel']}")
    _cuda.reset_counts()
    del params, cpu, sides, groups, free, bias
    torch.cuda.empty_cache()
    return counts


def phase_slice(torch, label, cfg, params, vocab, must, must_not=(), new=33, samples=3):
    """Phases 4 and 7: a 32-layer model answers 4 requests through
    generate, each decode step a replay of the engine's CUDA graph: one run
    with the launch counts (set to 0 just before it; replays add their
    capture's counts), then one timed run (prefill alone, then
    prefill + 32 decode steps, each the median of 3 samples, so that one
    sample's host stall moves neither the prefill rate nor the decode ms,
    their difference over 32). Then one eager pass of the same requests
    (cuda_graphs=False), which must give the same greedy tokens, 4 x 33,
    and the same launch counts, and its timings from one sample each (cut
    from the median of 3 for the script's time limit: eager steps take
    3-9x a replay's). ``new`` tokens a request (33: the engines' decode
    chunk is 32 steps) and ``samples`` a timing (3); with one sample the
    eager decode is timed from its checked run (DeepSeek-V2-Lite's, cut
    for the script's time limit: its eager step takes ~1.1-1.3 s). ->
    (counts, graph engine, eager engine, prompts)."""
    import numpy as np

    from tpullm_torch.ops import _cuda
    from tpullm_torch.runtime.engine import InferenceEngine

    rng = np.random.default_rng(42)
    lens = [512, 300, 200, 100]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    dec_steps = new - 1  # the first token from prefill, then one chunk of decode steps
    eng = InferenceEngine(cfg, params, max_seq_len=1024, decode_chunk=dec_steps)
    eager = InferenceEngine(cfg, params, max_seq_len=1024, decode_chunk=dec_steps,
                            cuda_graphs=False)

    def timed(e, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = e.generate(prompts, max_new_tokens=n)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    def median_timed(e, n, k=samples):
        runs = [timed(e, n) for _ in range(k)]
        return runs[-1][0], sorted(t for _, t in runs)[k // 2]

    timed(eng, 1)  # warm-up: first use of each kernel shape
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    r1, t_capture = timed(eng, new)  # its first step is the warm-up, then the capture
    counts = dict(_cuda.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _, t_pre = median_timed(eng, 1)
    r2, t_all = median_timed(eng, new)
    pre = sum(lens) / t_pre
    step_ms = (t_all - t_pre) / dec_steps * 1e3
    flat = [t for row in r1.tokens for t in row]
    in_range = all(0 <= t < vocab for t in flat)
    same = r1.tokens == r2.tokens
    _cuda.reset_counts()
    r_eager, t_all = timed(eager, new)
    eager_counts = dict(_cuda.COUNTS)
    _, t_pre = median_timed(eager, 1, k=1)
    if samples > 1:
        _, t_all = median_timed(eager, new, k=1)
    eager_ms = (t_all - t_pre) / dec_steps * 1e3
    graph_eq = r_eager.tokens == r1.tokens
    log(f"slice {label} (times: medians of {samples} samples, eager one): prefill "
        f"{sum(lens)} tokens "
        f"(bucket 4x512) {pre:.1f} tok/s; decode {len(lens)}x{dec_steps} tokens "
        f"{step_ms:.2f} ms/step ({len(lens) * 1e3 / step_ms:.1f} tok/s) as graph replays "
        f"(first run with its capture {t_capture:.3f} s), eager {eager_ms:.2f} ms/step; "
        f"graphs {len(eng.graphs)}; peak memory {peak:.3f} GB; launches {counts}; "
        f"eager launches equal {eager_counts == counts}; tokens in range {in_range}; "
        f"repeat identical {same}; graph tokens == eager tokens {graph_eq}")
    log(f"slice {label}: first tokens {[row[:8] for row in r1.tokens]}")
    if not (in_range and same and all(len(t) == new for t in r1.tokens)):
        raise AssertionError(f"slice {label}: output check failed")
    if not (graph_eq and all(len(t) == new for t in r_eager.tokens)):
        raise AssertionError(f"slice {label}: graph tokens differ from eager: "
                             f"{r1.tokens} vs {r_eager.tokens}")
    if eager_counts != counts or len(eng.graphs) != 1:
        raise AssertionError(f"slice {label}: launches graph {counts} vs eager {eager_counts}, "
                             f"{len(eng.graphs)} graphs")
    missing = [k for k in must if counts[k] <= 0]
    extra = [k for k in must_not if counts[k] > 0]
    if missing or extra:
        raise AssertionError(f"slice {label}: kernels not launched {missing}, "
                             f"launched but off this path {extra}")
    return counts, eng, eager, prompts


SERVER_PROMPTS = [6000, 2000, 700, 300, 120, 40]  # the burst: 6 requests on 4 slots
SERVER_NEW = 64  # max_tokens of every request
SERVER_STREAMED, SERVER_SAMPLED = 2, 3  # indices of the streamed and the sampled request
TOKENIZE_TOKENS = 6000  # the /tokenize text's length in tokens
CHAT_STOP = "e"  # the stop string of the chat burst's stop request
WORDS = ("the of and to in is was that for on with as by at from it this be are have not "
         "but or an which one all were her she there would their we him been has when who "
         "will more no if out so said what up its about into than them can only other new "
         "some could time these two may then do first any my now such like our over man me "
         "even most made after also did many before must through back years where much your "
         "way well down should because each just those people how too little state good very "
         "make world still own see men work long get here between both life being under never "
         "day same another know while last might us great old year off come since against go "
         "came right used take three city river market power water house music language").split()


def english_text(tok, n_tokens: int, seed: int) -> str:
    """Sentences of common English words, numbers and punctuation drawn from
    a seed, cut at the sentence where the tokenizer's count reaches
    n_tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sents = []
    for i in range(n_tokens // 4):  # more than n_tokens: 6-17 words a sentence
        words = [WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(6, 18)))]
        if rng.random() < 0.3:
            words.insert(int(rng.integers(1, len(words))), str(int(rng.integers(1, 10 ** 5))))
        if rng.random() < 0.3:
            words[int(rng.integers(1, len(words)))] += ","
        sents.append(" ".join(words).capitalize() + (". " if i % 7 else ".\n\n"))
    lo, hi = 1, len(sents)
    while lo < hi:  # the fewest sentences that reach n_tokens
        mid = (lo + hi) // 2
        if len(tok.encode("".join(sents[:mid]), add_special=False)) < n_tokens:
            lo = mid + 1
        else:
            hi = mid
    return "".join(sents[:lo])


def visible(tok, ids, stop=()):
    """The text the server returns for generated ids: their decode without
    special tokens, a trailing partial UTF-8 character held back, cut at the
    first stop string; without a tokenizer, the ids themselves."""
    if tok is None:
        return " ".join(map(str, ids))
    text = tok.decode(ids, skip_special=True)
    if text.endswith("\ufffd"):
        text = text[: text.rfind("\ufffd")]
    for st in stop:
        if st in text:
            text = text[: text.find(st)]
    return text


def http_json(url, body, timeout=600):
    """POST body as JSON -> (status, parsed JSON or SSE events list)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read().decode()
            status = r.status
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()
    if body.get("stream"):
        return status, [json.loads(x[6:]) for x in raw.splitlines()
                        if x.startswith("data: ") and x != "data: [DONE]"]
    return status, json.loads(raw)


def server_burst(base, prompts, label, tok, vocab=VOCAB, first_admitted=None, new=SERVER_NEW):
    """The burst: one thread per request, all sent at once, token-id prompts
    with ignore_eos (every request makes ``new`` tokens, SERVER_NEW unless
    given). Request
    SERVER_STREAMED streams, SERVER_SAMPLED samples (temperature 0.8, top_k
    40, seed 1234), the rest are greedy. With ``first_admitted`` (a
    callable) request 0 goes first and the others once it returns true (it
    is admitted: the first free slot is its). Fails on any non-200, error
    event, completion that is not ``new`` tokens, or text that is not the
    tokenizer's (``visible``). -> (results, wall s)."""
    import threading

    results = [None] * len(prompts)

    def one(i):
        body = {"prompt": prompts[i], "max_tokens": new, "temperature": 0.0,
                "ignore_eos": True}
        if i == SERVER_SAMPLED:
            body.update(temperature=0.8, top_k=40, seed=1234)
        if i == SERVER_STREAMED:
            body["stream"] = True
        results[i] = http_json(base + "/v1/completions", body)

    t = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for i, th in enumerate(threads):
        th.start()
        while i == 0 and first_admitted is not None and not first_admitted():
            if time.perf_counter() - t > 60:
                raise AssertionError(f"server {label}: request 0 not admitted in 60 s")
            time.sleep(0.01)
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    out = []
    for i, (status, r) in enumerate(results):
        if status != 200:
            raise AssertionError(f"server {label}: request {i} answered {status}: {r}")
        if i == SERVER_STREAMED:
            if any("error" in e for e in r):
                raise AssertionError(f"server {label}: stream {i} carried an error: {r}")
            text = "".join(e["choices"][0]["text"] for e in r)
            ids = r[-1]["choices"][0]["tokens"]
            stats = r[-1]["timings"]
            ok = (len(ids) == new == stats["completion_tokens"]
                  and text == visible(tok, ids)
                  and r[-1]["choices"][0]["finish_reason"] == "length"
                  and sum(1 for e in r if e["choices"][0]["text"]) >= 2)
        else:
            ids = r["choices"][0]["tokens"]
            stats = r["timings"]
            ok = (len(ids) == new == r["usage"]["completion_tokens"]
                  and r["choices"][0]["text"] == visible(tok, ids))
        if not ok or not all(0 <= x < vocab for x in ids):
            raise AssertionError(f"server {label}: request {i} output check failed: "
                                 f"{len(ids)} ids, stats {stats}")
        out.append(dict(prompt_tokens=stats["prompt_tokens"], prefill_s=stats["prefill_s"],
                        decode_s=stats["decode_s"], cached=stats["cached_tokens"], ids=ids))
    return out, wall


def launch_calls(prof, steps):
    """Runtime launch calls per step of a torch.profiler run, by API name."""
    calls = {}
    for e in prof.key_averages():
        if e.key in RUNTIME_LAUNCHES:
            calls[e.key] = calls.get(e.key, 0) + e.count / steps
    return calls


def graph_against_eager(torch, ctx, n, view):
    """One decode chunk from the same state as graph replays and as eager
    steps (the state the chunk changes, the cache, the step buffers and the
    penalty ring, is restored before each and after, and the draw stream
    reseeded: a greedy row draws too, and its noise breaks exact ties of
    the bf16 logits): identical greedy tokens and launch counts, or raise.
    -> the chunk's launch counts."""
    import numpy as np

    from tpullm_torch.ops import _cuda

    st, pen, cache = ctx.state, ctx.penalties, ctx.memory.cache
    live = [t for t in (cache.k, cache.v, cache.ks, cache.vs, cache.kw, cache.vw, st.logits,
                        st.ctl, st.mu, st.toks, pen.counts, pen.ring, pen.pos) if t is not None]
    saved = [t.clone() for t in live]
    res = {}
    for way in ("graph", "eager"):
        ctx.cuda_graphs = way == "graph"
        for t, c in zip(live, saved):
            t.copy_(c)
        ctx._gen.manual_seed(ctx._seed)
        before = dict(_cuda.COUNTS)
        toks = ctx._decode(n, view, False)[0]
        res[way] = (toks, {k: _cuda.COUNTS[k] - before[k] for k in before})
    for t, c in zip(live, saved):
        t.copy_(c)
    del saved
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    (tg, cg), (te, ce) = res["graph"], res["eager"]
    if not (np.array_equal(tg, te) and cg == ce):
        raise AssertionError(f"server chunk graph vs eager: tokens {tg.tolist()} vs "
                             f"{te.tolist()}, launch counts {cg} vs {ce}")
    return cg


def chunk_profile(torch, ctx, n):
    """The server's own decode chunks (ctx._decode_step, the loop's body)
    as they run now (graph replays or eager steps): one chunk of warm-up, 3
    timed (synchronized) and 1 under torch.profiler (cut from 2 for the
    script's time limit: the profiler's work took up to 16 s a call on the
    card's host) -> wall and device ms a
    step, the busy share, kernels and runtime launch calls a step, device ms
    and launches a step by kernel, the rows' depths at the start."""
    from torch.profiler import ProfilerActivity, profile

    depths = [int(x) for x in ctx._pos]
    ctx._decode_step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        ctx._decode_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / (3 * n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ctx._decode_step()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels) / n
    by = {}
    for name, ms, cnt in kernels:
        k = KERNEL_OF.get(name.split("<")[0], "other")
        tot, c = by.get(k, (0.0, 0))
        by[k] = (tot + ms / n, c + cnt / n)
    return {"way": "graph" if ctx.cuda_graphs else "eager", "wall_ms_per_step": wall,
            "device_busy_ms_per_step": busy, "device_busy_share": busy / wall,
            "depths_at_start": depths, "kv_view": ctx._kv_view_bucket(n),
            "kernel_launches_per_step": sum(c for _, _, c in kernels) / n,
            "runtime_launch_calls_per_step": launch_calls(prof, n),
            "device_ms_launches_per_step_by_kernel": by}


def server_chunk_profile(torch, ctx, prompts, modes, ways=("graph", "eager"), lone=True):
    """Decode chunks of the server's own loop body, driven from this thread
    with the loop stopped: 4 slots prefilled once with the burst's 4
    longest prompts, the longest alone and under torch.profiler (its
    prefill chunks' device ms by kernel, wall ms with the profiler on);
    then for each (label, TPULLM_FLASH_DECODE value) in modes, one chunk as
    graph replays against the same chunk as eager steps from the same state
    (graph_against_eager), then chunk_profile as graph replays and as eager
    steps (cuda_graphs toggled; the rows deepen by 5 chunks a way), or only
    the ``ways`` given. A graph step must be one cudaGraphLaunch. -> {label:
    {"graph": ..., "eager": ..., "launch_counts_per_chunk": ...}} and, with
    ``lone`` (else the longest is prefilled with the rest, unprofiled),
    {"lone_prefill": the longest prompt's prefill profile}."""
    from torch.profiler import ProfilerActivity, profile

    from tpullm_torch.server.context import GenParams, Task

    n = ctx.decode_chunk
    for pr in prompts[:ctx.n_slots]:
        ctx.submit(Task(tokens=pr, params=GenParams(max_tokens=10 ** 6, temperature=0.0,
                                                    ignore_eos=True)))
    out = {}
    with torch.inference_mode():
        ctx._admit()
        torch.cuda.synchronize()
        n0 = len(ctx.rt[0].pending)
        t = time.perf_counter()
        if lone:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                chunks = 0
                while ctx.rt[0].pending:
                    ctx._prefill_step(0)
                    chunks += 1
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            by = {}
            for name, ms, cnt in device_kernels(prof):
                k = KERNEL_OF.get(name.split("<")[0], "other")
                tot, c = by.get(k, (0.0, 0))
                by[k] = (tot + ms, c + cnt)
            out["lone_prefill"] = {"tokens": n0, "chunks": chunks,
                                   "wall_ms_profiled": wall,
                                   "device_busy_ms": sum(ms for ms, _ in by.values()),
                                   "device_ms_launches": by}
        while any(r.pending for r in ctx.rt):
            for i, r in enumerate(ctx.rt):
                if r.pending:
                    ctx._prefill_step(i)
        for label, flag in modes:
            set_flash_decode(flag)
            out[label] = {"launch_counts_per_chunk": graph_against_eager(
                torch, ctx, n, ctx._kv_view_bucket(n))}
            for way in ways:
                ctx.cuda_graphs = way == "graph"
                out[label][way] = chunk_profile(torch, ctx, n)
            calls = out[label]["graph"]["runtime_launch_calls_per_step"]
            if calls.get("cudaGraphLaunch") != 1.0:
                raise AssertionError(f"server chunk {label}: a graph step made launch calls "
                                     f"{calls}, not one cudaGraphLaunch")
        ctx.cuda_graphs = True
        for i in range(ctx.n_slots):
            ctx._finish(i, "stop")
            ctx.memory.clear_slot(i)
    return out


def set_flash_decode(flag) -> None:
    """Kernel E's gate is read at each decode call: set or clear it."""
    if flag:
        os.environ["TPULLM_FLASH_DECODE"] = flag
    else:
        os.environ.pop("TPULLM_FLASH_DECODE", None)


CHAT_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the current weather in a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]


def phase_server_chat(torch, ctx, base, tok):
    """The text and chat part of the 8B server phase, on the running server
    (E on, slots cleared): /tokenize of a ~TOKENIZE_TOKENS-token English
    text against the in-process encode (the host's ms for both and tokens
    per second), /detokenize back to the text, /apply-template of a
    two-turn conversation against the in-process render; then, with the
    launch counts set to 0, a burst of 4 concurrent /v1/chat/completions of
    SERVER_NEW tokens, greedy: one streamed, one with a tools list, one
    with the stop string CHAT_STOP whose user message is a ~400-token
    excerpt (its prefill takes a 512-row chunk), one whose logit_bias makes
    <|eot_id|> the greedy choice. Every answer 200; each prompt_tokens the
    length of the in-process encode of the rendered template (tools
    injected where sent); each text the tokenizer's decode of the returned
    ids (``visible``), cut at the stop string; the forced end of turn
    finishes at once ("stop", no text, no tokens); A-E and the store
    launched. -> the burst's launch counts."""
    import threading

    from tpullm_torch.ops import _cuda
    from tpullm_torch.server.chat import apply_chat_template, get_template_src
    from tpullm_torch.server.toolcall import detect_format, inject_tools, parse_tool_calls

    report = {}
    text = english_text(tok, TOKENIZE_TOKENS, seed=5)
    enc_ms = []
    for _ in range(3):
        t = time.perf_counter()
        ids = tok.encode(text, add_special=False)
        enc_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    status, r = http_json(base + "/tokenize", {"content": text})
    http_ms = (time.perf_counter() - t) * 1e3
    if status != 200 or r["tokens"] != ids:
        raise AssertionError(f"/tokenize answered {status}, equal to encode: "
                             f"{status == 200 and r['tokens'] == ids}")
    t = time.perf_counter()
    status, d = http_json(base + "/detokenize", {"tokens": ids})
    detok_ms = (time.perf_counter() - t) * 1e3
    if status != 200 or d["content"] != text:
        raise AssertionError(f"/detokenize answered {status}: not the text back")
    report["tokenize"] = {"tokens": len(ids), "chars": len(text),
                          "host_encode_ms": sorted(enc_ms),
                          "host_tokens_per_s": len(ids) / (min(enc_ms) / 1e3),
                          "http_tokenize_ms": http_ms, "http_detokenize_ms": detok_ms}
    convo = [{"role": "system", "content": "You are a helpful assistant."},
             {"role": "user", "content": "Hello! Who are you?"},
             {"role": "assistant", "content": "I am an assistant. How can I help?"},
             {"role": "user", "content": "Tell me about the river in the city."}]
    status, r = http_json(base + "/apply-template", {"messages": convo})
    want = apply_chat_template(ctx, convo)
    if status != 200 or r["prompt"] != want or not want.startswith(
            "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n") or not \
            want.endswith("<|start_header_id|>assistant<|end_header_id|>\n\n"):
        raise AssertionError(f"/apply-template answered {status}: {r}")

    excerpt = tok.decode(ids[:400])
    eot = tok.vocab.eot_id
    kinds = ("streamed", "tools", "stop", "forced_eot")
    bodies = [
        {"messages": [{"role": "user", "content": "Write a short story about a fox."}],
         "stream": True},
        {"messages": [{"role": "user", "content": "What is the weather in Paris today?"}],
         "tools": CHAT_TOOLS},
        {"messages": [{"role": "system", "content": "Summarize the document."},
                      {"role": "user", "content": excerpt}], "stop": [CHAT_STOP]},
        {"messages": [{"role": "user", "content": "Say nothing at all."}],
         "logit_bias": {str(eot): 100.0}}]
    for b in bodies:
        b.update(max_tokens=SERVER_NEW, temperature=0.0)
    fmt = detect_format(get_template_src(ctx))
    want_prompt = [len(tok.encode(apply_chat_template(
        ctx, inject_tools(b["messages"], b["tools"], fmt) if "tools" in b else b["messages"],
        tools=b.get("tools")), add_special=True, parse_special=True)) for b in bodies]
    results = [None] * len(bodies)

    def one(i):
        results[i] = http_json(base + "/v1/chat/completions", bodies[i])

    torch.cuda.synchronize()
    _cuda.reset_counts()
    t = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t
    torch.cuda.synchronize()
    counts = dict(_cuda.COUNTS)
    rows = []
    for kind, body, n_prompt, (status, r) in zip(kinds, bodies, want_prompt, results):
        if status != 200:
            raise AssertionError(f"chat {kind}: answered {status}: {r}")
        if kind == "streamed":
            if any("error" in e for e in r):
                raise AssertionError(f"chat streamed: an error event: {r}")
            choice, stats = r[-1]["choices"][0], r[-1]["timings"]
            got = "".join(e["choices"][0]["delta"].get("content", "") for e in r)
        else:
            choice, stats = r["choices"][0], r["timings"]
            got = choice["message"]["content"]
        ids_out = choice["tokens"]
        want_text = visible(tok, ids_out, body.get("stop", ()))
        if kind == "tools" and choice["finish_reason"] == "tool_calls":  # a call's JSON
            want_text = parse_tool_calls(want_text, fmt)[0] or None
        ok = (stats["prompt_tokens"] == n_prompt and got == want_text
              and stats["completion_tokens"] == len(ids_out) <= SERVER_NEW)
        if kind == "stop":  # "length" only where neither the stop nor an end came
            ends = CHAT_STOP in visible(tok, ids_out) or len(ids_out) < SERVER_NEW
            ok = ok and choice["finish_reason"] == ("stop" if ends else "length")
        if kind == "forced_eot":
            ok = ok and choice["finish_reason"] == "stop" and got == "" and not ids_out
        if not ok:
            raise AssertionError(f"chat {kind}: check failed: prompt_tokens "
                                 f"{stats['prompt_tokens']} (want {n_prompt}), text "
                                 f"{got!r} (want {want_text!r}), finish "
                                 f"{choice['finish_reason']}, {len(ids_out)} ids")
        rows.append({"kind": kind, "prompt_tokens": stats["prompt_tokens"],
                     "completion_tokens": stats["completion_tokens"],
                     "finish_reason": choice["finish_reason"],
                     "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"]})
    report["chat_burst"] = {"requests": rows, "wall_s": wall,
                            "completion_tok_per_s": sum(x["completion_tokens"] for x in rows)
                            / wall}
    log(f"server slice 8B text and chat: {json.dumps(report)}")
    log(f"server slice 8B text and chat: launches in the chat burst {counts}")
    missing = [k for k in DENSE_KERNELS + ("flash_decode",) if counts[k] <= 0]
    if missing:
        raise AssertionError(f"server chat: kernels not launched {missing}")
    return counts


def phase_server(torch, cfg, params):
    """Phase 4b, the server slice on the 32-layer 8B model: ServerContext
    with 4 slots of 8192 and an int8 cache behind serve() on a free local
    port, its decode steps CUDA graph replays. With TPULLM_FLASH_DECODE=1
    (kernel E): a warm-up request, then, with the launch counts set to 0,
    the burst of SERVER_PROMPTS (2 wait for a slot) and a sequential pair
    on the idle server (both land in slot 0; the second prompt extends the
    first's prompt and completion and must reuse it), with A-E and the
    store kernel all launched. Then the same burst with the variable unset
    (the einsum path over dequantized views), and each way one decode chunk
    as graph replays against eager steps and its profile as graph replays
    (server_chunk_profile; the eager chunks' profiles, ~20 s of the
    profiler's host work, left out for the script's time). The server carries a
    byte-level BPE tokenizer at Llama-3's layout (synth_bpe_vocab(VOCAB)):
    the token-id requests send ignore_eos, and between the bursts and the
    profiles, with E on, the text and chat part runs (phase_server_chat).
    -> the launch counts of the E-on run and of the chat part."""
    import numpy as np
    import socket

    from tpullm_torch.ops import _cuda
    from tpullm_torch.server.context import ServerContext
    from tpullm_torch.server.http import serve
    from tpullm_torch.tokenizer import Tokenizer
    from tpullm_torch.utils.synth import synth_bpe_vocab

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in SERVER_PROMPTS]
    pair = rng.integers(0, VOCAB, 500).tolist()
    t = time.perf_counter()
    tok = Tokenizer(synth_bpe_vocab(VOCAB, seed=0))
    log(f"server slice 8B: synth_bpe_vocab({VOCAB}) and its tokenizer in "
        f"{time.perf_counter() - t:.3f} s ({len(tok.vocab.merges)} merges)")
    ctx = ServerContext(cfg, params, tok, n_slots=4, max_seq_len=8192, decode_chunk=8,
                        prefill_chunk=512, kv_dtype="q8", model_name="llama-3-8b-shape")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = f"http://127.0.0.1:{port}"
    modes = (("kernel E", "1"), ("einsum", None))
    set_flash_decode("1")
    srv = serve(ctx, "127.0.0.1", port, block=False)
    report = {}

    def clear_slots():  # no prefix reuse across bursts: each starts cold
        ctx.control(lambda: [ctx.memory.clear_slot(i) for i in range(ctx.n_slots)])

    secs, t0 = {}, time.perf_counter()  # the phase's wall time by part
    try:
        status, r = http_json(base + "/completion", {"prompt": prompts[-1], "max_tokens": 8,
                                                     "temperature": 0.0})
        if status != 200:
            raise AssertionError(f"server warm-up answered {status}: {r}")
        for label, flag in modes:
            set_flash_decode(flag)
            clear_slots()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = dict(ctx.metrics)
            _cuda.reset_counts()
            res, wall = server_burst(base, prompts, label, tok)
            if flag:  # the sequential pair, on the idle server
                status, first = http_json(base + "/v1/completions", {
                    "prompt": pair, "max_tokens": SERVER_NEW, "temperature": 0.0,
                    "ignore_eos": True})
                ext = pair + first["choices"][0]["tokens"] + [17, 23, 99]
                status2, second = http_json(base + "/v1/completions", {
                    "prompt": ext, "max_tokens": SERVER_NEW, "temperature": 0.0,
                    "ignore_eos": True})
                cached = second["timings"]["cached_tokens"] if status2 == 200 else None
                if (status, status2) != (200, 200) or not cached or cached < len(pair) or any(
                        x["usage"]["completion_tokens"] != SERVER_NEW for x in (first, second)):
                    raise AssertionError(f"server pair: {status} {status2}, cached {cached}")
                counts = dict(_cuda.COUNTS)
                report["pair"] = {"prompt_tokens": [len(pair), len(ext)],
                                  "cached_tokens": [first["timings"]["cached_tokens"], cached],
                                  "prefill_s": [first["timings"]["prefill_s"],
                                                second["timings"]["prefill_s"]]}
            torch.cuda.synchronize()
            gen = ctx.metrics["generated_tokens_total"] - m0["generated_tokens_total"]
            dec_s = ctx.metrics["decode_seconds_total"] - m0["decode_seconds_total"]
            report[label] = {
                "requests": [{k: v for k, v in x.items() if k != "ids"} for x in res],
                "burst_wall_s": wall,
                "burst_completion_tok_per_s": len(prompts) * SERVER_NEW / wall,
                "decode_tok_per_s": gen / dec_s if dec_s else None,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            report[label]["ids"] = [x["ids"] for x in res]
        ids_on, ids_off = report["kernel E"].pop("ids"), report["einsum"].pop("ids")
        # greedy requests: the first position where E on and off pick
        # different tokens (SERVER_NEW if none); after it the two continue
        # from different prefixes
        report["greedy_first_difference_e_on_off"] = [
            next((j for j, (a, b) in enumerate(zip(x, y)) if a != b), SERVER_NEW)
            if i != SERVER_SAMPLED else None for i, (x, y) in enumerate(zip(ids_on, ids_off))]
        secs["bursts"] = time.perf_counter() - t0
        set_flash_decode("1")
        clear_slots()
        chat_counts = phase_server_chat(torch, ctx, base, tok)
        secs["text_and_chat"] = time.perf_counter() - t0 - sum(secs.values())
        ctx.stop()  # the loop thread; the chunk profiles drive its body from here
        clear_slots()
        profs = server_chunk_profile(torch, ctx, prompts, modes, ("graph",))
        secs["chunk_profiles"] = time.perf_counter() - t0 - sum(secs.values())
        report["lone_prefill_profile"] = profs.pop("lone_prefill")
        report["seconds"] = secs
        for label, prof in profs.items():
            report[label]["decode_chunk_profile"] = prof
    finally:
        set_flash_decode(None)
        srv.shutdown()
        srv.server_close()
        ctx.stop()
    log(f"server slice 8B (4 slots x 8192, q8 KV, decode_chunk 8, prefill_chunk 512; "
        f"prompts {SERVER_PROMPTS}, {SERVER_NEW} new tokens each): {json.dumps(report)}")
    log(f"server slice 8B: launches with kernel E on (burst + pair) {counts}")
    missing = [k for k in DENSE_KERNELS + ("flash_decode",) if counts[k] <= 0]
    if missing:
        raise AssertionError(f"server slice: kernels not launched {missing}")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    return counts, chat_counts


QWEN_SERVER_PROMPTS = [2000, 700, 300, 40]  # the Qwen3 burst: 4 requests on 4 slots


def server_chats(base, ctx, tok, label, vocab):
    """The chat part of a server with a Qwen2-layout tokenizer (ChatML):
    /apply-template, then 2 concurrent chat completions: one greedy of 16
    tokens, and one whose logit_bias makes <|im_end|> the greedy choice,
    which must stop there at once ("stop", no text, no tokens); each
    prompt_tokens the in-process encode of the rendered template. ->
    {"requests": rows, "wall_s": s}."""
    import threading

    from tpullm_torch.server.chat import apply_chat_template

    convo = [{"role": "user", "content": "Hello! Who are you?"}]
    status, r = http_json(base + "/apply-template", {"messages": convo})
    want = apply_chat_template(ctx, convo)
    if status != 200 or r["prompt"] != want or want != (
            "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n<|im_start|>user"
            "\nHello! Who are you?<|im_end|>\n<|im_start|>assistant\n"):
        raise AssertionError(f"{label} /apply-template answered {status}: {r}")
    im_end = tok.vocab.eot_id
    bodies = [{"messages": [{"role": "user", "content": "Write a short story about a fox."}],
               "max_tokens": 16, "temperature": 0.0},
              {"messages": [{"role": "user", "content": "Say nothing at all."}],
               "max_tokens": 16, "temperature": 0.0, "logit_bias": {str(im_end): 100.0}}]
    want_prompt = [len(tok.encode(apply_chat_template(ctx, b["messages"]), add_special=True,
                                  parse_special=True)) for b in bodies]
    results = [None] * len(bodies)

    def one(i):
        results[i] = http_json(base + "/v1/chat/completions", bodies[i])

    t = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    chat_wall = time.perf_counter() - t
    rows = []
    for kind, n_prompt, (status, r) in zip(("greedy", "forced_im_end"), want_prompt, results):
        if status != 200:
            raise AssertionError(f"{label} chat {kind}: answered {status}: {r}")
        choice, stats = r["choices"][0], r["timings"]
        ids_out, got = choice["tokens"], choice["message"]["content"]
        ok = (stats["prompt_tokens"] == n_prompt and got == visible(tok, ids_out)
              and stats["completion_tokens"] == len(ids_out) <= 16
              and all(0 <= x < vocab for x in ids_out))
        if kind == "forced_im_end":
            ok = ok and choice["finish_reason"] == "stop" and got == "" and not ids_out
        if not ok:
            raise AssertionError(f"{label} chat {kind}: check failed: prompt_tokens "
                                 f"{stats['prompt_tokens']} (want {n_prompt}), text {got!r}, "
                                 f"finish {choice['finish_reason']}, {len(ids_out)} ids")
        rows.append({"kind": kind, "prompt_tokens": stats["prompt_tokens"],
                     "completion_tokens": stats["completion_tokens"],
                     "finish_reason": choice["finish_reason"],
                     "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"]})
    return {"requests": rows, "wall_s": chat_wall}


def phase_qwen_server(torch, cfg, params, label="Qwen3-8B",
                      must=DENSE_KERNELS + ("flash_decode",), prompts=QWEN_SERVER_PROMPTS,
                      new=SERVER_NEW):
    """The Qwen phases' server, on the 36-layer Qwen3-8B model (or the
    model of ``label``; the kernels of ``must`` launched):
    ServerContext (4 slots of 4096, int8 KV, decode_chunk 8, prefill_chunk
    512, its decode steps CUDA graph replays, kernel E on) with a byte-level
    BPE tokenizer at Qwen2's layout (synth_bpe_vocab(151936, layout="qwen2"),
    pre-type qwen2, ChatML) behind serve() on a free local port. With the
    launch counts set to 0: a burst of token-id completions of ``prompts``
    tokens (QWEN_SERVER_PROMPTS unless given; server_burst's checks: ``new``
    tokens each, SERVER_NEW unless given, the tokenizer's
    text, one streamed, one sampled), then /apply-template and 2 concurrent
    chat completions: one greedy of 16 tokens, and one whose logit_bias
    makes <|im_end|> the greedy choice, which must stop there at once
    ("stop", no text, no tokens); each prompt_tokens the in-process encode
    of the rendered template. A-E and the store launched (for Qwen3-8B).
    -> the launch counts."""
    import numpy as np
    import socket

    from tpullm_torch.ops import _cuda
    from tpullm_torch.server.context import ServerContext
    from tpullm_torch.server.http import serve
    from tpullm_torch.tokenizer import Tokenizer
    from tpullm_torch.utils.synth import synth_bpe_vocab

    vocab = cfg.vocab_size
    rng = np.random.default_rng(15)
    lens, prompts = prompts, [rng.integers(0, vocab, n).tolist() for n in prompts]
    t = time.perf_counter()
    tok = Tokenizer(synth_bpe_vocab(vocab, layout="qwen2"))
    log(f"server {label}: synth_bpe_vocab({vocab}, layout='qwen2') and its tokenizer in "
        f"{time.perf_counter() - t:.3f} s")
    ctx = ServerContext(cfg, params, tok, n_slots=4, max_seq_len=4096, decode_chunk=8,
                        prefill_chunk=512, kv_dtype="q8", model_name=label.lower() + "-shape")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = f"http://127.0.0.1:{port}"
    set_flash_decode("1")
    srv = serve(ctx, "127.0.0.1", port, block=False)
    report = {}
    try:
        status, r = http_json(base + "/completion", {"prompt": prompts[-1], "max_tokens": 8,
                                                     "temperature": 0.0})
        if status != 200:
            raise AssertionError(f"server {label} warm-up answered {status}: {r}")
        ctx.control(lambda: [ctx.memory.clear_slot(i) for i in range(ctx.n_slots)])
        torch.cuda.synchronize()
        _cuda.reset_counts()
        res, wall = server_burst(base, prompts, label, tok, vocab=vocab, new=new)
        report["burst"] = {"requests": [{k: v for k, v in x.items() if k != "ids"} for x in res],
                           "wall_s": wall,
                           "completion_tok_per_s": len(prompts) * new / wall}
        report["chat"] = server_chats(base, ctx, tok, label, vocab)
        torch.cuda.synchronize()
        counts = dict(_cuda.COUNTS)
    finally:
        set_flash_decode(None)
        srv.shutdown()
        srv.server_close()
        ctx.stop()
    log(f"server {label} (4 slots x 4096, q8 KV, decode_chunk 8, prefill_chunk 512, kernel E; "
        f"prompts {lens}, {new} new tokens each; 2 chats): "
        f"{json.dumps(report)}")
    log(f"server {label}: launches (burst + chat) {counts}")
    missing = [k for k in must if counts[k] <= 0]
    if missing:
        raise AssertionError(f"server {label}: kernels not launched {missing}")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_qwen(torch):
    """Phase 9, the dense decoder's flags at full width: the 2-layer
    Qwen3-8B parity (per-head QK norms, untied 151936-row lm_head) and a
    2-layer run at Qwen2.5-7B's width (q/k/v biases, GQA group 7, no kernel
    D, kernel E on in its decode steps) against the CPU (phase 3's rule);
    then the 36-layer Qwen3-8B model: the slice (4 requests, prefill 4x512,
    decode as graph replays, graph and eager greedy tokens equal from the
    same generator state, A-D and the store launched) with phase 5's
    decode-step profile as graph replays, and its server. -> launch counts
    by path."""
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    counts = {}
    t = time.perf_counter()
    phase_parity(torch, "Qwen3-8B", seed=9, **dict(QWEN3, n_layer=2))
    log(f"phase parity Qwen3-8B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Qwen2.5-7B"] = c = phase_parity(
        torch, f"Qwen2.5-7B (depth cut from {QWEN25['n_layer']})", seed=10, flash_decode="1",
        **dict(QWEN25, n_layer=QWEN25_LAYERS))
    missing = [k for k in ("qmm_splitk", "qmm", "flash_attention", "kv_store", "flash_decode")
               if c[k] <= 0]
    if missing or c["layer_kernel"]:
        raise AssertionError(f"Qwen2.5-7B run: kernels not launched {missing}, layer kernel "
                             f"{c['layer_kernel']} (the bias archs take no kernel D)")
    log(f"phase parity Qwen2.5-7B width: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_kmajor_q4k_fast(**QWEN3, seed=0, centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"slice Qwen3-8B: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} rope {cfg.rope_type} "
        f"base {cfg.rope_base:g} eps {cfg.rms_eps:g} qk_norm {cfg.attn_qk_norm}")
    counts["Qwen3-8B"], eng, eager, prompts = phase_slice(torch, "Qwen3-8B", cfg, params,
                                                          QWEN3["vocab_size"], DENSE_KERNELS)
    phase_decode(torch, eng, prompts, " Qwen3-8B graph")
    del eng, eager
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice Qwen3-8B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Qwen3-8B server"] = phase_qwen_server(torch, cfg, params)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase server Qwen3-8B: {time.perf_counter() - t:.1f} s")
    return counts


def skip_row(torch, timer, entries, name, qt, layer, M, g, used=8, path="Qwen3-30B-A3B"):
    """One row of A's expert-skip variant on ``layer`` of the (L, E) stack
    qt, M decode rows routed top-``used`` of E at random (a seed): the gate/up
    form (``qmm_experts``, x shared by the slots) or, for down, the
    combining form (``experts_combine``, each slot's own rows, folded with
    the routing). Held bit for bit against A called on each listed expert
    (and, for down, the loop's ``out + de * we`` in expert order), and
    against the plain version (NMSE); timed beside the plain version, that
    per-expert A loop over the listed experts and A over all E experts (the
    path before the skip; both Python loops of A calls, so host-dispatched:
    the in-graph cost of the loop is the decode profiles' device ms) and one
    library call over the listed experts pre-dequantized: torch.bmm for
    gate/up (products only), for down the combining torch.einsum
    ('smk,snk,sm->mn': out = sum over slots of we_s * (h_s @ W_s^T)). The
    bound reads the listed experts' weights, x and the routing once and
    writes the output once. Logged beside it: the f32 slabs the call writes
    and reads, and the card memory the call takes above what was allocated
    before it (peak)."""
    from tpullm_torch.models.llama import expert_weight
    from tpullm_torch.ops.moe_decode import (expert_slots, experts_combine,
                                             experts_combine_plain, partial_bytes, qmm_experts,
                                             qmm_experts_plain)
    from tpullm_torch.ops.qmm import qmm_kmajor
    from tpullm_torch.quant.kmajor import dequant_kmajor_torch

    E, N, K = qt.data["q"].shape[-3], qt.n_out, qt.shape[-1]
    top_i = torch.rand((M, E), generator=g, device="cuda").argsort(-1)[:, :used]
    w = torch.rand((M, used), generator=g, device="cuda") + 0.1
    w = w / w.sum(-1, keepdim=True)
    ids = expert_slots(top_i, E)
    listed = [e for e in ids.tolist() if e >= 0]
    cap, n = ids.shape[0], len(listed)
    bf = torch.bfloat16
    one = lambda x, e: qmm_kmajor(x, expert_weight(qt, layer, e).data, qt.qtype, N, bf)
    combine = name == "down"
    if combine:
        x = torch.randn((cap, M, K), generator=g, device="cuda").to(bf)
        run = lambda: experts_combine(x, qt, layer, ids, top_i, w)
        plain = lambda: experts_combine_plain(x, qt, layer, ids, top_i, w)

        def loop(experts=listed):
            out = torch.zeros((M, N), dtype=bf, device="cuda")
            for slot, e in enumerate(experts):
                we = (w * (top_i == e)).sum(-1)[:, None].to(bf)
                out = out + one(x[min(slot, cap - 1)], e) * we
            return out

        kernels = ("qmm_experts_kernel", "qmm_experts_combine")
        io_bytes = x[:n].nbytes + M * N * 2 + top_i.nbytes + w.nbytes
    else:
        x = torch.randn((M, K), generator=g, device="cuda").to(bf)
        run = lambda: qmm_experts(x, qt, layer, ids)
        plain = lambda: qmm_experts_plain(x, qt, layer, ids)

        def loop(experts=listed):
            return torch.stack([one(x, e) for e in experts])

        kernels = ("qmm_experts_kernel", "qmm_experts_reduce")
        io_bytes = x.nbytes + n * M * N * 2
    got, want = run(), plain()
    same = bool(torch.equal(got, run()))
    ref = loop()
    bitwise = bool(torch.equal(got if combine else got[:n], ref))
    torch.cuda.synchronize()
    err = nmse(torch, got, want)
    mae = float((got.float() - want.float()).abs().max())
    w_bytes = sum(weight_bytes(expert_weight(qt, layer, e)) for e in listed)
    bound, by = bound_of(w_bytes + io_bytes, 2.0 * M * N * K * n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    slabs_mb = partial_bytes(qt, K, M, cap) / 1e6
    ms = timer(run, 20)
    pms = timer(plain, 3, warmup=1)
    loop_ms = timer(loop, 5)
    all_ms = timer(lambda: loop(list(range(E))), 3, warmup=1)
    wd = torch.stack([dequant_kmajor_torch(expert_weight(qt, layer, e).data, qt.qtype,
                                           bf)[:N] for e in listed])
    if combine:
        sel = torch.tensor(listed, device="cuda")
        we = (w[None] * (top_i[None] == sel[:, None, None])).sum(-1).to(bf)  # (n, M)
        hs = x[:n]
        library = "torch.einsum('smk,snk,sm->mn') over the listed experts pre-dequantized"
        lib = lambda: torch.einsum("smk,snk,sm->mn", hs, wd, we)
    else:
        library = "torch.bmm over the listed experts pre-dequantized"
        lib = lambda: torch.bmm(x.expand(n, M, K), wd.transpose(1, 2))
    lib_err = nmse(torch, lib(), got if combine else got[:n])
    lms = timer(lib, 10)
    del wd
    split = launch_split(torch, timer, run, kernels)
    label = (f"qmm_experts[{name} {N}x{K},{qt.qtype.name},M={M},{n} of {E} experts "
             f"(capacity {cap}),layer {layer}]")
    log(f"kernel {label}: nmse {err:.3e} (tol {TOL_QMM_NMSE:g}) repeat identical {same} "
        f"== per-expert A loop bit for bit {bitwise} max_abs_err {mae:.4g} ms {ms:.4f} "
        f"plain_ms {pms:.4f} host-dispatched A loop: listed_ms {loop_ms:.4f} all_{E}_ms "
        f"{all_ms:.4f} library_ms {lms:.4f} (nmse against the kernel {lib_err:.3e}) "
        f"bound_ms {bound:.4f} ({by}) share_of_bound {bound / ms:.3f} f32 slabs "
        f"{slabs_mb:.2f} MB peak {peak_mb:.2f} MB"
        + "".join(f" {k}_ms {v:.4f}" for k, v in split.items()))
    if not (err < TOL_QMM_NMSE and same and bitwise):
        raise AssertionError(f"{label}: nmse {err} (tol {TOL_QMM_NMSE}), repeat identical "
                             f"{same}, equal to the per-expert A loop {bitwise}")
    entries.append(dict(
        name=label, route="cuda", source=SOURCES["qmm_experts"][0],
        replaces=SOURCES["qmm_experts"][1], kernel="qmm_experts", path=path, max_abs_err=mae,
        ms=ms, plain_ms=pms, library_ms=lms, library=library, bound_ms=bound, bound_by=by,
        host_loop_listed_ms=loop_ms, host_loop_all_ms=all_ms, slabs_mb=slabs_mb,
        peak_mb=peak_mb, device_ms=split))


def phase_qwen_moe_kernels(torch, entries, cfg, params):
    """Phase 10's kernel rows, on the 48-layer Qwen3-30B-A3B model's own
    weights (the last layer of its (48, 128) stacks): A's expert-skip
    variant on gate (N 768, K 2048, Q4_K) and down (N 2048, K 768, Q6_K,
    combining) at M = 1, 4 (a server step of 4 slots) and 16 (the top of
    the skip's range: capacity 128, the most f32 slabs); kernel F at 128
    experts on the slice's prefill (4 prompts bucketed to 512 = 2048 tokens,
    top-8: 16384 assignments); kernel C at G = 8 on that prefill's shape and
    kernel E at G = 8 on the server's decode step (int8 K/V, 4 slots of 4096)
    and the engine's (bf16, a 1024-slot view)."""
    from tpullm_torch.ops import _cuda
    from tpullm_torch.ops.moe_gmm import live_tiles, sort_by_expert

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1616)
    lay, li = params["layers"], cfg.n_layer - 1
    for M in (1, 4, 16):
        skip_row(torch, timer, entries, "gate", lay["moe_gate_exps"], li, M, g)
        skip_row(torch, timer, entries, "down", lay["moe_down_exps"], li, M, g)
    E, used, M = cfg.n_expert, cfg.n_expert_used, 2048
    top_i = torch.rand((M, E), generator=g, device="cuda").argsort(-1)[:, :used]
    order, dest, te, Mp = sort_by_expert(top_i, E, M)
    live = live_tiles(dest, te, Mp)
    for name, qt in (("gate", lay["moe_gate_exps"]), ("down", lay["moe_down_exps"])):
        K = qt.shape[-1]
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        xs = torch.zeros((Mp, K), dtype=torch.bfloat16, device="cuda")
        xs[dest] = x[order // used]
        gmm_row(torch, timer, entries, f"{name} of layer {li}", qt, li, xs, te, live, M * used,
                "Qwen3-30B-A3B")
        del x, xs
    heads = (cfg.n_head, cfg.n_head_kv)
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
             path="Qwen3-30B-A3B", heads=heads)
    decode_row(torch, timer, entries, g, "Qwen3-30B-A3B server", 4096, [2000, 700, 300, 40],
               [0, 0, 0, 0], True, heads=heads, path="Qwen3-30B-A3B server")
    decode_row(torch, timer, entries, g, "Qwen3-30B-A3B engine", 1024, [527] * 4,
               [0, 212, 312, 412], False, heads=heads, path="Qwen3-30B-A3B")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_qwen_moe(torch, entries):
    """Phase 10, the Qwen MoE archs at full width: the 1-layer Qwen3-30B-A3B
    and Qwen2-57B-A14B-width parities (phase 6's rule and routing
    count; the shared expert, its gate and the biases in the second); then the 48-layer
    Qwen3-30B-A3B model: its kernel rows (phase_qwen_moe_kernels), the slice
    (4 requests, graph replays, then eagerly: the same tokens and launch
    counts; A, B, C, F, the store and the skip launched, D not), phase 5's
    decode-step profile as graph replays (the hand-written kernels a step
    fixed whatever E is: 3 skip launches a layer) and a prefill profile;
    then its server (4 slots of 4096, int8 KV, kernel E, the Qwen2-layout
    tokenizer) with 4 token-id completions and 2 chats, one stopped at
    <|im_end|>. -> launch counts by path."""
    counts = {}
    t = time.perf_counter()
    counts[f"Qwen3-30B-A3B {ONE_LAYER}-layer"] = phase_moe_parity(
        torch, f"Qwen3-30B-A3B (depth cut from {QWEN3MOE['n_layer']})", QWEN3MOE, seed=11,
        n_layer=ONE_LAYER)
    log(f"phase parity Qwen3-30B-A3B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"Qwen2-57B-A14B {ONE_LAYER}-layer"] = phase_moe_parity(
        torch, f"Qwen2-57B-A14B (depth cut from {QWEN2MOE['n_layer']})", QWEN2MOE, seed=12,
        n_layer=ONE_LAYER)
    log(f"phase parity Qwen2-57B-A14B width: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_moe(QWEN3MOE, n_layer=slice_depth("Qwen3-30B-A3B", QWEN3MOE["n_layer"]),
                            seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"slice Qwen3-30B-A3B: synthesized Q4_K kmajor weights (Q6_K down experts) "
        f"{model_gb(params):.3f} GB in {time.perf_counter() - t:.3f} s; config {cfg.arch} "
        f"head_dim {cfg.head_dim} experts {cfg.n_expert} top-{cfg.n_expert_used} of "
        f"{cfg.n_ff_exp} renorm {cfg.expert_weights_norm} qk_norm {cfg.attn_qk_norm}")
    t = time.perf_counter()
    phase_qwen_moe_kernels(torch, entries, cfg, params)
    log(f"phase kernels Qwen3-30B-A3B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Qwen3-30B-A3B"], eng, eager, prompts = phase_slice(
        torch, "Qwen3-30B-A3B", cfg, params, cfg.vocab_size, MOE_KERNELS, ("layer_kernel",))
    out = phase_decode(torch, eng, prompts, " Qwen3-30B-A3B graph")
    step = out["graph_capture_counts_per_step"] or {}
    want = {"qmm_experts": 3 * cfg.n_layer, "qmm_splitk": 2 * cfg.n_layer + 1}
    if {k: step.get(k) for k in want} != want:
        raise AssertionError(f"Qwen3-30B-A3B decode step: launches {step}, want {want} "
                             "(one skip launch a projection a layer, whatever E is)")
    phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "moe_gmm"),
                          " Qwen3-30B-A3B")
    del eng, eager
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice Qwen3-30B-A3B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Qwen3-30B-A3B server"] = phase_qwen_server(torch, cfg, params, "Qwen3-30B-A3B",
                                                       MOE_SERVER_KERNELS)
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase server Qwen3-30B-A3B: {time.perf_counter() - t:.1f} s")
    return counts


def phase_gemma_kernels(torch, entries):
    """Phase 2's rows at the Gemma phase's shapes (phase 11), each held
    against its plain version and timed: kernels A (M = 4) and B (M = 2048)
    on Gemma-2-9B's wqkv (8192 x 3584), gate/up (28672 x 3584), down
    (3584 x 14336) and the tied 256000-row lm_head, Q4_K; kernel C at head
    dim 256 with Gemma-2's softcap of 50 at the engine slice's prefill (B
    4, T 512, S 1024, 16/8 heads) with no window and with a window of 256,
    and at the server's last chunk of its 6000-token prompt (query slots
    5632-6143 over an 8192-slot view, window 4096); kernel E at Gemma-2-9B's
    decode shapes with the softcap: the server's int8 step (rows at
    6000/2000/700/40 of 8192, the 4096 window biting on the deepest) and the
    engine's bf16 step; the KV store at 8 kv heads of 256, bit for bit, at
    the server's decode step and 512-row chunk and the engine's decode step;
    kernel D with gelu at Gemma-7B's layer (3072 wide, 16/16 heads of 256,
    n_ff 24576), M = 4, plain and folded."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1717)
    gm = GEMMA2
    d, hd, nq, nkv = gm["n_embd"], gm["head_dim"], gm["n_head"], gm["n_head_kv"]
    heads = (nq, nkv)
    weight_rows(torch, timer, entries, g, [("wqkv", [nq * hd, nkv * hd, nkv * hd], d),
                                           ("gateup", [gm["n_ff"]] * 2, d),
                                           ("down", [d], gm["n_ff"]),
                                           ("lm_head", [gm["vocab_size"]], d)], "Gemma-2-9B")
    for window in (0, GEMMA_PARITY_WINDOW):
        attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
                 path="Gemma-2-9B", heads=heads, hd=hd, softcap=50.0, window=window)
    attn_row(torch, timer, entries, g, B=1, T=512, S=8192, n_past=5632, vf=[0],
             path="Gemma-2-9B server", heads=heads, hd=hd, softcap=50.0, window=4096)
    decode_row(torch, timer, entries, g, "Gemma-2-9B server", 8192, [6000, 2000, 700, 40],
               [0, 0, 0, 0], True, heads=heads, path="Gemma-2-9B server", hd=hd,
               softcap=50.0, window=4096)
    decode_row(torch, timer, entries, g, "Gemma-2-9B engine", 1024, [527] * 4,
               [0, 212, 312, 412], False, heads=heads, path="Gemma-2-9B", hd=hd,
               softcap=50.0, window=4096)
    store_row(torch, timer, entries, g, "Gemma-2-9B server decode", "Gemma-2-9B server", 1,
              [6000, 2000, 700, 40], 0, 8192, True, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "Gemma-2-9B server prefill chunk", "Gemma-2-9B server",
              512, [5632], 2, 8192, True, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "Gemma-2-9B engine decode", "Gemma-2-9B", 1,
              [ENGINE_DECODE_SLOT] * 4, 0, 1024, False, heads=heads, hd=hd)
    g7 = GEMMA7B
    layer_rows(torch, timer, entries, g, n_ff=g7["n_ff"], path="Gemma-7B", d=g7["n_embd"],
               heads=(g7["n_head"], g7["n_head_kv"]), hd=g7["head_dim"], act="gelu")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


SERVER_KERNELS = ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store")


def phase_q8_server(torch, cfg, params, label="Gemma-2-9B", server_prompts=None,
                    kv_dtype="q8", n_ctx=8192, must=(), kernels=SERVER_KERNELS,
                    must_not=("layer_kernel",), decode_chunk=8, new=SERVER_NEW, tok=None):
    """Phases 11c, 13c, 14d and 15d (Gemma-2-9B, Command-R 35B,
    StarCoder-15B, ERNIE-4.5-21B-A3B): the model behind serve() on a free
    local port: ServerContext with 4 slots of ``n_ctx`` (8192; ERNIE's
    4096), an int8 cache (``kv_dtype``: or bf16, the CLI's default
    without --kv-type q8), no tokenizer (token-id prompts; the text is the ids),
    iswa=False (on a model with SWA layers, the CLI's --swa-full:
    full-context KV on every layer), kernel E on, each
    decode step a CUDA graph replay. With the launch counts set to 0, a
    burst of ``server_prompts`` (GEMMA_SERVER_PROMPTS by default: the
    6000-token prompt past Gemma-2's 4096 window, in C's 512-row chunks and
    in E's steps), 64 new tokens each: every request answered 200 with its
    64 tokens; A, B, C, E and the store launched, and those of ``must``
    (ERNIE's: F and the skip), D not (Gemma-2's post-norms close it,
    Command-R's and StarCoder's layernorm, ERNIE's experts). Then, with the loop stopped
    and the prompts prefilled anew, one decode chunk as graph replays
    against eager steps, then profiled as graph replays
    (server_chunk_profile): device ms a step and the busy share. The
    6000-token prefill's profile and the eager chunk's are left out for the
    script's time limit (the profiler's host work on tens of thousands of
    launches). ``kernels`` and ``must`` must launch in the burst and
    ``must_not`` not (DeepSeek-V2-Lite's MLA: A, B and the store; not C, D
    or E); ``decode_chunk`` is the server's (its chunk is the profiled
    one); ``new`` the tokens a request (DeepSeek-V2-Lite's 32, cut for the
    script's time limit). With ``tok`` (a Qwen2-layout tokenizer: phase
    21's) the server has it, the burst's checks read its text, and 2 chats
    follow the burst (server_chats), counted with it. -> the launch counts
    of the burst."""
    import numpy as np
    import socket

    from tpullm_torch.ops import _cuda
    from tpullm_torch.server.context import ServerContext
    from tpullm_torch.server.http import serve

    vocab = cfg.vocab_size
    server_prompts = server_prompts or GEMMA_SERVER_PROMPTS
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, vocab, n).tolist() for n in server_prompts]
    ctx = ServerContext(cfg, params, tok, n_slots=4, max_seq_len=n_ctx,
                        decode_chunk=decode_chunk, prefill_chunk=512, kv_dtype=kv_dtype,
                        iswa=False,
                        model_name=label.lower() + "-shape")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = f"http://127.0.0.1:{port}"
    set_flash_decode("1")
    srv = serve(ctx, "127.0.0.1", port, block=False)
    report = {}
    try:
        status, r = http_json(base + "/completion", {"prompt": prompts[-1], "max_tokens": 8,
                                                     "temperature": 0.0})
        if status != 200:
            raise AssertionError(f"server {label} warm-up answered {status}: {r}")
        ctx.control(lambda: [ctx.memory.clear_slot(i) for i in range(ctx.n_slots)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = dict(ctx.metrics)
        _cuda.reset_counts()
        res, wall = server_burst(base, prompts, label, tok, vocab=vocab, new=new)
        if tok is not None:
            report["chat"] = server_chats(base, ctx, tok, label, vocab)
        torch.cuda.synchronize()
        counts = dict(_cuda.COUNTS)
        gen = ctx.metrics["generated_tokens_total"] - m0["generated_tokens_total"]
        dec_s = ctx.metrics["decode_seconds_total"] - m0["decode_seconds_total"]
        report["burst"] = {
            "requests": [{k: v for k, v in x.items() if k != "ids"} for x in res],
            "burst_wall_s": wall, "burst_completion_tok_per_s": len(prompts) * new / wall,
            "decode_tok_per_s": gen / dec_s if dec_s else None,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        ctx.stop()  # the loop thread; the chunk profile drives its body from here
        for i in range(ctx.n_slots):
            ctx.memory.clear_slot(i)
        report["decode_chunk_profile"] = server_chunk_profile(
            torch, ctx, prompts, (("kernel E", "1"),), ("graph",), lone=False)["kernel E"]
    finally:
        set_flash_decode(None)
        srv.shutdown()
        srv.server_close()
        ctx.stop()
    swa = ", iswa off (--swa-full)" if cfg.sliding_window else ""
    kv = "q8" if kv_dtype == "q8" else str(kv_dtype).replace("torch.", "")
    log(f"server {label} (4 slots x {n_ctx}, {kv} KV{swa}, decode_chunk {decode_chunk}, "
        f"prefill_chunk 512, kernel E; prompts {server_prompts}, {new} new tokens "
        f"each): {json.dumps(report)}")
    log(f"server {label}: launches (burst) {counts}")
    missing = [k for k in tuple(kernels) + tuple(must) if counts[k] <= 0]
    extra = [k for k in must_not if counts[k]]
    if missing or extra:
        raise AssertionError(f"server {label}: kernels not launched {missing}, launched but "
                             f"off this model's path {extra}")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def route_counter(routes: dict, key):
    """A stand-in for models/llama.py:attention_route (patched in with
    mock.patch.object) that adds one to routes[key(args, route)] for each
    call, where key gives a key (None: not counted)."""
    import tpullm_torch.models.llama as llama

    real = llama.attention_route

    def counted(*a, **kw):
        r = real(*a, **kw)
        k = key(a + tuple(kw.values()), r)
        if k is not None:
            routes[k] = routes.get(k, 0) + 1
        return r

    return counted


def phase_gemma(torch, entries):
    """Phase 11, the gemma family at full width (gelu, the embedding scale,
    logit softcaps, sliding windows every other or 5 of 6 layers, tied
    lm_heads, head dim 256 through kernels C and E): (a) the parity against
    the CPU (phase 3's rule) of Gemma-7B's width with 2 layers (no window;
    prompts of 128 and 100: kernel D with gelu, folded, in its decode
    steps; Gemma-2-9B's and Gemma-3-4B's full-cache parities run in phase
    12 beside the ring's, on the same tokens); then the kernel rows
    (phase_gemma_kernels); (b) the 42-layer Gemma-2-9B model's engine slice
    with TPULLM_FLASH_DECODE=1 (A, B, C, E and the store launched, D not;
    every prefill attention call routed to C, none to the einsum path, C
    launched once a layer for the counted run's one prefill) and its
    decode-step profile as graph replays; (c) its server
    (phase_q8_server); then phase 12 on the same weights
    (phase_gemma_ring). -> launch counts by path."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    counts = {}
    win = GEMMA_PARITY_WINDOW
    # (label, spec, depth, config fields, TPULLM_FLASH_DECODE, seed, prompts, S); the
    # Gemma-2-9B and Gemma-3-4B-width parities on the full cache run beside the
    # ring's, on the same tokens (phase 12, phase_ring_parity)
    runs = (("Gemma-7B width", GEMMA7B, 2, None, None, 15, (128, 100), 256),)
    for label, spec, n_layer, fields, flag, seed, lens, S in runs:
        t = time.perf_counter()
        c = phase_parity(torch, f"{label} (depth cut from {spec['n_layer']}"
                         + (f", window cut to {win})" if fields else ")"), seed=seed,
                         flash_decode=flag, lens=lens, S=S, last_only=True,
                         **dict(spec, n_layer=n_layer, cfg_fields=fields))
        # the layer kernel's rows at Gemma-7B's layer take this run's launches
        counts["Gemma-7B" if spec is GEMMA7B else f"{label} {n_layer}-layer"] = c
        want = ["qmm_splitk", "qmm", "flash_attention", "kv_store"] + (
            ["flash_decode"] if flag else ["layer_kernel"])
        missing = [k for k in want if c[k] <= 0]
        if missing or (flag and c["layer_kernel"]):
            raise AssertionError(f"{label} parity: kernels not launched {missing}, layer "
                                 f"kernel {c['layer_kernel']}")
        log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_gemma_kernels(torch, entries)
    log(f"phase kernels Gemma: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_kmajor_q4k_fast(**GEMMA2, seed=0, centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"slice Gemma-2-9B: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} head_dim {cfg.head_dim} act "
        f"{cfg.act_fn} embedding_scale {cfg.embedding_scale:.4f} softcaps "
        f"{cfg.attn_logit_softcap:g}/{cfg.final_logit_softcap:g} windows "
        f"{llama.layer_windows(cfg)[:4]}... tied {cfg.tie_embeddings}")
    routes = {}
    counted_route = route_counter(routes, lambda a, r: ("prefill" if a[2] > 1 else "decode", r))
    set_flash_decode("1")
    try:
        with mock.patch.object(llama, "attention_route", counted_route):
            counts["Gemma-2-9B"], eng, eager, prompts = phase_slice(
                torch, "Gemma-2-9B", cfg, params, cfg.vocab_size,
                ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store"),
                ("layer_kernel",))
        log(f"slice Gemma-2-9B: attention routes of every call (prefill or decode, route) "
            f"{ {f'{a} {b}': n for (a, b), n in routes.items()} }")
        if set(r for (kind, r) in routes if kind == "prefill") != {"flash_attention"}:
            raise AssertionError(f"Gemma-2-9B prefill: attention routes {routes}")
        if counts["Gemma-2-9B"]["flash_attention"] != cfg.n_layer:
            raise AssertionError(f"Gemma-2-9B slice: kernel C launched "
                                 f"{counts['Gemma-2-9B']['flash_attention']} times for one "
                                 f"prefill of {cfg.n_layer} layers")
        phase_decode(torch, eng, prompts, " Gemma-2-9B graph")
    finally:
        set_flash_decode(None)
    del eng, eager
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice Gemma-2-9B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Gemma-2-9B server"] = phase_q8_server(torch, cfg, params)
    log(f"phase server Gemma-2-9B: {time.perf_counter() - t:.1f} s")
    counts.update(phase_gemma_ring(torch, entries, cfg, params))
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# the iSWA ring server (phase 12): Gemma-2-9B on 4 slots of 16384, bf16 KV, the
# SWA layers on a ring of window 4096 + prefill_chunk 512 = 4608 slots
RING_CTX, RING_CHUNK = 16384, 512
RING_SERVER_PROMPTS = [12000, 6000, 2000, 40]  # the burst; the 12000 wraps the ring
RING_FOLLOW = 200  # the follow-up's own tokens after the 12000-token prefix
# the parity runs: the window cut to 256 and prefill_chunk 128 (a ring of 384),
# prompts of 896 and 500 tokens, so the longer wraps the ring twice (and the
# full cache's one-piece prefill of 896 = 7 x 128 rows takes kernel C)
RING_PARITY_CHUNK, RING_PARITY_LENS = 128, (896, 500)


def phase_ring_kernels(torch, entries):
    """Phase 12a: the ring rows at Gemma-2-9B's heads (16/8 of 256), each
    held against its plain version and timed beside the plain version, one
    library call and the bound: the store with wrap (bf16 ring of 4608
    slots, a 512-row chunk at positions 8960-9471, ring slots 4352-4607 then
    0-255, cache row 2 of 4; bit for bit, beside one ``index_put_`` a bank);
    kernel E on the ring (4 rows at positions 12000/6000/2000/40, softcap
    50, window 4096; library: flex_attention with the ring mask and the
    softcap); kernel C on the ring (B 1, T 512 at positions 11488-11999,
    window 4096, softcap 50; and at head dim 128 with Llama-3-8B's heads,
    no softcap: SDPA with the ring mask)."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1818)
    gm = GEMMA2
    heads, hd, win = (gm["n_head"], gm["n_head_kv"]), gm["head_dim"], 4096
    ring = win + RING_CHUNK
    path = "Gemma-2-9B ring server"
    store_row(torch, timer, entries, g, "Gemma-2-9B ring prefill chunk across the ring's end",
              path, 512, [2 * ring - 256], 2, ring, False, heads=heads, hd=hd, ring=ring)
    decode_row(torch, timer, entries, g, "Gemma-2-9B ring server", ring, RING_SERVER_PROMPTS,
               [0, 0, 0, 0], False, heads=heads, path=path, hd=hd, softcap=50.0, window=win,
               ring=ring)
    attn_row(torch, timer, entries, g, B=1, T=512, S=ring, n_past=11488, vf=[0], path=path,
             heads=heads, hd=hd, softcap=50.0, window=win, ring=ring)
    attn_row(torch, timer, entries, g, B=1, T=512, S=ring, n_past=11488, vf=[0], path=path,
             window=win, ring=ring)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_ring_parity(torch, label, spec, n_layer, fields, seed, lens=RING_PARITY_LENS,
                      chunk=RING_PARITY_CHUNK, layer_kernel=False):
    """Phase 12b (and 17b): the iSWA ring at full width with the depth and
    the window cut (phase 3's rule): the ring engine's path on the card (a
    dual cache, the window cut to 256, prefill in chunks of ``chunk``
    (RING_PARITY_CHUNK): a ring of 384 slots) on 2 prompts of ``lens``
    (RING_PARITY_LENS) tokens (left-padded, the 896 wrapping the ring twice)
    and PARITY_STEPS greedy decode steps with
    TPULLM_FLASH_DECODE=1, against the plain path on a CPU copy in f32 on
    the full cache, teacher-forced with the card's picks; the card's
    full-cache path (phase 11's parity: its prefill in one piece through
    C, its decode through E) on the same tokens within the same bound of
    the CPU and of the ring's logits. Every ring-layer attention call on
    the card goes to kernel C (prefill) or E (decode). The layer kernel
    launches in both runs' decode steps where ``layer_kernel`` says so (the
    Phi-4 layer), and in neither otherwise (Gemma's post-norms close it).
    -> the launch counts of the ring run and of the full-cache run."""
    import numpy as np
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.ops import _cuda
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    sp = dict(spec, n_layer=n_layer, cfg_fields=fields)
    sp.setdefault("generator", torch.Generator(device="cuda").manual_seed(seed))
    cfg, params = synth_kmajor_q4k_fast(**sp, seed=seed, centred=True, device="cuda")
    cpu = plain_cpu_copy(torch, params)
    rng = np.random.default_rng(5)
    B, T, C = len(lens), max(lens), chunk
    S = 1280  # a multiple of 256 past the prompts and 4 steps: C and E on the full banks
    tok = np.zeros((B, T), np.int64)
    posn = np.zeros((B, T), np.int64)
    for b, n in enumerate(lens):
        tok[b, T - n:] = rng.integers(0, cfg.vocab_size, n)
        posn[b, T - n:] = np.arange(n)
    vf = np.asarray([T - n for n in lens], np.int64)
    sides = {}
    for name, dev, dtype, iswa in (("ring", "cuda", torch.bfloat16, True),
                                   ("full", "cuda", torch.bfloat16, False),
                                   ("cpu", "cpu", torch.float32, False),
                                   ("cpu_bf16", "cpu", torch.bfloat16, False)):
        sides[name] = dict(p=params if dev == "cuda" else cpu, dev=dev, dtype=dtype,
                           cache=KVCache.create(cfg, B, S, dtype, dev, iswa=iswa,
                                                max_chunk=C),
                           vf=torch.from_numpy(vf).to(dev))
    ring = sides["ring"]["cache"].ring
    if not sides["ring"]["cache"].dual or ring != fields["sliding_window"] + C:
        raise AssertionError(f"{label} ring parity: no dual cache ({ring})")
    routes = {}  # the calls on a ring bank (attention_route's 10th argument)
    counted_route = route_counter(routes, lambda a, r: (
        "prefill" if a[2] > 1 else "decode", r) if len(a) > 9 and a[9] else None)

    errs, full_errs, ring_full, ref_errs = [], [], [], []
    counts = {"ring": {}, "full": {}}
    cur = {n: (torch.from_numpy(tok), torch.from_numpy(posn)) for n in sides}
    slot, T_step = 0, T
    try:
        with torch.inference_mode(), mock.patch.object(llama, "attention_route", counted_route):
            for step in range(PARITY_STEPS + 1):
                set_flash_decode("1" if step else None)
                out = {}
                for name, s in sides.items():
                    dev = s["dev"]
                    tk, ps = cur[name]
                    # the ring's prefill in chunks of C (no forward may write
                    # more rows than ring - window); the others in one
                    pieces = range(0, T_step, C if name == "ring" else T_step)
                    _cuda.reset_counts()
                    for o in pieces:
                        n = min(T_step, o + (C if name == "ring" else T_step)) - o
                        lg, _ = forward(s["p"], cfg, tk[:, o:o + n].to(dev),
                                        ps[:, o:o + n].to(dev), s["cache"], slot + o, s["vf"],
                                        s["dtype"], logits_idx=n - 1)
                    for k, v in _cuda.COUNTS.items() if name in counts else ():
                        counts[name][k] = counts[name].get(k, 0) + v
                    out[name] = lg[:, -1].float().cpu()
                errs.append(nmse(torch, out["ring"], out["cpu"]))
                full_errs.append(nmse(torch, out["full"], out["cpu"]))
                ring_full.append(nmse(torch, out["ring"], out["full"]))
                ref_errs.append(nmse(torch, out["cpu_bf16"], out["cpu"]))
                nxt = out["ring"].argmax(-1)[:, None].to(torch.int64)
                p = torch.tensor([[n + step] for n in lens], dtype=torch.int64)
                slot += T_step
                T_step = 1
                cur = {n: (nxt, p) for n in sides}
    finally:
        set_flash_decode(None)
    _cuda.reset_counts()
    tol = TOL_E2E_FACTOR * max(ref_errs)
    log(f"ring parity {n_layer}-layer {label} (window {fields['sliding_window']}, ring {ring} = "
        f"window + prefill_chunk {C}; prompts {list(lens)} prefilled in chunks of {C}, + "
        f"{PARITY_STEPS} decode steps, TPULLM_FLASH_DECODE=1): ring on the card vs CPU f32 "
        f"(full cache) "
        f"nmse per step {[f'{e:.3e}' for e in errs]}; full cache on the card vs CPU f32 "
        f"{[f'{e:.3e}' for e in full_errs]}; ring vs full on the card "
        f"{[f'{e:.3e}' for e in ring_full]}; CPU bf16 vs CPU f32 "
        f"{[f'{e:.3e}' for e in ref_errs]}; tol {tol:.3e}; ring-layer routes "
        f"{ {f'{a} {b}': n for (a, b), n in routes.items()} }; launches {counts}")
    bad = [e for e in errs + full_errs + ring_full if not (math.isfinite(e) and e < tol)]
    if bad or not all(math.isfinite(e) for e in ref_errs):
        raise AssertionError(f"{label} ring parity: nmse {errs} / {full_errs} / {ring_full}, "
                             f"tolerance {tol}")
    if set(routes) != {("prefill", "flash_attention"), ("decode", "flash_decode")}:
        raise AssertionError(f"{label} ring parity: ring-layer routes {routes}")
    for run, c in counts.items():
        missing = [k for k in ("qmm_splitk", "qmm", "flash_attention", "flash_decode",
                               "kv_store") if c.get(k, 0) <= 0]
        if missing or bool(c.get("layer_kernel")) != layer_kernel:
            raise AssertionError(f"{label} ring parity, {run} cache: kernels not launched "
                                 f"{missing}, layer kernel {c.get('layer_kernel')}")
    del params, cpu, sides
    torch.cuda.empty_cache()
    return counts


def kv_bytes_of(cfg, n_slots: int, ctx: int, ring: int = 0, esize: int = 2) -> int:
    """K + V bytes of a cache from its bank shapes: full-context banks for
    every layer, or with ``ring`` the SWA layers' ring banks."""
    from tpullm_torch.models.llama import swa_flags

    n_swa = sum(swa_flags(cfg)) if ring else 0
    row = n_slots * cfg.n_head_kv * (cfg.head_dim + cfg.head_dim_v) * esize
    return (cfg.n_layer - n_swa) * ctx * row + n_swa * ring * row


def phase_gemma_ring_server(torch, cfg, params, label="Gemma-2-9B"):
    """Phase 12c: the 42-layer Gemma-2-9B model behind serve() on the iSWA
    ring, the path the CLI takes by default: ServerContext(iswa=True) with 4
    slots of RING_CTX, bf16 KV, prefill_chunk 512 (a ring of 4608 slots on
    the 21 SWA layers), decode_chunk 8, kernel E on, each decode step a CUDA
    graph replay. The dual cache's KV bytes beside the full cache's (from
    the bank shapes). With the launch counts set to 0, a burst of
    RING_SERVER_PROMPTS, 64 new tokens each (the 12000-token prompt first,
    in slot 0), then a follow-up of that prompt and RING_FOLLOW tokens more,
    which must reuse the 12000-token prefix: every request 200; A, B, C, E
    and the store launched, D not; every ring-layer attention call forward
    makes (graph replays repeat the captured step's) on kernel C or E, none
    on the einsum path. Peak device memory of the run, each request's
    prefill_s and decode_s. Then, the loop stopped and the 4 prompts
    prefilled anew, one decode chunk as graph replays against eager steps,
    then profiled as graph replays (server_chunk_profile): wall and device
    ms a step, kernels a step, the busy share. -> the launch counts of the
    burst and the follow-up."""
    import numpy as np
    import socket
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.ops import _cuda
    from tpullm_torch.server.context import ServerContext
    from tpullm_torch.server.http import serve

    vocab = cfg.vocab_size
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, vocab, n).tolist() for n in RING_SERVER_PROMPTS]
    follow = prompts[0] + rng.integers(0, vocab, RING_FOLLOW).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = ServerContext(cfg, params, None, n_slots=4, max_seq_len=RING_CTX, decode_chunk=8,
                        prefill_chunk=RING_CHUNK, kv_dtype=torch.bfloat16, iswa=True,
                        model_name=label.lower() + "-ring")
    cache = ctx.memory.cache
    kv = {"dual_cache_bytes": cache.nbytes,
          "dual_from_shapes": kv_bytes_of(cfg, 4, RING_CTX, cache.ring),
          "full_cache_bytes_from_shapes": kv_bytes_of(cfg, 4, RING_CTX),
          "ring": cache.ring, "full_banks": tuple(cache.k.shape),
          "ring_banks": tuple(cache.kw.shape)}
    if not cache.dual or kv["dual_cache_bytes"] != kv["dual_from_shapes"]:
        raise AssertionError(f"server {label} ring: cache {kv}")
    log(f"server {label} ring: KV bytes of the dual cache {kv['dual_cache_bytes']} "
        f"({kv['dual_cache_bytes'] / 1e9:.3f} GB) and of the full cache "
        f"{kv['full_cache_bytes_from_shapes']} "
        f"({kv['full_cache_bytes_from_shapes'] / 1e9:.3f} GB), from the bank shapes "
        f"(full banks {kv['full_banks']}, ring banks {kv['ring_banks']}); saving "
        f"{1 - kv['dual_cache_bytes'] / kv['full_cache_bytes_from_shapes']:.3f}")
    routes = {}
    counted_route = route_counter(routes, lambda a, r: (
        "ring" if len(a) > 9 and a[9] else "full", "prefill" if a[2] > 1 else "decode", r))

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = f"http://127.0.0.1:{port}"
    set_flash_decode("1")
    srv = serve(ctx, "127.0.0.1", port, block=False)
    report = {"kv": kv}
    try:
        status, r = http_json(base + "/completion", {"prompt": prompts[-1], "max_tokens": 8,
                                                     "temperature": 0.0})
        if status != 200:
            raise AssertionError(f"server {label} ring warm-up answered {status}: {r}")
        ctx.control(lambda: [ctx.memory.clear_slot(i) for i in range(ctx.n_slots)])
        torch.cuda.synchronize()
        m0 = dict(ctx.metrics)
        _cuda.reset_counts()
        with mock.patch.object(llama, "attention_route", counted_route):
            res, wall = server_burst(base, prompts, label + " ring", None, vocab=vocab,
                                     first_admitted=lambda: ctx.rt[0].task is not None)
            t = time.perf_counter()
            status, fr = http_json(base + "/v1/completions",
                                   {"prompt": follow, "max_tokens": SERVER_NEW,
                                    "temperature": 0.0, "ignore_eos": True})
            follow_wall = time.perf_counter() - t
        torch.cuda.synchronize()
        counts = dict(_cuda.COUNTS)
        if status != 200 or len(fr["choices"][0]["tokens"]) != SERVER_NEW:
            raise AssertionError(f"server {label} ring follow-up answered {status}: {fr}")
        gen = ctx.metrics["generated_tokens_total"] - m0["generated_tokens_total"]
        dec_s = ctx.metrics["decode_seconds_total"] - m0["decode_seconds_total"]
        report["burst"] = {
            "requests": [{k: v for k, v in x.items() if k != "ids"} for x in res],
            "burst_wall_s": wall, "burst_completion_tok_per_s": len(prompts) * SERVER_NEW / wall,
            "decode_tok_per_s": gen / dec_s if dec_s else None,
            "follow_up": {"prompt_tokens": fr["timings"]["prompt_tokens"],
                          "cached": fr["timings"]["cached_tokens"],
                          "prefill_s": fr["timings"]["prefill_s"],
                          "decode_s": fr["timings"]["decode_s"], "wall_s": follow_wall},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if fr["timings"]["cached_tokens"] != RING_SERVER_PROMPTS[0]:
            raise AssertionError(f"server {label} ring follow-up reused "
                                 f"{fr['timings']['cached_tokens']} tokens, not the "
                                 f"{RING_SERVER_PROMPTS[0]}-token prefix")
        ctx.stop()  # the loop thread; the chunk profile drives its body from here
        for i in range(ctx.n_slots):
            ctx.memory.clear_slot(i)
        t = time.perf_counter()
        report["decode_chunk_profile"] = server_chunk_profile(
            torch, ctx, prompts, (("kernel E", "1"),), ("graph",), lone=False)["kernel E"]
        report["chunk_profile_s"] = time.perf_counter() - t
    finally:
        set_flash_decode(None)
        srv.shutdown()
        srv.server_close()
        ctx.stop()
    log(f"server {label} ring (4 slots x {RING_CTX}, bf16 KV, iswa on (the CLI's default): "
        f"ring {cache.ring} on {cache.kw.shape[0]} SWA layers, decode_chunk 8, prefill_chunk "
        f"{RING_CHUNK}, kernel E; prompts {RING_SERVER_PROMPTS} then a follow-up of the "
        f"{RING_SERVER_PROMPTS[0]} + {RING_FOLLOW}, {SERVER_NEW} new tokens each): "
        f"{json.dumps(report)}")
    log(f"server {label} ring: attention routes of every call forward made (ring or full "
        f"banks, prefill or decode, route) "
        f"{ {' '.join(k): n for k, n in routes.items()} }; launches {counts}")
    missing = [k for k in ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store")
               if counts[k] <= 0]
    ring_einsum = sum(n for (bank, _, r), n in routes.items() if bank == "ring" and r == "einsum")
    if missing or counts["layer_kernel"] or ring_einsum or not any(
            bank == "ring" and kind == "decode" and r == "flash_decode"
            for bank, kind, r in routes):
        raise AssertionError(f"server {label} ring: kernels not launched {missing}, layer "
                             f"kernel {counts['layer_kernel']}, ring-layer calls on the einsum "
                             f"path {ring_einsum}, routes {routes}")
    del ctx, cache
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_gemma_ring(torch, entries, cfg, params):
    """Phase 12, the iSWA ring (the server's default for bf16/f32 KV): its
    kernel rows (phase_ring_kernels), the depth-cut parities against the
    CPU of the ring and the full cache (phase_ring_parity: Gemma-2-9B with
    2 layers, Gemma-3-4B's width with 6 layers, layers 0-4 SWA, layer 5
    full, rope_base_swa 1e4 under a global base of 1e6 with linear scaling
    8), and the 42-layer Gemma-2-9B ring server (phase_gemma_ring_server)
    on phase 11's params. -> launch counts by path."""
    counts = {}
    t = time.perf_counter()
    phase_ring_kernels(torch, entries)
    log(f"phase kernels ring: {time.perf_counter() - t:.1f} s")
    win = GEMMA_PARITY_WINDOW
    for label, spec, n_layer, fields, seed in (
            ("Gemma-2-9B", GEMMA2, 2, dict(sliding_window=win), 13),
            ("Gemma-3-4B width", GEMMA3_4B, 6, dict(GEMMA3_4B["cfg_fields"], sliding_window=win),
             14)):
        t = time.perf_counter()
        c = phase_ring_parity(torch, f"{label} (depth cut from {spec['n_layer']}, window cut "
                              f"to {win})", spec, n_layer, fields, seed)
        counts[f"{label} {n_layer}-layer"] = c["full"]
        counts[f"{label} ring {n_layer}-layer"] = c["ring"]
        log(f"phase ring parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Gemma-2-9B ring server"] = phase_gemma_ring_server(torch, cfg, params)
    log(f"phase ring server Gemma-2-9B: {time.perf_counter() - t:.1f} s")
    return counts


# Command-R 35B (CohereForAI/c4ai-command-r-v01 config.json): hidden 8192, 40
# layers, 64 heads and 64 kv heads of 128 (full multi-head attention, a GQA
# group of 1), intermediate 22528, vocab 256000, tied embeddings, logit_scale
# 0.0625, layernorm without bias at layer_norm_eps 1e-5, rope_theta 8e6,
# use_parallel_block (attention and the gated silu FFN both off the
# attention's norm); the arch row gives interleaved RoPE
COMMAND_R = dict(arch="command-r", vocab_size=256000, n_embd=8192, n_layer=40, n_head=64,
                 n_head_kv=64, n_ff=22528, rope_base=8e6, exact_vocab=True, tied=True,
                 cfg_fields=dict(norm_eps=1e-5, logit_scale=0.0625))
# StarCoder2-15B (bigcode/starcoder2-15b config.json): hidden 6144, 40 layers,
# 48/4 heads of 128, intermediate 24576, vocab 49152, use_bias (q/k/v, the
# output projection, the MLP's two projections, the layernorms), gelu (tanh)
# without a gate, norm_epsilon 1e-5, rope_theta 1e5; an untied lm_head here
STARCODER2 = dict(arch="starcoder2", vocab_size=49152, n_embd=6144, n_layer=40, n_head=48,
                  n_head_kv=4, n_ff=24576, rope_base=1e5, exact_vocab=True,
                  cfg_fields=dict(norm_eps=1e-5))
CR_SERVER_PROMPTS = [6000, 2000, 700, 40]  # the Command-R burst (the Gemma server's)


def phase_command_r_kernels(torch, entries):
    """Phase 13a: phase 2's rows at Command-R 35B's shapes, each held
    against its plain version and timed beside it, one library call and the
    bound: kernels A (M = 4) and B (M = 2048) on its wqkv (24576 x 8192),
    wo (8192 x 8192), gate/up (45056 x 8192), down (8192 x 22528) and the
    tied 256000-row lm_head, Q4_K; kernel C at 64/64 heads of 128 (G = 1)
    at the engine slice's prefill (B 4, T 512, S 1024) and at the server's
    last chunk of its 6000-token prompt (query slots 5632-6143 over an
    8192-slot view); kernel E at the server's int8 step (rows at
    6000/2000/700/40 of 8192) and the engine's bf16 step (1024-slot view,
    rows at 527); the KV store at 64 kv heads of 128, bit for bit, at the
    server's int8 decode step and a 512-row chunk at 5632."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1919)
    cr = COMMAND_R
    d, nq, nkv = cr["n_embd"], cr["n_head"], cr["n_head_kv"]
    hd = d // nq
    heads = (nq, nkv)
    weight_rows(torch, timer, entries, g, [("wqkv", [nq * hd, nkv * hd, nkv * hd], d),
                                           ("wo", [d], nq * hd),
                                           ("gateup", [cr["n_ff"]] * 2, d),
                                           ("down", [d], cr["n_ff"]),
                                           ("lm_head", [cr["vocab_size"]], d)], "Command-R 35B")
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
             path="Command-R 35B", heads=heads, hd=hd)
    attn_row(torch, timer, entries, g, B=1, T=512, S=8192, n_past=5632, vf=[0],
             path="Command-R 35B server", heads=heads, hd=hd)
    decode_row(torch, timer, entries, g, "Command-R 35B server", 8192, CR_SERVER_PROMPTS,
               [0, 0, 0, 0], True, heads=heads, path="Command-R 35B server", hd=hd)
    decode_row(torch, timer, entries, g, "Command-R 35B engine", 1024, [527] * 4,
               [0, 212, 312, 412], False, heads=heads, path="Command-R 35B", hd=hd)
    store_row(torch, timer, entries, g, "Command-R 35B server decode", "Command-R 35B server",
              1, CR_SERVER_PROMPTS, 0, 8192, True, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "Command-R 35B server prefill chunk",
              "Command-R 35B server", 512, [5632], 2, 8192, True, heads=heads, hd=hd)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_command_r(torch, entries):
    """Phase 13, the layernorm, bias and parallel-residual decoders at full
    width: (a) the 1-layer parities against the CPU (phase 3's rule) of
    Command-R 35B (layernorm without bias, the parallel block off the
    attention's norm, logit_scale 0.0625, the tied 256000-row lm_head; E in
    its decode steps, at a GQA group of 1) and of StarCoder2-15B's width
    (layernorm biases, q/k/v biases, bo, the ungated gelu FFN with its
    biases; the einsum decode), neither launching D; then the kernel rows
    (phase_command_r_kernels); (b) the 40-layer Command-R 35B model's engine
    slice with TPULLM_FLASH_DECODE=1 (A, B, C, E and the store launched, D
    not; every prefill attention call routed to C), its decode-step profile
    as graph replays and one prefill profile; (c) its server
    (phase_q8_server: 4 slots of 8192, int8 KV, E on, a burst of
    6000/2000/700/40 tokens, a decode chunk profiled). The Gemma weights
    are freed before it; every model's Q4_K weights here are drawn on the
    card (synth_kmajor_q4k_fast's generator: Command-R's 21.9 GB would take
    ~47 s from numpy). -> launch counts by path."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    counts = {}
    for label, spec, flag, seed in (("Command-R 35B", COMMAND_R, "1", 19),
                                    ("StarCoder2-15B width", STARCODER2, None, 20)):
        t = time.perf_counter()
        c = phase_parity(torch, f"{label} (depth cut from {spec['n_layer']})", seed=seed,
                         flash_decode=flag, last_only=True, **dict(spec, n_layer=ONE_LAYER),
                         generator=torch.Generator(device="cuda").manual_seed(seed))
        counts[f"{label} {ONE_LAYER}-layer"] = c
        want = ["qmm_splitk", "qmm", "flash_attention", "kv_store"] + (
            ["flash_decode"] if flag else [])
        missing = [k for k in want if c[k] <= 0]
        if missing or c["layer_kernel"]:
            raise AssertionError(f"{label} parity: kernels not launched {missing}, layer "
                                 f"kernel {c['layer_kernel']} (layernorm closes it)")
        log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_command_r_kernels(torch, entries)
    log(f"phase kernels Command-R 35B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_kmajor_q4k_fast(**dict(COMMAND_R, n_layer=slice_depth(
        "Command-R 35B", COMMAND_R["n_layer"])), seed=0, centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"slice Command-R 35B: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} norm {cfg.norm_type} eps "
        f"{cfg.norm_eps:g} parallel_residual {cfg.parallel_residual} heads "
        f"{cfg.n_head}/{cfg.n_head_kv} of {cfg.head_dim} rope {cfg.rope_type} "
        f"{cfg.rope_base:g} logit_scale {cfg.logit_scale:g} tied {cfg.tie_embeddings}; layer "
        f"tensors {sorted(params['layers'])}")
    routes = {}
    counted_route = route_counter(routes, lambda a, r: ("prefill" if a[2] > 1 else "decode", r))
    set_flash_decode("1")
    try:
        with mock.patch.object(llama, "attention_route", counted_route):
            counts["Command-R 35B"], eng, eager, prompts = phase_slice(
                torch, "Command-R 35B", cfg, params, cfg.vocab_size,
                ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store"),
                ("layer_kernel",))
        log(f"slice Command-R 35B: attention routes of every call (prefill or decode, route) "
            f"{ {f'{a} {b}': n for (a, b), n in routes.items()} }")
        if set(r for (kind, r) in routes if kind == "prefill") != {"flash_attention"}:
            raise AssertionError(f"Command-R 35B prefill: attention routes {routes}")
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        phase_decode(torch, eng, prompts, " Command-R 35B graph")
        phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention"),
                              " Command-R 35B")
    finally:
        set_flash_decode(None)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice Command-R 35B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["Command-R 35B server"] = phase_q8_server(torch, cfg, params, "Command-R 35B",
                                                     CR_SERVER_PROMPTS)
    log(f"phase server Command-R 35B: {time.perf_counter() - t:.1f} s")
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# StarCoder-15B (bigcode/starcoder config.json; bigcode/starcoderbase has the
# same shape): n_embd 6144, 40 layers, 48 heads with multi_query (one kv head
# of 128: a GQA group of 48), n_inner 24576, gelu (tanh) without a gate,
# layer_norm_epsilon 1e-5, biases on every projection and layernorm, vocab
# 49152 tied to the embedding, n_positions 8192: a learned f32 position table
# of 8192 x 6144, and no RoPE
STARCODER = dict(arch="starcoder", vocab_size=49152, n_embd=6144, n_layer=40, n_head=48,
                 n_head_kv=1, n_ff=24576, exact_vocab=True, tied=True, n_ctx=8192,
                 cfg_fields=dict(norm_eps=1e-5))
# BLOOM-7b1 (bigscience/bloom-7b1 config.json): hidden 4096, 30 layers, 32/32
# heads of 128, 4 x 4096 MLP with gelu, layer_norm_epsilon 1e-5, vocab 250880
# tied, word_embeddings_layernorm (the embedding's layernorm, with its bias),
# biases everywhere, ALiBi (the GGUF's max_alibi_bias 8) in place of RoPE
BLOOM = dict(arch="bloom", vocab_size=250880, n_embd=4096, n_layer=30, n_head=32,
             n_head_kv=32, n_ff=16384, exact_vocab=True, tied=True, tok_norm=True,
             cfg_fields=dict(norm_eps=1e-5, alibi_max_bias=8.0))
SC_SERVER_PROMPTS = [6000, 2000, 700, 40]  # the StarCoder-15B burst (the Gemma server's)


def phase_starcoder_kernels(torch, entries):
    """Phase 14a: phase 2's rows at StarCoder-15B's shapes, each held
    against its plain version and timed beside it, one library call and the
    bound: kernels A (M = 4) and B (M = 2048) on its wqkv (6400 x 6144:
    48 query heads and one kv head), wo (6144 x 6144), up (24576 x 6144),
    down (6144 x 24576) and the tied 49152-row lm_head, Q4_K; kernel C at
    48/1 heads of 128 (G = 48) at the engine slice's prefill (B 4, T 512,
    S 1024) and at the server's last chunk of its 6000-token prompt (query
    slots 5632-6143 over an 8192-slot view); kernel E at the server's bf16
    step (rows at 6000/2000/700/40 of 8192) and the engine's (1024-slot
    view, rows at 527); the KV store at one kv head, bit for bit, at the
    server's bf16 decode step and a 512-row chunk at 5632. Then C and E
    with ALiBi at BLOOM-7b1's heads (32/32 of 128, alibi_max_bias 8): the
    same four shapes, E on bf16 and int8 K/V, each also timed without the
    slopes on the same inputs (attn_row, decode_row: their library calls)."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2020)
    sc = STARCODER
    d, nq, nkv = sc["n_embd"], sc["n_head"], sc["n_head_kv"]
    hd = d // nq
    heads = (nq, nkv)
    weight_rows(torch, timer, entries, g, [("wqkv", [nq * hd, nkv * hd, nkv * hd], d),
                                           ("wo", [d], nq * hd),
                                           ("up", [sc["n_ff"]], d),
                                           ("down", [d], sc["n_ff"]),
                                           ("lm_head", [sc["vocab_size"]], d)], "StarCoder-15B")
    engine_vf, server = [0, 212, 312, 412], "StarCoder-15B server"
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=engine_vf,
             path="StarCoder-15B", heads=heads, hd=hd)
    attn_row(torch, timer, entries, g, B=1, T=512, S=8192, n_past=5632, vf=[0], path=server,
             heads=heads, hd=hd)
    decode_row(torch, timer, entries, g, server, 8192, SC_SERVER_PROMPTS, [0, 0, 0, 0], False,
               heads=heads, path=server, hd=hd)
    decode_row(torch, timer, entries, g, "StarCoder-15B engine", 1024, [527] * 4, engine_vf,
               False, heads=heads, path="StarCoder-15B", hd=hd)
    store_row(torch, timer, entries, g, "StarCoder-15B server decode", server, 1,
              SC_SERVER_PROMPTS, 0, 8192, False, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "StarCoder-15B server prefill chunk", server, 512,
              [5632], 2, 8192, False, heads=heads, hd=hd)
    bl = BLOOM
    bheads, bhd = (bl["n_head"], bl["n_head_kv"]), bl["n_embd"] // bl["n_head"]
    alibi, bpath = bl["cfg_fields"]["alibi_max_bias"], f"BLOOM-7b1 width {ONE_LAYER}-layer"
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=engine_vf, path=bpath,
             heads=bheads, hd=bhd, alibi=alibi)
    attn_row(torch, timer, entries, g, B=1, T=512, S=8192, n_past=5632, vf=[0], path=bpath,
             heads=bheads, hd=bhd, alibi=alibi)
    for q8 in (False, True):
        decode_row(torch, timer, entries, g, "BLOOM-7b1 server", 8192, SC_SERVER_PROMPTS,
                   [0, 0, 0, 0], q8, heads=bheads, path=bpath, hd=bhd, alibi=alibi)
        decode_row(torch, timer, entries, g, "BLOOM-7b1 engine", 1024, [527] * 4, engine_vf,
                   q8, heads=bheads, path=bpath, hd=bhd, alibi=alibi)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_starcoder(torch, entries):
    """Phase 14, the decoders without RoPE at full width: (b) the 1-layer
    parities against the CPU (phase 3's rule) of StarCoder-15B (the learned
    position table, MQA at G = 48, layernorm and biases, the ungated gelu
    FFN, the tied 49152-row lm_head; E in its decode steps) and of
    BLOOM-7b1's width (ALiBi, the embedding's layernorm, biases; prompts of
    896 and 500 over a 1024-slot cache, so that C runs ALiBi in the prefill
    and E in the decode steps), every C and E call of both on its kernel,
    none on the einsum path, D never launched; (a) the kernel rows
    (phase_starcoder_kernels); (c) the 40-layer StarCoder-15B model's
    engine slice with TPULLM_FLASH_DECODE=1 (A, B, C, E and the store
    launched, D not; every attention call on C or E), its decode-step
    profile as graph replays and one prefill profile; (d) its server
    (phase_q8_server with bf16 KV: 4 slots of 8192, E on, a burst of
    6000/2000/700/40 tokens, a decode chunk profiled). The Command-R
    weights are freed before it; every model's Q4_K weights are drawn on
    the card, the position table and the norms from numpy. -> launch
    counts by path."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    counts = {}
    kernel_route = {"prefill": "flash_attention", "decode": "flash_decode"}
    for label, spec, lens, S, seed in (
            ("StarCoder-15B", STARCODER, (128, 100), 256, 21),
            ("BLOOM-7b1 width", BLOOM, (896, 500), 1024, 22)):
        t = time.perf_counter()
        routes = {}
        # the card's calls only (the CPU sides take the einsum path)
        counted = route_counter(routes, lambda a, r: (
            "prefill" if a[2] > 1 else "decode", r) if a[0] else None)
        with mock.patch.object(llama, "attention_route", counted):
            c = phase_parity(torch, f"{label} (depth cut from {spec['n_layer']})", seed=seed,
                             flash_decode="1", last_only=True, lens=lens, S=S,
                             **dict(spec, n_layer=ONE_LAYER),
                             generator=torch.Generator(device="cuda").manual_seed(seed))
        counts[f"{label} {ONE_LAYER}-layer"] = c
        missing = [k for k in ("qmm_splitk", "qmm", "flash_attention", "flash_decode",
                               "kv_store") if c[k] <= 0]
        off = {k: n for k, n in routes.items() if kernel_route[k[0]] != k[1]}
        log(f"parity {label}: attention routes of the card's calls {routes}")
        if missing or c["layer_kernel"] or off:
            raise AssertionError(f"{label} parity: kernels not launched {missing}, layer "
                                 f"kernel {c['layer_kernel']}, calls off C and E {off}")
        log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_starcoder_kernels(torch, entries)
    log(f"phase kernels StarCoder-15B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_kmajor_q4k_fast(**dict(STARCODER, n_layer=slice_depth(
        "StarCoder-15B", STARCODER["n_layer"])), seed=0, centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"slice StarCoder-15B: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB and "
        f"a {tuple(params['pos_embd'].shape)} f32 position table in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} norm {cfg.norm_type} eps "
        f"{cfg.norm_eps:g} use_rope {cfg.use_rope} heads {cfg.n_head}/{cfg.n_head_kv} of "
        f"{cfg.head_dim} ffn_gate {cfg.ffn_gate} tied {cfg.tie_embeddings}; layer tensors "
        f"{sorted(params['layers'])}")
    routes = {}
    counted_route = route_counter(routes, lambda a, r: ("prefill" if a[2] > 1 else "decode", r))
    set_flash_decode("1")
    try:
        with mock.patch.object(llama, "attention_route", counted_route):
            counts["StarCoder-15B"], eng, eager, prompts = phase_slice(
                torch, "StarCoder-15B", cfg, params, cfg.vocab_size,
                ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store"),
                ("layer_kernel",))
        log(f"slice StarCoder-15B: attention routes of every call (prefill or decode, route) "
            f"{ {f'{a} {b}': n for (a, b), n in routes.items()} }")
        off = {k: n for k, n in routes.items() if kernel_route[k[0]] != k[1]}
        if off:
            raise AssertionError(f"StarCoder-15B slice: attention calls off C and E {off}")
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        phase_decode(torch, eng, prompts, " StarCoder-15B graph")
        phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention"),
                              " StarCoder-15B")
    finally:
        set_flash_decode(None)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice StarCoder-15B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts["StarCoder-15B server"] = phase_q8_server(torch, cfg, params, "StarCoder-15B",
                                                     SC_SERVER_PROMPTS, kv_dtype=torch.bfloat16)
    log(f"phase server StarCoder-15B: {time.perf_counter() - t:.1f} s")
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ERNIE-4.5-21B-A3B (baidu/ERNIE-4.5-21B-A3B-PT config.json): hidden 2560, 28
# layers, 20/4 heads of 128 (a GQA group of 5), layer 0 dense with
# intermediate_size 12288 (moe_layer_start_index 1: the GGUF's
# leading_dense_block_count), 64 experts of moe_intermediate_size 1536, top-6,
# 2 shared experts (written as one ungated *_shexp of 3072), vocab 103424 tied
# to the embedding, rope_theta 500000, rms_norm_eps 1e-5, interleaved RoPE (the
# arch row); softmax routing with the router's selection bias on the choice
# and the top-6 weights renormalized (the JAX row sets no renorm default, so
# it comes as the expert_weights_norm key). The bias is drawn N(0, 0.01): the
# softmax's 6th and 7th probabilities of 64 lie ~0.003 apart at these
# router widths, so it moves most rows' picks without fixing them
ERNIE = dict(arch="ernie4_5-moe", vocab_size=103424, n_embd=2560, n_layer=28, n_head=20,
             n_head_kv=4, n_ff=12288, n_ff_exp=1536, n_expert=64, n_expert_used=6,
             n_ff_shexp=3072, shexp_gate=False, n_dense_lead=1, probs_b_std=0.01,
             rope_base=5e5, rms_eps=1e-5, exact_vocab=True, tied=True,
             cfg_fields=dict(expert_weights_norm=True))
ERNIE_SERVER_PROMPTS = [2000, 700, 300, 40]  # the ERNIE burst: 4 requests on 4 slots


def phase_ernie_kernels(torch, entries, cfg, params):
    """Phase 15's kernel rows, on the 28-layer ERNIE-4.5-21B-A3B model's own
    weights (the last layer of its (27, 64) MoE stacks): A's expert-skip
    variant on gate (N 1536, K 2560) and down (N 2560, K 1536, combining),
    Q4_K, top-6 of 64, at M = 1, 4 (a server step of 4 slots) and 16
    (capacity 64, the whole stack); kernel F at 64 experts on the
    slice's prefill (4 prompts bucketed to 512 = 2048 tokens, top-6: 12288
    assignments), with its padding share; kernel C at G = 5 on that
    prefill's shape and kernel E at G = 5 on the server's decode step (int8
    K/V, 4 slots of 4096) and the engine's (bf16, a 1024-slot view)."""
    from tpullm_torch.ops import _cuda
    from tpullm_torch.ops.moe_gmm import live_tiles, sort_by_expert

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2121)
    lay = params["layers"]["__groups__"][1]
    li = lay["moe_gate_exps"].data["q"].shape[0] - 1
    path = "ERNIE-4.5-21B-A3B"
    used = cfg.n_expert_used
    for M in (1, 4, 16):
        skip_row(torch, timer, entries, "gate", lay["moe_gate_exps"], li, M, g, used, path)
        skip_row(torch, timer, entries, "down", lay["moe_down_exps"], li, M, g, used, path)
    E, M = cfg.n_expert, 2048
    top_i = torch.rand((M, E), generator=g, device="cuda").argsort(-1)[:, :used]
    order, dest, te, Mp = sort_by_expert(top_i, E, M)
    live = live_tiles(dest, te, Mp)
    for name, qt in (("gate", lay["moe_gate_exps"]), ("down", lay["moe_down_exps"])):
        K = qt.shape[-1]
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        xs = torch.zeros((Mp, K), dtype=torch.bfloat16, device="cuda")
        xs[dest] = x[order // used]
        gmm_row(torch, timer, entries, f"{name} of MoE layer {li}", qt, li, xs, te, live,
                M * used, path)
        del x, xs
    heads = (cfg.n_head, cfg.n_head_kv)
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
             path=path, heads=heads)
    decode_row(torch, timer, entries, g, f"{path} server", 4096, [2000, 700, 300, 40],
               [0, 0, 0, 0], True, heads=heads, path=f"{path} server")
    decode_row(torch, timer, entries, g, f"{path} engine", 1024, [527] * 4,
               [0, 212, 312, 412], False, heads=heads, path=path)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_ernie(torch, entries):
    """Phase 15, leading dense layers and the router's selection bias at
    full width, the StarCoder weights freed first: (a) the 2-layer
    ERNIE-4.5-21B-A3B parity against the CPU (phase 6's rule and routing
    count; layer 0 dense, layer 1 MoE with the bias; the bias live on at
    least half of the rows against a copy with it zeroed, the decode
    step's combine weights from the unbiased probabilities); then the
    28-layer model, drawn on the card: (b) its kernel rows
    (phase_ernie_kernels); (c) the slice (4 requests, graph replays, then
    eagerly: the same tokens and launch counts; A, B, C, F, the store and
    the skip launched, D not), phase 5's decode-step profile as graph
    replays (3 skip launches for each of the 27 MoE layers a step, and A's
    launches: wqkv and wo a layer, the dense lead's gate/up and down, the
    shared expert's three a MoE layer, the lm_head) and a prefill profile;
    (d) its server (phase_q8_server: 4 slots of 4096, int8 KV, E on, token
    ids, a burst of 2000/700/300/40 tokens, a decode chunk profiled).
    -> launch counts by path."""
    counts = {}
    label = "ERNIE-4.5-21B-A3B"
    t = time.perf_counter()
    counts[f"{label} 2-layer"] = phase_moe_parity(
        torch, f"{label} (depth cut from {ERNIE['n_layer']})", ERNIE, seed=23)
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_moe(ERNIE, n_layer=slice_depth(label, ERNIE["n_layer"]), seed=0,
                            device="cuda")
    torch.cuda.synchronize()
    groups = params["layers"]["__groups__"]
    log(f"slice {label}: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} rope {cfg.rope_type} "
        f"{cfg.rope_base:g} heads {cfg.n_head}/{cfg.n_head_kv} of {cfg.head_dim} experts "
        f"{cfg.n_expert} top-{cfg.n_expert_used} of {cfg.n_ff_exp} gating "
        f"{cfg.expert_gating} renorm {cfg.expert_weights_norm} dense lead "
        f"{cfg.n_layer_dense_lead} tied {cfg.tie_embeddings}; layer groups "
        f"{[sorted(gl) for gl in groups]}")
    t = time.perf_counter()
    phase_ernie_kernels(torch, entries, cfg, params)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[label], eng, eager, prompts = phase_slice(
        torch, label, cfg, params, cfg.vocab_size, MOE_KERNELS, ("layer_kernel",))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    out = phase_decode(torch, eng, prompts, f" {label} graph")
    step = out["graph_capture_counts_per_step"] or {}
    n_dense, n_moe = cfg.n_layer_dense_lead, cfg.n_layer - cfg.n_layer_dense_lead
    want = {"qmm_experts": 3 * n_moe,
            "qmm_splitk": 2 * cfg.n_layer + 2 * n_dense + 3 * n_moe + 1}
    if {k: step.get(k) for k in want} != want or step.get("layer_kernel"):
        raise AssertionError(f"{label} decode step: launches {step}, want {want} (one skip "
                             "launch a projection a MoE layer; A on wqkv, wo, the dense "
                             "lead's FFN, the shared expert and the lm_head)")
    phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "moe_gmm"),
                          f" {label}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} server"] = phase_q8_server(torch, cfg, params, label, ERNIE_SERVER_PROMPTS,
                                                n_ctx=4096, must=("moe_gmm", "qmm_experts"))
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, groups
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json): hidden 2048, 27
# layers, 16 heads, q_lora_rank none (a direct wq), kv_lora_rank 512,
# qk_nope_head_dim 128, qk_rope_head_dim 64, v_head_dim 128; layer 0 dense of
# intermediate 10944 (first_k_dense_replace 1), then 64 routed experts of
# moe_intermediate_size 1408, top-6, softmax, norm_topk_prob false,
# routed_scaling_factor 1.0, and 2 shared experts (one FFN of 2816); vocab
# 102400, untied; rope_theta 1e4 with YaRN (factor 40 over 4096,
# mscale_all_dim 0.707: the GGUF's yarn_log_multiplier 0.0707, parsed to
# 0.707), max_position_embeddings 163840, rms_norm_eps 1e-6. Q4_K, and Q8_0
# where K is not a multiple of 256 (the expert down at 1408, the dense down
# at 10944), as a Q4_K_M file gives them (synth_mla_q4k)
DEEPSEEK = dict(arch="deepseek2", vocab_size=102400, n_embd=2048, n_layer=27, n_head=16,
                kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128, n_ff=10944,
                n_expert=64, n_expert_used=6, n_ff_exp=1408, n_ff_shexp=2816,
                n_expert_shared=2, n_dense_lead=1, rope_base=1e4, rms_eps=1e-6,
                cfg_fields=dict(n_ctx_train=163840, rope_scaling="yarn", rope_scale=40.0,
                                rope_orig_ctx=4096, rope_yarn_log_mul=0.707))
# the DeepSeek burst, 4 requests on 4 slots: under 512 tokens of depth, so
# that the server captures one decode graph (the view bucket's least), as
# each capture of its ~43000-kernel step takes ~4.6 s on an H100 80GB HBM3
# at 700 W
DS_SERVER_PROMPTS = [480, 200, 80, 40]
# greedy steps of its slice (one decode chunk) and tokens of its server's
# requests, cut from 32 and 64, then 16 and 8, for the script's time limit:
# the expert loop's step takes ~160 ms as a graph replay and ~1.0-1.3 s
# eagerly on an H100 80GB HBM3 at 700 W
DS_NEW = 4
# the kernels of the MLA path, and those off it: MLA attention takes the
# einsum path (its own scale; Dk 576 != Dv 512), D's gate refuses MLA, and
# the expert down at K 1408 (planar Q8_0) sends the experts to the loop
MLA_KERNELS = ("qmm_splitk", "qmm", "kv_store")
MLA_OFF = ("layer_kernel", "flash_attention", "flash_decode", "moe_gmm", "qmm_experts")


def synth_deepseek(torch, n_layer, seed, layout="split", **kw):
    """synth_mla_q4k of DeepSeek-V2-Lite cut to ``n_layer`` layers (``kw``
    over the spec). ``layout`` "legacy": each layer group's wk_b and wv_b
    as a legacy attn_kv_b file gives them, a Q4_K (L, H * (nope + v),
    kv_lora) weight drawn on the card and split by the loader's own
    _mla_prepare (dequantized on the card)."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.ops.qtensor import QTensor
    from tpullm_torch.runtime.loader import _mla_prepare
    from tpullm_torch.utils.synth import random_kmajor, synth_mla_q4k

    cfg, params = synth_mla_q4k(**dict(DEEPSEEK, n_layer=n_layer, **kw), seed=seed,
                                device="cuda")
    if layout == "legacy":
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        groups = params["layers"].get("__groups__") or [params["layers"]]
        n = cfg.n_head * (cfg.head_dim - cfg.rope_dim + cfg.head_dim_v)
        out = []
        for gl in groups:
            lead = (gl["wk_b"].shape[0],)
            kvb = random_kmajor(GGMLType.Q4_K, [n], cfg.kv_lora_rank, lead, g, "cuda")
            gl = {k: v for k, v in gl.items() if k not in ("wk_b", "wv_b")}
            gl["wkv_b"] = QTensor(GGMLType.Q4_K, lead + (n, cfg.kv_lora_rank), kvb.data)
            out.append(_mla_prepare(gl, cfg))
        params["layers"] = {"__groups__": out} if len(out) > 1 else out[0]
    torch.cuda.synchronize()
    return cfg, params


def params_bytes(params) -> int:
    """Bytes of every tensor of a model's params (a tied lm_head once)."""
    seen, total = set(), 0

    def walk(v):
        nonlocal total
        if isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, list):
            for x in v:
                walk(x)
        elif hasattr(v, "data") and isinstance(v.data, dict):
            for t in v.data.values():
                walk(t)
        elif hasattr(v, "data_ptr") and v.data_ptr() not in seen:
            seen.add(v.data_ptr())
            total += v.numel() * v.element_size()

    walk(params)
    return total


def phase_mla_parity(torch, label, layout, kv, seed, n_layer=2):
    """Phase 16a: DeepSeek-V2-Lite at full width cut to ``n_layer`` layers
    (layer 0 dense, layer 1 MoE, YaRN on), kernels on the card against the
    plain path on a CPU copy in f32, teacher-forced with the card's greedy
    picks: a prefill of 2 prompts of 128 and 100 tokens (left-padded) and
    one decode step over a 256-slot cache of ``kv`` (bf16 or "q8"; the CPU
    sides on the same type: f32 or q8 and bf16 or q8), on a split
    (``layout`` "split") or a legacy attn_kv_b model. Tolerance: phase 6's
    rule, 4x the NMSE of the same plain path in bf16. A, B and the store
    must launch; C, D, E, F and the skip must not. -> the card's launch
    counts."""
    import numpy as np

    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.ops import _cuda

    cfg, params = synth_deepseek(torch, n_layer, seed, layout)
    cpu = plain_cpu_copy(torch, params)
    rng = np.random.default_rng(3)
    lens, S = (128, 100), 256
    B, T = len(lens), max(lens)
    tok = np.zeros((B, T), np.int64)
    posn = np.zeros((B, T), np.int64)
    for b, n in enumerate(lens):
        tok[b, T - n:] = rng.integers(0, cfg.vocab_size, n)
        posn[b, T - n:] = np.arange(n)
    vf = np.asarray([T - n for n in lens], np.int64)
    q8 = kv == "q8"
    sides = {}
    for name, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.float32),
                             ("cpu_bf16", "cpu", torch.bfloat16)):
        sides[name] = dict(p=params if dev == "cuda" else cpu, dev=dev, dtype=dtype,
                           cache=KVCache.create(cfg, B, S, "q8" if q8 else dtype, dev),
                           vf=torch.from_numpy(vf).to(dev))
    errs, ref_errs, agree = [], [], []
    cur_tok, cur_pos = torch.from_numpy(tok), torch.from_numpy(posn)
    slot, T_step = 0, T
    _cuda.reset_counts()
    with torch.inference_mode():
        for step in range(2):
            out = {}
            for name, sd in sides.items():
                dev = sd["dev"]
                t0 = time.perf_counter()
                lg, _ = forward(sd["p"], cfg, cur_tok.to(dev), cur_pos.to(dev), sd["cache"],
                                slot, sd["vf"], sd["dtype"], kv_view_len=None if step == 0 else S)
                out[name] = lg[:, -1].float().cpu()
                if dev == "cuda":
                    torch.cuda.synchronize()
                sd.setdefault("sec", []).append(time.perf_counter() - t0)
            errs.append(nmse(torch, out["card"], out["cpu"]))
            ref_errs.append(nmse(torch, out["cpu_bf16"], out["cpu"]))
            agree.append((out["card"].argmax(-1) == out["cpu"].argmax(-1)).tolist())
            nxt = out["card"].argmax(-1)
            slot += T_step
            T_step = 1
            cur_tok = nxt[:, None].to(torch.int64)
            cur_pos = torch.tensor([[n + step] for n in lens], dtype=torch.int64)
    counts = dict(_cuda.COUNTS)
    tol = TOL_E2E_FACTOR * max(ref_errs)
    log(f"parity {n_layer}-layer {label} ({layout} absorption banks, {kv} KV cache; prefill "
        f"T={T}, prompts {list(lens)}, S={S} + 1 decode step): card vs CPU f32 logits nmse per "
        f"step {[f'{e:.3e}' for e in errs]}; CPU bf16 vs CPU f32 "
        f"{[f'{e:.3e}' for e in ref_errs]}; tol {tol:.3e} ({TOL_E2E_FACTOR:g}x the largest); "
        f"greedy agree {agree}; card s {[round(x, 3) for x in sides['card']['sec']]} cpu f32 s "
        f"{[round(x, 2) for x in sides['cpu']['sec']]} cpu bf16 s "
        f"{[round(x, 2) for x in sides['cpu_bf16']['sec']]}; launches {counts}")
    if not all(math.isfinite(e) for e in errs + ref_errs) or max(errs) >= tol:
        raise AssertionError(f"{label} {layout} {kv} parity: nmse {errs}, tolerance {tol}")
    missing = [k for k in MLA_KERNELS if counts[k] <= 0]
    extra = [k for k in MLA_OFF if counts[k]]
    if missing or extra:
        raise AssertionError(f"{label} {layout} {kv} parity: kernels not launched {missing}, "
                             f"launched but off the MLA path {extra}")
    _cuda.reset_counts()
    del params, cpu, sides
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_mla_shift(torch, label, seed):
    """Phase 16a's context shift on the card: DeepSeek-V2-Lite's attention
    and dense layer at full width, one layer deep (its K and V rows then
    depend on their token and position alone), YaRN on. A slot prefilled
    with 600 tokens is shifted (keep 64, discard 200: the server's
    context_shift, runtime/memory.py:_mla_shift), then decodes one token;
    the oracle is a slot prefilled with the 400 kept tokens at their new
    positions, decoding the same token. For the bf16 and the int8 cache:
    the kept K rows of both (dequantized) agree within the cache's rounding,
    and the decode logits within NMSE 1e-3, where a control that moves the
    rows without rotating k_pe is off by more. -> None."""
    import numpy as np

    from tpullm_torch.models.llama import forward
    from tpullm_torch.runtime.memory import SlotMemory

    cfg, params = synth_deepseek(torch, 1, seed, n_expert=0, n_expert_used=0, n_ff_exp=0,
                                 n_ff_shexp=0)
    rng = np.random.default_rng(9)
    seq = rng.integers(0, cfg.vocab_size, 600).tolist()
    n_keep, nd = 64, 200
    kept = seq[:n_keep] + seq[n_keep + nd:]
    vf = torch.zeros(1, dtype=torch.int64, device="cuda")
    report = {}

    def prefill(mem, toks):
        forward(params, cfg, torch.tensor([toks], device="cuda"),
                torch.arange(len(toks), device="cuda")[None], mem.cache, 0, vf, torch.bfloat16,
                slot0=0)
        mem.slots[0].n_past, mem.slots[0].tokens = len(toks), list(toks)

    def step(mem):
        n = mem.slots[0].n_past
        lg, _ = forward(params, cfg, torch.tensor([[11]], device="cuda"),
                        torch.tensor([[n]], device="cuda"), mem.cache,
                        torch.tensor([n], device="cuda"), vf, torch.bfloat16, kv_view_len=1024,
                        slot0=0)
        return lg[0, -1].float().cpu()

    def rows(mem, n):
        c = mem.cache
        k = c.k.float() * c.ks[..., None] if c.quantized else c.k.float()
        return k[..., :n, :]

    with torch.inference_mode():
        for kv in (torch.bfloat16, "q8"):
            shifted, control, fresh = (SlotMemory(cfg, 1, 1024, kv, "cuda") for _ in range(3))
            for mem in (shifted, control):
                prefill(mem, seq)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shifted.context_shift(0, n_keep, nd)
            torch.cuda.synchronize()
            shift_ms = (time.perf_counter() - t0) * 1e3
            idx = torch.arange(1024, device="cuda")  # the control: rows moved, nothing rotated
            src = torch.where((idx >= n_keep) & (idx < 600 - nd), idx + nd, idx)
            c = control.cache
            for buf in (c.k, c.v, c.ks, c.vs):
                if buf is not None:
                    buf[:, 0] = buf[:, 0][:, :, src]
            control.slots[0].n_past = 600 - nd
            prefill(fresh, kept)
            n = len(kept)
            want = rows(fresh, n)
            k_err = float((rows(shifted, n) - want).abs().max())
            k_ctl = float((rows(control, n) - want).abs().max())
            scale = float(want.abs().max())
            want_lg = step(fresh)
            err, ctl = nmse(torch, step(shifted), want_lg), nmse(torch, step(control), want_lg)
            name = "q8" if kv == "q8" else "bf16"
            report[name] = {"k_max_abs_err": k_err, "k_control_max_abs_err": k_ctl,
                            "k_max_abs": scale, "logits_nmse": err,
                            "control_logits_nmse": ctl, "shift_ms": shift_ms}
            if not (k_err < 0.02 * scale and err < 1e-3 and err < ctl and k_err < k_ctl):
                raise AssertionError(f"{label} MLA shift ({name} cache) against the re-prefill: "
                                     f"{report[name]}")
            del shifted, control, fresh
    log(f"shift {label} (1 layer at full width, YaRN; 600 tokens, keep {n_keep}, discard {nd}, "
        f"then one decode step against a re-prefill of the {len(kept)} kept tokens; the "
        f"control moves the rows without rotating k_pe): {json.dumps(report)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def mla_attention_row(torch, timer, cfg, g, slots, S=4096):
    """The MLA attention of one layer at the server's decode step (no kernel:
    the einsum path, models/llama.py:attention with mla_scale): 4 rows of one
    token each at ``slots`` over the int8 cache of S slots, one kv head of
    576/512, 16 query heads. Timed as forward runs it (the int8 views
    dequantized, then masked_attention), beside SDPA on the same dequantized
    K/V (Dk 576 != Dv 512, the shared head broadcast by enable_gqa, a dense
    mask) held against it, the yardstick for a kernel E at this shape. The
    bound reads each row's live K/V (int8 with its two scales) and q, writes
    the output, and counts 2 (Dk + Dv) flops a (query head, key) pair.
    -> ms."""
    from tpullm_torch.models.llama import attention, dequant_view, kv_dims, mla_scale

    B, Hq = len(slots), cfg.n_head
    _, dk, dv = kv_dims(cfg)
    q = torch.randn((B, 1, Hq, dk), generator=g, device="cuda").to(torch.bfloat16)
    kq = torch.randint(-127, 128, (B, 1, S, dk), generator=g, device="cuda").to(torch.int8)
    vq = kq[..., :dv].contiguous()
    ks = torch.rand((B, 1, S), generator=g, device="cuda") * 0.02
    vs = ks.clone()
    qs = torch.tensor(slots, device="cuda")[:, None]
    vf = torch.zeros(B, dtype=torch.int64, device="cuda")
    kvp = torch.arange(S, device="cuda")[None, :].expand(B, S)
    scale = mla_scale(cfg)
    run = lambda: attention(q, None, None, qs, kvp, qs, vf, cfg, kv_q8=(kq, vq, ks, vs),
                            scale=scale)
    want = run()
    ms = timer(run, 20)
    k, v = dequant_view(kq, ks, torch.bfloat16), dequant_view(vq, vs, torch.bfloat16)
    mask = (torch.arange(S, device="cuda")[None, None, None, :] <= qs[:, None, :, None])
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask, scale=scale, enable_gqa=True)
    try:
        got = sdpa().transpose(1, 2)
        lib_err = nmse(torch, got, want)
        lms = timer(sdpa, 20)
    except RuntimeError as e:  # no SDPA backend for these dims
        lib_err, lms = f"SDPA raised: {str(e)[:120]}", None
    live = sum(s + 1 for s in slots)
    bound, by = bound_of(live * (dk + dv + 8) + B * Hq * (dk + dv) * 2,
                         2.0 * (dk + dv) * Hq * live)
    log(f"mla attention[einsum,server decode,B={B},H={Hq},Hkv=1,Dk={dk},Dv={dv},S={S},slots "
        f"{'/'.join(map(str, slots))},int8]: ms {ms:.4f} bound_ms {bound:.5f} ({by}) "
        f"share_of_bound {bound / ms:.4f} sdpa_ms {'null' if lms is None else f'{lms:.4f}'} "
        f"(sdpa nmse against it {lib_err if isinstance(lib_err, str) else f'{lib_err:.2e}'})")
    if not isinstance(lib_err, str) and not lib_err < TOL_ATTN_NMSE:
        raise AssertionError(f"SDPA at the MLA shape: nmse {lib_err} against the einsum path")
    return ms


def moe_loop_row(torch, timer, cfg, lay, li, g, B, T):
    """One MoE layer's FFN (models/llama.py:moe_ffn) of the MLA model on the
    card, x (B, T, n_embd): the loop route (every expert on every row; gate/up
    through kernel A or B, the planar Q8_0 down dequantized whole and
    multiplied, as the expert down at K 1408 has no K-major tile), the router
    and the shared expert where the layer has one (gpt-oss-20b's: no shared
    expert; its planar MXFP4 experts with their biases and the router's bias,
    all of layer li of ``lay``). Timed as its path runs it: a decode call (B*T <=
    16) as a CUDA graph replay, as the decode steps take it, beside the same
    call eagerly; a prefill call eagerly. The bound counts the weights the
    rows' selected experts and the shared expert need, read once. -> ms (the
    graph replay's at decode)."""
    from tpullm_torch.models.llama import moe_ffn, moe_route

    from tpullm_torch.models.llama import MOE_BIAS_KEYS

    qw = {k: v for k, v in lay.items() if hasattr(v, "qtype")}
    bias = {k: lay[k][li] for k in MOE_BIAS_KEYS if k in lay}
    x = torch.randn((B, T, cfg.n_embd), generator=g, device="cuda").to(torch.bfloat16)
    route = moe_route(True, B * T, qw["moe_gate_exps"], qw["moe_up_exps"], qw["moe_down_exps"],
                      cfg.n_embd, cfg.n_expert_used, any(k != "moe_gate_inp_b" for k in bias))
    run = lambda: moe_ffn(x, qw, li, cfg, torch.bfloat16, bias=bias)
    ms = eager_ms = timer(run, 5 if B * T <= 16 else 2, warmup=1)
    if B * T <= 16:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        ms = timer(graph.replay, 5, warmup=1)
        del graph
    per_e = sum(weight_bytes(qw[k]) for k in ("moe_gate_exps", "moe_up_exps", "moe_down_exps"))
    per_e /= qw["moe_gate_exps"].shape[0] * cfg.n_expert
    n_sel = min(cfg.n_expert, B * T * cfg.n_expert_used)
    shk = ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp")
    sh = sum(weight_bytes(qw[k]) for k in shk if k in qw)
    sh_ff = 0
    if "ffn_gate_shexp" in qw:
        sh /= qw["ffn_gate_shexp"].shape[0]
        sh_ff = qw["ffn_gate_shexp"].shape[-2]
    bound, by = bound_of(n_sel * per_e + sh, 2.0 * 3 * B * T * cfg.n_embd * (
        cfg.n_expert_used * cfg.n_ff_exp + sh_ff))
    log(f"moe layer[{route},B={B},T={T},E={cfg.n_expert},top-{cfg.n_expert_used},"
        f"{cfg.n_ff_exp}x{cfg.n_embd},down {qw['moe_down_exps'].qtype.name} "
        f"{qw['moe_down_exps'].layout}]: ms {ms:.3f}"
        + (f" (a graph replay; eagerly {eager_ms:.3f})" if B * T <= 16 else " (eagerly)")
        + f" bound_ms {bound:.4f} ({by}) share_of_bound {bound / ms:.4f}")
    if route != "loop":
        raise AssertionError(f"MoE layer of {cfg.arch} at B*T={B * T}: route {route}")
    return ms


def phase_deepseek_kernels(torch, entries, cfg, params):
    """Phase 16b's rows, on the cut DeepSeek-V2-Lite model (SLICE_LAYERS)'s own
    weights (its last layer): kernels A (M = 4) and B (M = 2048) on the MLA
    projections wq (3072 x 2048), wkv_a (576 x 2048) and wo (2048 x 2048),
    Q4_K; the store at one kv head of 576/512 (the server's int8 decode step
    at slots 480/200/80/40 of 4096 and a 512-row chunk, the engine's bf16
    step); the einsum MLA attention at the server's step, with SDPA beside
    it; the loop route's ms a MoE layer at M = 4 and at the 4 x 512 prefill.
    -> {"decode": ms, "prefill": ms} of a MoE layer."""
    from tpullm_torch.ops import _cuda
    from tpullm_torch.ops.qtensor import QTensor

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2222)
    lay = params["layers"]["__groups__"][1]
    li = lay["wq"].data["q"].shape[0] - 1
    path = "DeepSeek-V2-Lite"
    for name in ("wq", "wkv_a", "wo"):
        w = lay[name]
        qt = QTensor(w.qtype, tuple(w.shape[1:]), {k: v[li] for k, v in w.data.items()})
        w_bf16 = qt.dequant(torch.bfloat16)
        K = qt.shape[-1]
        for kname, M in (("qmm_splitk", 4), ("qmm", 2048)):
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            qmm_row(torch, timer, entries, kname,
                    f"{kname}[{name} {qt.n_out}x{K},{qt.qtype.name},M={M},{path}]", x, qt,
                    w_bf16, path=path)
        del qt, w_bf16
    heads, hd, hdv = (cfg.n_head, 1), cfg.kv_lora_rank + cfg.rope_dim, cfg.kv_lora_rank
    store_row(torch, timer, entries, g, "server decode", f"{path} server", 1, DS_SERVER_PROMPTS,
              0, 4096, True, heads=heads, hd=hd, hdv=hdv)
    store_row(torch, timer, entries, g, "server prefill chunk", f"{path} server", 512, [1536],
              2, 4096, True, heads=heads, hd=hd, hdv=hdv)
    store_row(torch, timer, entries, g, "engine decode", path, 1, [ENGINE_DECODE_SLOT] * 4, 0,
              1024, False, heads=heads, hd=hd, hdv=hdv)
    mla_attention_row(torch, timer, cfg, g, DS_SERVER_PROMPTS)
    loop = {"decode": moe_loop_row(torch, timer, cfg, lay, li, g, 4, 1),
            "prefill": moe_loop_row(torch, timer, cfg, lay, li, g, 4, 512)}
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()
    return loop


def phase_deepseek(torch, entries):
    """Phase 16, MLA at full width (DeepSeek-V2-Lite), the ERNIE weights freed
    first: (a) the 2-layer parities against the CPU (split banks on the bf16
    cache, legacy attn_kv_b on the int8 cache) and the context shift
    against a re-prefill (phase_mla_shift); then the model cut to SLICE_LAYERS
    layers (of 27) drawn on
    the card: (b) its kernel rows (phase_deepseek_kernels); (c) the slice
    (4 requests, graph replays, then eagerly: the same tokens and launch
    counts; A, B and the store launched, C, D, E, F and the skip not), the
    decode-step profile as graph replays (A's launches a step: wq, wkv_a and
    wo a layer, the dense lead's gate/up, every expert's gate and up and the
    shared expert's a MoE layer, the lm_head; the store once a layer), with
    the loop's share of the step, and a prefill profile; (d) its server
    (phase_q8_server: 4 slots of 4096, int8 KV, token ids, a burst of
    480/200/80/40 tokens, a decode chunk profiled). -> launch counts by
    path."""
    counts = {}
    label = "DeepSeek-V2-Lite"
    t = time.perf_counter()
    counts[f"{label} 2-layer"] = phase_mla_parity(torch, label, "split", "bf16", seed=31)
    phase_mla_parity(torch, label, "legacy", "q8", seed=37)
    phase_mla_shift(torch, label, seed=41)
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_deepseek(torch, slice_depth(label, DEEPSEEK["n_layer"]), seed=0)
    from tpullm_torch.models.llama import kv_dims

    groups = params["layers"]["__groups__"]
    n_w = sum(math.prod(v.shape) for gl in groups for v in gl.values()) + 2 * (
        cfg.vocab_size * cfg.n_embd)
    _, dk, dv = kv_dims(cfg)
    q8_row = dk + dv + 8  # int8 K and V with their two f32 row scales
    mha_row = cfg.n_head * (cfg.head_dim + cfg.head_dim_v) * 2
    slots = 4 * 4096 * cfg.n_layer
    log(f"slice {label}: synthesized weights {params_bytes(params) / 1e9:.3f} GB "
        f"({n_w / 1e9:.3f} B weights) in {time.perf_counter() - t:.3f} s; config {cfg.arch} "
        f"rope {cfg.rope_type} {cfg.rope_base:g} {cfg.rope_scaling} x{cfg.rope_scale:g} "
        f"mla_scale heads {cfg.n_head} q {cfg.head_dim} v {cfg.head_dim_v} kv_lora "
        f"{cfg.kv_lora_rank} q_lora {cfg.q_lora_rank} experts {cfg.n_expert} top-"
        f"{cfg.n_expert_used} of {cfg.n_ff_exp} shared {cfg.n_expert_shared} dense lead "
        f"{cfg.n_layer_dense_lead}; KV cache a token a layer: int8 {q8_row} B, over 4 x 4096 "
        f"slots {slots * q8_row / 1e9:.3f} GB; the decompressed MHA cache in bf16 {mha_row} B, "
        f"{slots * mha_row / 1e9:.3f} GB; layer groups {[sorted(gl) for gl in groups]} with "
        f"layouts {[{k: v.layout for k, v in gl.items() if hasattr(v, 'qtype')} for gl in groups]}")
    t = time.perf_counter()
    loop = phase_deepseek_kernels(torch, entries, cfg, params)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[label], eng, eager, prompts = phase_slice(
        torch, label, cfg, params, cfg.vocab_size, MLA_KERNELS, MLA_OFF, new=DS_NEW + 1,
        samples=1)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    out = phase_decode(torch, eng, prompts, f" {label} graph", profiled_steps=1, steps=8)
    step = out["graph_capture_counts_per_step"] or {}
    n_dense, n_moe = cfg.n_layer_dense_lead, cfg.n_layer - cfg.n_layer_dense_lead
    want = {"qmm_splitk": 3 * cfg.n_layer + n_dense + n_moe * (2 * cfg.n_expert + 2) + 1,
            "kv_store": cfg.n_layer}
    if {k: step.get(k) for k in want} != want or any(step.get(k) for k in MLA_OFF):
        raise AssertionError(f"{label} decode step: launches {step}, want {want} (A on wq, "
                             "wkv_a and wo a layer, the dense lead's gate/up, every expert's "
                             "gate and up and the shared expert's a MoE layer, the lm_head; "
                             "the store once a layer)")
    pre = phase_prefill_profile(torch, eng, prompts, ("qmm", "kv_store"), f" {label}")
    step_ms = out["wall_ms_q1_median_q3"][1]
    log(f"moe loop {label}: {n_moe} MoE layers x {loop['decode']:.3f} ms (graph) at M = 4 = "
        f"{n_moe * loop['decode']:.2f} ms of the {step_ms:.2f} ms graph decode step (share "
        f"{n_moe * loop['decode'] / step_ms:.3f}); x {loop['prefill']:.2f} ms at the 4 x 512 "
        f"prefill = {n_moe * loop['prefill']:.1f} ms of its {pre['wall_ms']:.1f} ms (share "
        f"{n_moe * loop['prefill'] / pre['wall_ms']:.3f})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} server"] = phase_q8_server(torch, cfg, params, label, DS_SERVER_PROMPTS,
                                                n_ctx=4096, kernels=MLA_KERNELS,
                                                must_not=MLA_OFF, decode_chunk=2, new=DS_NEW)
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, groups
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Phi-4 (microsoft/phi-4 config.json; the GGUF's arch phi3): hidden 5120, 40
# layers, 40/10 heads of 128 (a GQA group of 4), intermediate 17920 (gate and
# up written as one ffn_up of 2 x 17920 rows, as llama.cpp's phi3 tensors
# have no ffn_gate), the fused attn_qkv (7680 rows), vocab 100352, untied
# lm_head, rope_theta 250000 (neox, the arch row), rms_norm_eps 1e-5, no
# sliding window. gguf_layout draws wqkv_cat and the combined ffn_up, which
# the loader's fuse step renames ffn_gateup (n_ff a multiple of 256), so the
# decode layers take kernel D
PHI4 = dict(arch="phi3", vocab_size=100352, n_embd=5120, n_layer=40, n_head=40, n_head_kv=10,
            n_ff=17920, rope_base=2.5e5, rms_eps=1e-5, exact_vocab=True, gguf_layout=True)
PHI4_SERVER_PROMPTS = [6000, 2000, 700, 40]  # the Phi-4 burst (the Gemma server's)
# phase 17b: the aperiodic SWA array on 4 layers, the window cut to 128 and
# prefill_chunk 64 (a ring of 192), prompts of 512 and 250 tokens, so the
# longer wraps the ring twice (and the full cache's one-piece prefill of 512
# rows takes kernel C) at ~60% of phase 12b's CPU work
PHI4_SWA = (True, False, True, True)
PHI4_RING_WINDOW, PHI4_RING_CHUNK, PHI4_RING_LENS = 128, 64, (512, 250)
PHI4_KERNELS = ("qmm_splitk", "qmm", "flash_attention", "layer_kernel", "flash_decode",
                "kv_store")


def phase_phi4_kernels(torch, entries):
    """Phase 17c: phase 2's rows at Phi-4's shapes, each held against its
    plain version and timed beside it, one library call and the bound:
    kernels A (M = 4) and B (M = 2048) on its wqkv (the fused attn_qkv,
    7680 x 5120), wo (5120 x 5120), gate/up (the combined ffn_up, 35840 x
    5120), down (5120 x 17920) and the untied 100352-row lm_head, Q4_K
    (K 5120 and 17920: the 32-group f32 d and dmin); kernel D at Phi-4's
    layer (M = 4, plain and folded, beside the unfused layer); kernel C at
    40/10 heads of 128 (G = 4) at the engine slice's prefill (B 4, T 512, S
    1024); kernel E at the server's int8 step (rows at 6000/2000/700/40 of
    8192); the KV store at 10 kv heads of 128, bit for bit, at the server's
    int8 decode step and a 512-row chunk at 5632."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2323)
    ph = PHI4
    d, nq, nkv, n_ff = ph["n_embd"], ph["n_head"], ph["n_head_kv"], ph["n_ff"]
    hd = d // nq
    heads, slice_path, server = (nq, nkv), "Phi-4 slice", "Phi-4 server"
    weight_rows(torch, timer, entries, g, [("wqkv", [(nq + 2 * nkv) * hd], d),
                                           ("wo", [d], nq * hd),
                                           ("gateup", [2 * n_ff], d),
                                           ("down", [d], n_ff),
                                           ("lm_head", [ph["vocab_size"]], d)], slice_path)
    layer_rows(torch, timer, entries, g, n_ff=n_ff, path=slice_path, d=d, heads=heads, hd=hd)
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
             path=slice_path, heads=heads, hd=hd)
    decode_row(torch, timer, entries, g, server, 8192, PHI4_SERVER_PROMPTS, [0, 0, 0, 0], True,
               heads=heads, path=server, hd=hd)
    store_row(torch, timer, entries, g, "Phi-4 server decode", server, 1, PHI4_SERVER_PROMPTS,
              0, 8192, True, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "Phi-4 server prefill chunk", server, 512, [5632], 2,
              8192, True, heads=heads, hd=hd)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_phi4(torch, entries):
    """Phase 17, the combined [gate; up] and the per-layer SWA array at full
    width, the DeepSeek weights freed first: (a) Phi-4 with 2 layers against
    the CPU (phase 3's rule; the fused attn_qkv and the combined ffn_up as
    the file has them, through the loader's fuse step, so the decode steps
    take D on the renamed ffn_gateup, and E); (b) 4 Phi-4-width layers with
    the aperiodic SWA array (1, 0, 1, 1) on the iSWA ring in bf16 and on
    the card's full cache against the CPU (phase_ring_parity: the window
    cut to 128, a ring of 192, prompts of 512 and 250, D in the decode
    steps); (c) the kernel rows (phase_phi4_kernels); (d) the 40-layer
    Phi-4 model drawn on the card: its engine slice with
    TPULLM_FLASH_DECODE=1 (A, B, C, D, E and the store launched, F not;
    every prefill attention call on C), its decode-step profile as graph
    replays and eagerly, and one prefill profile; (e) its server
    (phase_q8_server: 4 slots of 8192, int8 KV, E on, a burst of
    6000/2000/700/40 tokens, D launched, a decode chunk profiled). ->
    launch counts by path."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    counts = {}
    label = "Phi-4"
    t = time.perf_counter()
    c = phase_parity(torch, f"{label} (depth cut from {PHI4['n_layer']})", seed=23,
                     flash_decode="1", last_only=True, **dict(PHI4, n_layer=2),
                     generator=torch.Generator(device="cuda").manual_seed(23))
    counts[f"{label} 2-layer"] = c
    missing = [k for k in PHI4_KERNELS if c[k] <= 0]
    if missing or c["moe_gmm"]:
        raise AssertionError(f"{label} parity: kernels not launched {missing}, moe_gmm "
                             f"{c['moe_gmm']}")
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} 4-layer SWA array ring"] = phase_ring_parity(
        torch, f"{label} width, SWA array {[int(f) for f in PHI4_SWA]} (depth cut from "
        f"{PHI4['n_layer']}, window {PHI4_RING_WINDOW})", PHI4, len(PHI4_SWA),
        dict(sliding_window=PHI4_RING_WINDOW, swa_layer_pattern=PHI4_SWA, swa_pattern=2),
        seed=24, lens=PHI4_RING_LENS, chunk=PHI4_RING_CHUNK, layer_kernel=True)["ring"]
    log(f"phase ring parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_phi4_kernels(torch, entries)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_kmajor_q4k_fast(**dict(PHI4, n_layer=slice_depth(label, PHI4["n_layer"])),
                                        seed=0, centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_w = sum(math.prod(v.shape) for v in params["layers"].values()
              if hasattr(v, "qtype")) + 2 * cfg.vocab_size * cfg.n_embd
    kv = 4 * 8192 * cfg.n_layer * cfg.n_head_kv * (cfg.head_dim + cfg.head_dim_v + 8)
    log(f"slice {label}: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB "
        f"({n_w / 1e9:.3f} B weights, {model_gb(params) * 1e9 / n_w:.3f} bytes a weight) in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} heads {cfg.n_head}/"
        f"{cfg.n_head_kv} of {cfg.head_dim} n_ff {cfg.n_ff} rope {cfg.rope_type} "
        f"{cfg.rope_base:g} window {cfg.sliding_window} tied {cfg.tie_embeddings}; layer "
        f"tensors {sorted(params['layers'])}; the q8 server's KV over 4 x 8192 slots "
        f"{kv / 1e9:.3f} GB")
    routes = {}
    counted_route = route_counter(routes, lambda a, r: ("prefill" if a[2] > 1 else "decode", r))
    set_flash_decode("1")
    try:
        with mock.patch.object(llama, "attention_route", counted_route):
            counts[f"{label} slice"], eng, eager, prompts = phase_slice(
                torch, label, cfg, params, cfg.vocab_size, PHI4_KERNELS, ("moe_gmm",))
        log(f"slice {label}: attention routes of every call (prefill or decode, route) "
            f"{ {f'{a} {b}': n for (a, b), n in routes.items()} }")
        want = {("prefill", "flash_attention"), ("decode", "flash_decode")}
        if set(routes) != want:
            raise AssertionError(f"{label} slice: attention routes {routes}")
        out = phase_decode(torch, eng, prompts, f" {label} graph")
        step = out["graph_capture_counts_per_step"] or {}
        per_step = {"layer_kernel": cfg.n_layer, "kv_store": cfg.n_layer,
                    "flash_decode": cfg.n_layer}
        if {k: step.get(k) for k in per_step} != per_step:
            raise AssertionError(f"{label} decode step: launches {step}, want {per_step} (D, "
                                 "the store and E once a layer)")
        phase_decode(torch, eager, prompts, f" {label} eager")
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "kv_store"),
                              f" {label}")
    finally:
        set_flash_decode(None)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} server"] = phase_q8_server(torch, cfg, params, label, PHI4_SERVER_PROMPTS,
                                                must=("layer_kernel",), must_not=("moe_gmm",))
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# gpt-oss-20b (openai/gpt-oss-20b config.json; the GGUF's arch gpt-oss):
# hidden 2880, 24 layers, 64/8 heads of 64 (a GQA group of 8), 32 experts of
# 2880, top-4, vocab 201088, an untied lm_head, a sliding window of 128 on
# every other layer (llama.cpp sets that pattern in code for this arch; here
# the per-layer array 1, 0, 1, 0, ... as a file's key would give it),
# rope_theta 150000 with YaRN x32 over an original context of 4096, rms
# 1e-5, q/k/v/o biases, per-head sinks, the experts' and the router's
# biases, swiglu_oai; expert_weights_norm, the softmax over the selected
# logits of llama.cpp's routing. K 2880 has no K-major tile, so the experts
# (MXFP4), q/k/v, the embedding and the lm_head (Q8_0) load planar; wo (K
# 4096) K-major Q8_0
GPTOSS = dict(vocab_size=201088, n_embd=2880, n_layer=24, n_head=64, n_head_kv=8, head_dim=64,
              n_expert=32, n_expert_used=4, n_ff_exp=2880, sliding_window=128,
              swa_layer_pattern=(1, 0) * 12, rope_base=150000.0, rms_eps=1e-5,
              cfg_fields=dict(rope_scaling="yarn", rope_scale=32.0, rope_orig_ctx=4096,
                              n_ctx_train=131072, expert_weights_norm=True))
# each server's burst, 4 requests on 4 slots: short, as each 512-row chunk
# takes ~2.5 s through the planar expert loop and each capture of a decode
# step (~60000 kernels) ~9 s on an H100 80GB HBM3 at 700 W; under 512
# tokens of depth with the text request, so one view bucket, one capture
GPTOSS_SERVER_PROMPTS = [480, 200, 80, 40]
GPTOSS_CTX = 4096  # each server's slots
# tokens a request, and the slice's (one decode chunk): the planar expert
# loop makes a step slow, as DeepSeek-V2-Lite's (DS_NEW)
GPTOSS_NEW = 8
GPTOSS_TEXT_TOKENS = 200  # each server's text request
# A on wo and B on its prefill, E at head dim 64 with sinks, the store; C
# (sinks), D (experts), F and the skip (a biased planar stack) off the path
GPTOSS_KERNELS = ("qmm_splitk", "qmm", "flash_decode", "kv_store")

GPTOSS_OFF = ("flash_attention", "layer_kernel", "moe_gmm", "qmm_experts")


def synth_gptoss_on_card(torch, n_layer=None, seed=0):
    """synth_gptoss of gpt-oss-20b on the card, cut to ``n_layer`` layers
    (the SWA array cut with it)."""
    from tpullm_torch.utils.synth import synth_gptoss

    spec = dict(GPTOSS)
    if n_layer is not None:
        spec.update(n_layer=n_layer, swa_layer_pattern=spec["swa_layer_pattern"][:n_layer])
    cfg, params = synth_gptoss(**spec, seed=seed, device="cuda")
    torch.cuda.synchronize()
    return cfg, params


def phase_gptoss_parity(torch, label, seed):
    """Phase 18a: gpt-oss-20b at full width cut to one layer (its SWA
    layer: window 128), kernels on the card against the plain path on a CPU
    copy in f32, teacher-forced with the card's greedy picks: a prefill of 2
    prompts of 200 and 150 tokens (past the window; left-padded; the lm_head
    at the last position alone) and one decode step with
    TPULLM_FLASH_DECODE=1 over a 256-slot bf16 cache (the CPU sides f32 and
    bf16). Tolerance: phase 3's rule, 4x the NMSE of the same plain path in
    bf16. A (wo's decode product), B (its prefill product), E (head dim 64,
    the sinks, the window) and the store must launch; C, D, F and the skip
    must not. -> the card's launch counts."""
    import numpy as np

    from tpullm_torch.models.llama import KVCache, forward
    from tpullm_torch.ops import _cuda

    cfg, params = synth_gptoss_on_card(torch, 1, seed)
    cpu = plain_cpu_copy(torch, params)
    rng = np.random.default_rng(5)
    lens, S = (200, 150), 256
    B, T = len(lens), max(lens)
    tok = np.zeros((B, T), np.int64)
    posn = np.zeros((B, T), np.int64)
    for b, n in enumerate(lens):
        tok[b, T - n:] = rng.integers(0, cfg.vocab_size, n)
        posn[b, T - n:] = np.arange(n)
    vf = np.asarray([T - n for n in lens], np.int64)
    sides = {}
    for name, dev, dtype in (("card", "cuda", torch.bfloat16), ("cpu", "cpu", torch.float32),
                             ("cpu_bf16", "cpu", torch.bfloat16)):
        sides[name] = dict(p=params if dev == "cuda" else cpu, dev=dev, dtype=dtype,
                           cache=KVCache.create(cfg, B, S, dtype, dev),
                           vf=torch.from_numpy(vf).to(dev))
    errs, ref_errs, agree = [], [], []
    cur_tok, cur_pos = torch.from_numpy(tok), torch.from_numpy(posn)
    slot, T_step = 0, T
    _cuda.reset_counts()
    set_flash_decode("1")
    try:
        with torch.inference_mode():
            for step in range(2):
                out = {}
                for name, sd in sides.items():
                    dev = sd["dev"]
                    t0 = time.perf_counter()
                    lg, _ = forward(sd["p"], cfg, cur_tok.to(dev), cur_pos.to(dev), sd["cache"],
                                    slot, sd["vf"], sd["dtype"],
                                    kv_view_len=None if step == 0 else S, logits_idx=T_step - 1)
                    out[name] = lg[:, -1].float().cpu()
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    sd.setdefault("sec", []).append(time.perf_counter() - t0)
                errs.append(nmse(torch, out["card"], out["cpu"]))
                ref_errs.append(nmse(torch, out["cpu_bf16"], out["cpu"]))
                agree.append((out["card"].argmax(-1) == out["cpu"].argmax(-1)).tolist())
                nxt = out["card"].argmax(-1)
                slot += T_step
                T_step = 1
                cur_tok = nxt[:, None].to(torch.int64)
                cur_pos = torch.tensor([[n + step] for n in lens], dtype=torch.int64)
    finally:
        set_flash_decode(None)
    counts = dict(_cuda.COUNTS)
    tol = TOL_E2E_FACTOR * max(ref_errs)
    log(f"parity 1-layer {label} (its SWA layer, window {cfg.sliding_window}; prefill T={T}, "
        f"prompts {list(lens)}, S={S} + 1 decode step, E on): card vs CPU f32 logits nmse per "
        f"step {[f'{e:.3e}' for e in errs]}; CPU bf16 vs CPU f32 "
        f"{[f'{e:.3e}' for e in ref_errs]}; tol {tol:.3e} ({TOL_E2E_FACTOR:g}x the largest); "
        f"greedy agree {agree}; card s {[round(x, 3) for x in sides['card']['sec']]} cpu f32 s "
        f"{[round(x, 2) for x in sides['cpu']['sec']]} cpu bf16 s "
        f"{[round(x, 2) for x in sides['cpu_bf16']['sec']]}; launches {counts}")
    if not all(math.isfinite(e) for e in errs + ref_errs) or max(errs) >= tol:
        raise AssertionError(f"{label} parity: nmse {errs}, tolerance {tol}")
    missing = [k for k in GPTOSS_KERNELS if counts[k] <= 0]
    extra = [k for k in GPTOSS_OFF if counts[k]]
    if missing or extra:
        raise AssertionError(f"{label} parity: kernels not launched {missing}, launched but "
                             f"off the gpt-oss path {extra}")
    _cuda.reset_counts()
    del params, cpu, sides
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def planar_lm_head_row(torch, timer, cfg, params, g, M=4):
    """The planar Q8_0 lm_head's product at the decode step (no kernel: K
    2880 has no K-major tile, so models/llama.py:forward's qmm dequantizes
    the whole 201088 x 2880 weight and multiplies in f32), as a CUDA graph
    replay as the decode steps take it, beside the bound: the weight's
    bytes read once. -> ms."""
    from tpullm_torch.ops.qmm import qmm

    out = params["output"]
    x = torch.randn((M, 1, cfg.n_embd), generator=g, device="cuda").to(torch.bfloat16)
    run = lambda: qmm(x, out, torch.bfloat16)
    eager_ms = timer(run, 3, warmup=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    ms = timer(graph.replay, 5, warmup=1)
    del graph
    bound, by = bound_of(weight_bytes(out) + M * cfg.n_embd * 2 + M * cfg.vocab_size * 2,
                         2.0 * M * cfg.vocab_size * cfg.n_embd)
    log(f"planar lm_head[{out.qtype.name} {out.layout} {cfg.vocab_size}x{cfg.n_embd},M={M}]: "
        f"ms {ms:.3f} (a graph replay; eagerly {eager_ms:.3f}) bound_ms {bound:.4f} ({by}) "
        f"share_of_bound {bound / ms:.4f}")
    if out.layout != "planar":
        raise AssertionError(f"gpt-oss lm_head layout {out.layout}")
    return ms


def phase_gptoss_kernels(torch, entries, cfg, params):
    """Phase 18b's rows, on the cut gpt-oss-20b model (SLICE_LAYERS)'s own weights
    (its last layer) and heads: kernels A (M = 4) and B (M = 2048) on wo
    (2880 x 4096, Q8_0 K-major); kernel E at head dim 64 with sinks (64/8
    heads) at the q8 server's step (int8, rows at 480/200/80/40 of 4096),
    the ring server's (bf16, a 640-slot ring, window 128, the same
    positions) and the engine slice's (bf16, 4 rows at slot 540 of 1024);
    the store at 8 kv heads of 64 (the q8 server's step and a 512-row chunk,
    the engine's bf16 step); the no-kernel rows: the planar expert loop's
    ms a MoE layer (graph at M = 4, eager at 4 x 512) and the planar
    lm_head's at M = 4. -> {"decode": ms, "prefill": ms, "lm_head": ms}."""
    from tpullm_torch.ops import _cuda
    from tpullm_torch.ops.qtensor import QTensor

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2424)
    lay = params["layers"]
    li = cfg.n_layer - 1
    path = "gpt-oss-20b"
    w = lay["wo"]
    qt = QTensor(w.qtype, tuple(w.shape[1:]), {k: v[li] for k, v in w.data.items()})
    w_bf16 = qt.dequant(torch.bfloat16)
    K = qt.shape[-1]
    for kname, M in (("qmm_splitk", 4), ("qmm", 2048)):
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        qmm_row(torch, timer, entries, kname,
                f"{kname}[wo {qt.n_out}x{K},{qt.qtype.name},M={M},{path}]", x, qt, w_bf16,
                path=path)
    del qt, w_bf16
    heads, hd = (cfg.n_head, cfg.n_head_kv), cfg.head_dim
    zeros = [0] * 4
    decode_row(torch, timer, entries, g, "gpt-oss-20b q8 server", GPTOSS_CTX,
               GPTOSS_SERVER_PROMPTS, zeros, True, heads=heads, path=f"{path} q8 server", hd=hd,
               sinks=True)
    ring = cfg.sliding_window + 512
    decode_row(torch, timer, entries, g, "gpt-oss-20b ring server", ring, GPTOSS_SERVER_PROMPTS,
               zeros, False, heads=heads, path=f"{path} ring server", hd=hd,
               window=cfg.sliding_window, ring=ring, sinks=True)
    decode_row(torch, timer, entries, g, "gpt-oss-20b engine", 1024, [ENGINE_DECODE_SLOT] * 4,
               zeros, False, heads=heads, path=path, hd=hd, sinks=True)
    store_row(torch, timer, entries, g, "server decode", f"{path} q8 server", 1,
              GPTOSS_SERVER_PROMPTS, 0, GPTOSS_CTX, True, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "server prefill chunk", f"{path} q8 server", 512,
              [1536], 2, GPTOSS_CTX, True, heads=heads, hd=hd)
    store_row(torch, timer, entries, g, "engine decode", path, 1, [ENGINE_DECODE_SLOT] * 4, 0,
              1024, False, heads=heads, hd=hd)
    out = {"decode": moe_loop_row(torch, timer, cfg, lay, li, g, 4, 1),
           "prefill": moe_loop_row(torch, timer, cfg, lay, li, g, 4, 512),
           "lm_head": planar_lm_head_row(torch, timer, cfg, params, g)}
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()
    return out


def phase_gptoss_server(torch, cfg, params, tok, label, kv_dtype, iswa):
    """Phase 18d: gpt-oss-20b behind serve() on a free local port:
    ServerContext with 4 slots of GPTOSS_CTX, decode_chunk 4 (so that the
    streamed request's 8 tokens come in two deltas at least), prefill_chunk
    512, kernel E on, each decode step a CUDA graph replay, a byte-level BPE
    tokenizer of pre-type gpt-4o; ``kv_dtype`` bf16 with ``iswa`` (the
    CLI's default: the 12 SWA layers on a ring of 640 slots) or "q8" (the
    full cache). With the launch counts set to 0: a burst of
    GPTOSS_SERVER_PROMPTS token-id completions (server_burst's checks,
    GPTOSS_NEW tokens each), then a text completion of ~600 tokens, whose
    prompt_tokens must be the in-process encode's and whose text the
    tokenizer's decode of its ids. Every attention call forward makes is
    counted by route: prefill on the einsum path (sinks keep C off), every
    decode call on E (the ring's too), none on C. A, B, E and the store
    launched; C, D, F and the skip not. -> the launch counts."""
    import numpy as np
    import socket
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.ops import _cuda
    from tpullm_torch.server.context import ServerContext
    from tpullm_torch.server.http import serve

    vocab = cfg.vocab_size
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, vocab, n).tolist() for n in GPTOSS_SERVER_PROMPTS]
    text = english_text(tok, GPTOSS_TEXT_TOKENS, seed=6)
    ctx = ServerContext(cfg, params, tok, n_slots=4, max_seq_len=GPTOSS_CTX, decode_chunk=4,
                        prefill_chunk=512, kv_dtype=kv_dtype, iswa=iswa,
                        model_name=label.lower().replace(" ", "-"))
    cache = ctx.memory.cache
    if cache.dual != iswa:
        raise AssertionError(f"server {label}: dual cache {cache.dual}, want {iswa}")
    kv = {"kv_bytes": cache.nbytes, "ring": cache.ring,
          "full_banks": tuple(cache.k.shape), "ring_banks": tuple(cache.kw.shape) if iswa
          else None}
    routes = {}
    counted_route = route_counter(routes, lambda a, r: (
        "ring" if len(a) > 9 and a[9] else "full", "prefill" if a[2] > 1 else "decode", r))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    base = f"http://127.0.0.1:{port}"
    set_flash_decode("1")
    srv = serve(ctx, "127.0.0.1", port, block=False)
    report = {"kv": kv}
    try:
        status, r = http_json(base + "/completion", {"prompt": prompts[-1], "max_tokens": 4,
                                                     "temperature": 0.0})
        if status != 200:
            raise AssertionError(f"server {label} warm-up answered {status}: {r}")
        ctx.control(lambda: [ctx.memory.clear_slot(i) for i in range(ctx.n_slots)])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_counts()
        with mock.patch.object(llama, "attention_route", counted_route):
            res, wall = server_burst(base, prompts, label, tok, vocab=vocab, new=GPTOSS_NEW)
            t = time.perf_counter()
            status, r = http_json(base + "/v1/completions",
                                  {"prompt": text, "max_tokens": GPTOSS_NEW, "temperature": 0.0,
                                   "ignore_eos": True})
            text_wall = time.perf_counter() - t
        torch.cuda.synchronize()
        counts = dict(_cuda.COUNTS)
        n_prompt = len(tok.encode(text, add_special=True, parse_special=True))
        if status != 200:
            raise AssertionError(f"server {label} text request answered {status}: {r}")
        ids = r["choices"][0]["tokens"]
        if not (r["timings"]["prompt_tokens"] == n_prompt and len(ids) == GPTOSS_NEW
                and r["choices"][0]["text"] == visible(tok, ids)):
            raise AssertionError(f"server {label} text request: prompt_tokens "
                                 f"{r['timings']['prompt_tokens']} (want {n_prompt}), "
                                 f"{len(ids)} ids, text {r['choices'][0]['text']!r}")
        report["burst"] = {"requests": [{k: v for k, v in x.items() if k != "ids"} for x in res],
                           "wall_s": wall}
        report["text"] = {"prompt_tokens": n_prompt, "prefill_s": r["timings"]["prefill_s"],
                          "decode_s": r["timings"]["decode_s"], "wall_s": text_wall,
                          "text": r["choices"][0]["text"][:80]}
        report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        set_flash_decode(None)
        srv.shutdown()
        srv.server_close()
        ctx.stop()
    log(f"server {label} (4 slots x {GPTOSS_CTX}, {kv_dtype if kv_dtype == 'q8' else 'bf16'} "
        f"KV, iswa {iswa}, decode_chunk 4, prefill_chunk 512, kernel E; prompts "
        f"{GPTOSS_SERVER_PROMPTS} then a {GPTOSS_TEXT_TOKENS}-token text, {GPTOSS_NEW} new "
        f"tokens each): {json.dumps(report)}")
    log(f"server {label}: attention routes of every call forward made (ring or full banks, "
        f"prefill or decode, route) {({' '.join(k): n for k, n in routes.items()})}; "
        f"launches {counts}")
    missing = [k for k in GPTOSS_KERNELS if counts[k] <= 0]
    extra = [k for k in GPTOSS_OFF if counts[k]]
    bad = [k for k in routes if (k[1] == "decode") != (k[2] == "flash_decode")
           or k[2] == "flash_attention"]
    if missing or extra or bad or (iswa and not any(k[0] == "ring" for k in routes)):
        raise AssertionError(f"server {label}: kernels not launched {missing}, launched but off "
                             f"the gpt-oss path {extra}, routes {routes}")
    del ctx, cache
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_gptoss(torch, entries):
    """Phase 18, attention sinks, the clamped SwiGLU with the experts' and
    the router's biases, planar MXFP4 and E at head dim 64 at full width
    (gpt-oss-20b), the Phi-4 weights freed first: (a) the 1-layer parity
    against the CPU (phase_gptoss_parity); then the model cut to
    SLICE_LAYERS layers (of 24) drawn on
    the card: (b) its kernel rows (phase_gptoss_kernels); (c) the engine
    slice with TPULLM_FLASH_DECODE=1, GPTOSS_NEW greedy tokens (graph, then
    eager: the same tokens and launches; A, B, E and the store launched, C,
    D, F and the skip not; every prefill attention call on the einsum path,
    every decode call on E), its decode-step profile as graph replays (A
    and E and the store once a layer a step) with the planar loop's and the
    planar lm_head's share of the step (the prefill's profile is left out
    for the script's time: its ~63000 launches cost the profiler ~20 s; the
    loop's row at the 4 x 512 prefill and the slice's prefill rate give the
    loop's share of it); (d) the bf16
    iSWA-ring server and the q8 server (phase_gptoss_server), each with a
    synth BPE tokenizer of pre-type gpt-4o. -> launch counts by path."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.tokenizer import Tokenizer
    from tpullm_torch.utils.synth import synth_bpe_vocab

    counts = {}
    label = "gpt-oss-20b"
    t = time.perf_counter()
    counts[f"{label} 1-layer"] = phase_gptoss_parity(torch, label, seed=43)
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_gptoss_on_card(torch, n_layer=slice_depth(label, GPTOSS["n_layer"]),
                                       seed=0)
    lay = params["layers"]
    n_w = sum(math.prod(v.shape) for v in lay.values() if hasattr(v, "qtype")) + 2 * (
        cfg.vocab_size * cfg.n_embd)
    kinds = {k: (v.layout, v.qtype.name) if hasattr(v, "qtype") else tuple(v.shape)
             for k, v in lay.items()}
    log(f"slice {label}: synthesized weights {params_bytes(params) / 1e9:.3f} GB "
        f"({n_w / 1e9:.3f} B weights) in {time.perf_counter() - t:.3f} s; config {cfg.arch} "
        f"heads {cfg.n_head}/{cfg.n_head_kv} of {cfg.head_dim} experts {cfg.n_expert} top-"
        f"{cfg.n_expert_used} of {cfg.n_ff_exp} act {cfg.act_fn} renorm "
        f"{cfg.expert_weights_norm} rope {cfg.rope_type} {cfg.rope_base:g} {cfg.rope_scaling} "
        f"x{cfg.rope_scale:g} over {cfg.rope_orig_ctx} window {cfg.sliding_window} on layers "
        f"{[i for i, f in enumerate(cfg.swa_layer_pattern) if f]}; layer tensors "
        f"{kinds}; "
        f"lm_head {params['output'].layout} {params['output'].qtype.name}")
    t = time.perf_counter()
    rows = phase_gptoss_kernels(torch, entries, cfg, params)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    routes = {}
    counted_route = route_counter(routes, lambda a, r: ("prefill" if a[2] > 1 else "decode", r))
    set_flash_decode("1")
    try:
        with mock.patch.object(llama, "attention_route", counted_route):
            counts[label], eng, eager, prompts = phase_slice(
                torch, label, cfg, params, cfg.vocab_size, GPTOSS_KERNELS, GPTOSS_OFF,
                new=GPTOSS_NEW + 1, samples=1)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        log(f"slice {label}: attention routes of every call (prefill or decode, route) "
            f"{ {f'{a} {b}': n for (a, b), n in routes.items()} }")
        if set(routes) != {("prefill", "einsum"), ("decode", "flash_decode")}:
            raise AssertionError(f"{label} slice: attention routes {routes}")
        out = phase_decode(torch, eng, prompts, f" {label} graph", profiled_steps=1, steps=4)
        step = out["graph_capture_counts_per_step"] or {}
        per_step = {"qmm_splitk": cfg.n_layer, "flash_decode": cfg.n_layer,
                    "kv_store": cfg.n_layer}
        if {k: step.get(k) for k in per_step} != per_step or any(step.get(k)
                                                                  for k in GPTOSS_OFF):
            raise AssertionError(f"{label} decode step: launches {step}, want {per_step} (A on "
                                 "wo, E and the store once a layer)")
    finally:
        set_flash_decode(None)
    step_ms = out["wall_ms_q1_median_q3"][1]
    n_moe = cfg.n_layer
    log(f"step {label}: planar expert loop {n_moe} MoE layers x {rows['decode']:.3f} ms (graph) "
        f"at M = 4 = {n_moe * rows['decode']:.2f} ms of the {step_ms:.2f} ms graph decode step "
        f"(share {n_moe * rows['decode'] / step_ms:.3f}; device busy "
        f"{out['device_busy_ms_per_step']:.2f} ms); planar lm_head {rows['lm_head']:.3f} ms "
        f"(share {rows['lm_head'] / step_ms:.3f}); the loop x {rows['prefill']:.2f} ms at the "
        f"4 x 512 prefill = {n_moe * rows['prefill']:.1f} ms")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tok = Tokenizer(synth_bpe_vocab(cfg.vocab_size, pre="gpt-4o"))
    log(f"server {label}: synth_bpe_vocab({cfg.vocab_size}, pre='gpt-4o') and its tokenizer in "
        f"{time.perf_counter() - t:.3f} s")
    counts[f"{label} ring server"] = phase_gptoss_server(torch, cfg, params, tok,
                                                         f"{label} ring", torch.bfloat16, True)
    counts[f"{label} q8 server"] = phase_gptoss_server(torch, cfg, params, tok, f"{label} q8",
                                                       "q8", False)
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, lay, tok
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Llama-4-Scout-17B-16E (meta-llama/Llama-4-Scout-17B-16E config.json,
# text_config): hidden 5120, 48 layers, 40/8 heads of 128 (a GQA group of 5),
# 16 routed experts of intermediate_size 8192, top-1 (num_experts_per_tok) by
# sigmoid (the arch row), a shared expert of 8192 beside them on every layer
# (interleave_moe_layer_step 1; the GGUF's shared expert carries no gate),
# intermediate_size_mlp 16384 (which no Scout layer reads), vocab 202048,
# untied, rope_theta 5e5 (interleaved pairs: the arch row), attention chunks
# of 8192 on 3 layers of 4 and no RoPE on every 4th (the row's pattern 4 and
# no_rope_interval 4), attn_temperature_tuning with floor_scale 8192 and
# attn_scale 0.1, use_qk_norm (the weightless L2 QK norm), rms_norm_eps 1e-5.
# Q4_K K-major, drawn on the card (synth_moe_q4k with its generator). Its
# llama3 rope factors (a GGUF's rope_freqs tensor) are read by neither
# package (ROADMAP §3): not drawn
SCOUT = dict(arch="llama4", vocab_size=202048, n_embd=5120, n_layer=48, n_head=40, n_head_kv=8,
             head_dim=128, n_ff=16384, n_ff_exp=8192, n_expert=16, n_expert_used=1,
             n_ff_shexp=8192, shexp_gate=False, rope_base=5e5, rms_eps=1e-5, exact_vocab=True,
             cfg_fields=dict(sliding_window=8192, n_ctx_train=10485760))
# the llama4.* keys a converted Scout file holds, its chunk among them
# (llama.cpp appears to fix the chunk at 8192 in code; the JAX parser and the
# port read this key, so the phase writes it: ROADMAP §3)
SCOUT_KEYS = {"context_length": 10485760, "embedding_length": 5120, "block_count": 48,
              "feed_forward_length": 16384, "expert_feed_forward_length": 8192,
              "attention.head_count": 40, "attention.head_count_kv": 8,
              "attention.key_length": 128, "attention.value_length": 128,
              "rope.dimension_count": 128, "rope.freq_base": 5e5,
              "attention.layer_norm_rms_epsilon": 1e-5, "expert_count": 16,
              "expert_used_count": 1, "interleave_moe_layer_step": 1, "vocab_size": 202048,
              "attention.sliding_window": 8192}
# the depth of the model phase 19 draws: 48 layers in Q4_K K-major would take
# ~79.8 GB (1.627 GB a layer and 1.68 GB of embedding and lm_head: Q4_K's f32
# d a 32-group at K 5120), no room beside the cache on 80 GB; 24 (six iRoPE
# periods) take ~40.7 GB
SCOUT_SLICE_LAYERS = 12  # cut from 24 for phase 21's seconds
SCOUT_PARITY_LAYERS = 4  # one iRoPE period: layer 3 NoPE
# the server's burst, 4 requests on 4 slots of 16384: the 9000-token prompt
# past the 8192 chunk and the temperature floor (positions 8191 on)
SCOUT_SERVER_PROMPTS = [9000, 2000, 700, 40]
SCOUT_CTX = 16384
SCOUT_NEW = 8  # tokens a server request
# the server's decode chunk: two chunks a request, so the streamed request
# sends its tokens in more than one delta, as server_burst checks
SCOUT_CHUNK = 4
# A, B, C, F, the store, the skip and E (TPULLM_FLASH_DECODE on); D off (MoE)
SCOUT_KERNELS = MOE_KERNELS + ("flash_decode",)


class GGUFMeta:
    """The metadata face of a GGUF file, all that config_from_gguf reads:
    ``arch``'s keys without their prefix."""

    def __init__(self, arch: str, keys: dict):
        self.architecture = arch
        self.metadata = {"general.architecture": arch, **{f"{arch}.{k}": v
                                                          for k, v in keys.items()}}

    def get(self, key, default=None):
        return self.metadata.get(key, default)


def synth_scout(torch, n_layer, seed):
    """Llama-4-Scout cut to ``n_layer`` layers, drawn on the card
    (synth_moe_q4k with a torch.Generator for every Q4_K weight), its
    config checked field for field against config_from_gguf of SCOUT_KEYS
    at that depth. -> (cfg, params)."""
    from tpullm_torch.models.config import config_from_gguf

    cfg, params = synth_moe(SCOUT, n_layer=n_layer, seed=seed, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    parsed = config_from_gguf(GGUFMeta("llama4", dict(SCOUT_KEYS, block_count=n_layer)))
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    if fields(parsed) != fields(cfg):
        diff = {k: (v, fields(cfg)[k]) for k, v in fields(parsed).items() if fields(cfg)[k] != v}
        raise AssertionError(f"Llama-4-Scout: the synth's config differs from its keys' {diff}")
    return cfg, params


def phase_scout_kernels(torch, entries, cfg, params):
    """Phase 19's kernel rows, on the Llama-4-Scout model's own weights (its
    last layer) and heads: A at M = 4 on wqkv (the fused 5120 + 2 x 1024
    rows), wo, the shared expert's gate and down and the 202048-row lm_head,
    B on wqkv at M = 2048 (the slice's prefill); the skip at 16 experts
    top-1 on gate (8192 x 5120) and down (5120 x 8192, combining) at M = 1,
    4 and 16; F at 16 experts over 2048 top-1 assignments; C chunked at
    G = 5 for a 512-row block at positions 8000-8511 over a 16384-slot view
    (the 8192 chunk boundary inside it) beside SDPA with the chunk mask; E
    chunked at G = 5 at the server's step (int8) and the engine's (bf16),
    rows at 12000/9000/8200/40 of a 16384-slot view."""
    from tpullm_torch.ops import _cuda
    from tpullm_torch.ops.moe_gmm import live_tiles, sort_by_expert
    from tpullm_torch.ops.qtensor import QTensor

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2525)
    lay = params["layers"]
    li = cfg.n_layer - 1
    path = "Llama-4-Scout"

    def layer_qt(w):
        return QTensor(w.qtype, tuple(w.shape[1:]), {k: v[li] for k, v in w.data.items()})

    rows = [("wqkv", layer_qt(lay["wqkv"]), ((("qmm_splitk", 4), ("qmm", 2048)))),
            ("wo", layer_qt(lay["wo"]), (("qmm_splitk", 4),)),
            ("shared gate", layer_qt(lay["ffn_gate_shexp"]), (("qmm_splitk", 4),)),
            ("shared down", layer_qt(lay["ffn_down_shexp"]), (("qmm_splitk", 4),)),
            ("lm_head", params["output"], (("qmm_splitk", 4),))]
    for name, qt, ms in rows:
        w_bf16 = qt.dequant(torch.bfloat16)
        K = qt.shape[-1]
        for kname, M in ms:
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            qmm_row(torch, timer, entries, kname,
                    f"{kname}[{name} {qt.n_out}x{K},{qt.qtype.name},M={M},{path}]", x, qt,
                    w_bf16, path=path)
            del x
        del w_bf16
        torch.cuda.empty_cache()
    used = cfg.n_expert_used
    for M in (1, 4, 16):
        skip_row(torch, timer, entries, "gate", lay["moe_gate_exps"], li, M, g, used, path)
        skip_row(torch, timer, entries, "down", lay["moe_down_exps"], li, M, g, used, path)
    E, M = cfg.n_expert, 2048
    top_i = torch.rand((M, E), generator=g, device="cuda").argsort(-1)[:, :used]
    order, dest, te, Mp = sort_by_expert(top_i, E, M)
    live = live_tiles(dest, te, Mp)
    for name, qt in (("gate", lay["moe_gate_exps"]), ("down", lay["moe_down_exps"])):
        K = qt.shape[-1]
        x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        xs = torch.zeros((Mp, K), dtype=torch.bfloat16, device="cuda")
        xs[dest] = x[order // used]
        gmm_row(torch, timer, entries, f"{name} of MoE layer {li}", qt, li, xs, te, live,
                M * used, path)
        del x, xs
    heads, w = (cfg.n_head, cfg.n_head_kv), cfg.sliding_window
    attn_row(torch, timer, entries, g, B=1, T=512, S=SCOUT_CTX, n_past=8000, vf=[0],
             path=f"{path} server", heads=heads, window=w, chunked=True)
    slots = [12000, 9000, 8200, 40]
    decode_row(torch, timer, entries, g, f"{path} server", SCOUT_CTX, slots, [0] * 4, True,
               heads=heads, path=f"{path} server", window=w, chunked=True)
    decode_row(torch, timer, entries, g, f"{path} engine", SCOUT_CTX, slots, [0] * 4, False,
               heads=heads, path=path, window=w, chunked=True)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()


def phase_scout(torch, entries):
    """Phase 19, the iRoPE decoders at full width (Llama-4-Scout), the
    gpt-oss weights freed first: (a) the 4-layer parity against the CPU
    (phase 6's rule and routing count; layers 0-2 chunked, layer 3 NoPE,
    the L2 QK norm on the roped ones, top-1 of 16 by sigmoid, the ungated
    shared expert); then the model cut to SCOUT_SLICE_LAYERS layers, drawn on the
    card, its config parsed from Scout's keys (synth_scout): (b) its
    kernel rows (phase_scout_kernels); (c) the slice with
    TPULLM_FLASH_DECODE=1 (4 requests, graph replays, then eagerly: the same
    tokens and launch counts; A, B, C, E, F, the store and the skip
    launched, D not; every prefill call of a chunked layer on C), its
    decode-step profile as graph replays (the skip 3 a layer; A on wqkv, wo
    and the shared expert's three a layer and the lm_head; E and the store
    once a layer) and a prefill profile; (d) its q8 server (phase_q8_server:
    4 slots of 16384, E on, token ids, a burst of 9000/2000/700/40 tokens,
    8 new each in decode chunks of 4, a decode chunk graph against eager
    and profiled).
    -> launch counts by path."""
    from unittest import mock

    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import nope_flags

    counts = {}
    label = "Llama-4-Scout"
    t = time.perf_counter()
    spec = dict(SCOUT, generator=torch.Generator(device="cuda").manual_seed(53))
    counts[f"{label} {SCOUT_PARITY_LAYERS}-layer"] = phase_moe_parity(
        torch, f"{label} (depth cut from {SCOUT['n_layer']})", spec, seed=53,
        n_layer=SCOUT_PARITY_LAYERS, force_routing=True)
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_scout(torch, SCOUT_SLICE_LAYERS, seed=0)
    lay = params["layers"]
    n_w = sum(math.prod(v.shape) for v in lay.values() if hasattr(v, "qtype")) + 2 * (
        cfg.vocab_size * cfg.n_embd)
    log(f"slice {label}: synthesized Q4_K kmajor weights {params_bytes(params) / 1e9:.3f} GB "
        f"({n_w / 1e9:.3f} B weights) in {time.perf_counter() - t:.3f} s; config {cfg.arch} "
        f"rope {cfg.rope_type} {cfg.rope_base:g} heads {cfg.n_head}/{cfg.n_head_kv} of "
        f"{cfg.head_dim} experts {cfg.n_expert} top-{cfg.n_expert_used} of {cfg.n_ff_exp} "
        f"gating {cfg.expert_gating} shared {tuple(lay['ffn_gate_shexp'].shape[1:])} chunk "
        f"{cfg.sliding_window} on layers {[i for i, w in enumerate(llama.layer_windows(cfg)) if w]}"
        f" NoPE layers {[i for i, f in enumerate(nope_flags(cfg)) if f]} temperature scale "
        f"{cfg.attn_temp_scale:g} floor {cfg.attn_temp_floor} L2 QK norm {cfg.qk_l2_norm}")
    t = time.perf_counter()
    phase_scout_kernels(torch, entries, cfg, params)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    routes = {}
    # each prefill call's (chunked, route): a chunked call must take C
    counted_route = route_counter(routes, lambda a, r: (
        "prefill" if a[2] > 1 else "decode", "chunked" if a[-1] else "full", r))
    set_flash_decode("1")
    try:
        with mock.patch.object(llama, "attention_route", counted_route):
            counts[label], eng, eager, prompts = phase_slice(
                torch, label, cfg, params, cfg.vocab_size, SCOUT_KERNELS, ("layer_kernel",))
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        log(f"slice {label}: attention routes of every call (prefill or decode, chunked or "
            f"full, route) { {' '.join(k): n for k, n in routes.items()} }")
        want_routes = {("prefill", "chunked", "flash_attention"),
                       ("prefill", "full", "flash_attention"),
                       ("decode", "chunked", "flash_decode"), ("decode", "full", "flash_decode")}
        if set(routes) != want_routes:
            raise AssertionError(f"{label} slice: attention routes {routes}")
        out = phase_decode(torch, eng, prompts, f" {label} graph", profiled_steps=2, steps=16)
        step = out["graph_capture_counts_per_step"] or {}
        L = cfg.n_layer
        want = {"qmm_experts": 3 * L, "qmm_splitk": 5 * L + 1, "flash_decode": L,
                "kv_store": L}
        if {k: step.get(k) for k in want} != want or step.get("layer_kernel"):
            raise AssertionError(f"{label} decode step: launches {step}, want {want} (the skip "
                                 "on gate, up and down a layer; A on wqkv, wo and the shared "
                                 "expert's three a layer and the lm_head; E and the store "
                                 "once a layer)")
    finally:
        set_flash_decode(None)
    phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "moe_gmm"),
                          f" {label}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} server"] = phase_q8_server(torch, cfg, params, label, SCOUT_SERVER_PROMPTS,
                                                n_ctx=SCOUT_CTX, must=("moe_gmm", "qmm_experts"),
                                                decode_chunk=SCOUT_CHUNK, new=SCOUT_NEW)
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, lay
    gc.collect()
    torch.cuda.empty_cache()
    return counts

# phase 20's server: phase 10's chats and a shorter burst on 4 slots of 4096
# (each prompt one 512-row prefill chunk, 16 new tokens: two decode chunks),
# and its slice's tokens a request (8 decode steps), each cut for the
# script's time limit: the chunk bank's loop takes ~51 ms a layer of an
# eager 512-row chunk and ~0.5 s an eager decode step at 12 layers
GROVEMOE_SERVER_PROMPTS = [480, 200, 80, 40]
GROVEMOE_SERVER_NEW = 16
GROVEMOE_NEW = 9


def chunk_bank_row(torch, timer, cfg, lay, li, g, B, T):
    """GroveMoE's chunk-expert bank a layer (models/llama.py:chunk_bank, no
    kernel of its own) on the card, on layer li of ``lay``: x (B, T,
    n_embd) as the routed experts' output, a routing of E top-k by sigmoid
    from random logits, the bank's loop route (every chunk on every row;
    gate/up through kernel A or B, the planar Q8_0 down at K 128 dequantized
    whole and multiplied). Timed as its path runs it: a decode call (B*T <=
    16) as a CUDA graph replay, beside the same call eagerly; a prefill call
    eagerly. The bound reads the chunks the rows name, once. Also counts the
    rows that name one chunk twice. -> ms (the graph replay's at decode)."""
    from tpullm_torch.models.llama import chunk_bank, moe_route, top_k

    qw = {k: v for k, v in lay.items() if hasattr(v, "qtype")}
    ch = [qw[k] for k in ("moe_gate_chexps", "moe_up_chexps", "moe_down_chexps")]
    E, used, grp = cfg.n_expert, cfg.n_expert_used, cfg.n_group_experts
    x = torch.randn((B, T, cfg.n_embd), generator=g, device="cuda").to(torch.bfloat16)
    logits = torch.randn((B, T, E), generator=g, device="cuda") * 1.3
    probs = torch.softmax(logits, -1)
    top_i = top_k(torch.sigmoid(logits), used)
    E_ch, used_ch = E // grp, min(used, E // grp)
    route = moe_route(True, B * T, *ch, cfg.n_embd, used_ch)
    run = lambda: chunk_bank(x, probs, top_i, qw, li, cfg, torch.bfloat16)
    ms = eager_ms = timer(run, 5 if B * T <= 16 else 2, warmup=1)
    if B * T <= 16:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        ms = timer(graph.replay, 5, warmup=1)
        del graph
    chunk_i = (top_i[..., :used_ch] // grp).reshape(-1, used_ch)
    twice = int((chunk_i[:, :, None] == chunk_i[:, None, :]).triu(1).any(-1).any(-1).sum())
    named = int(torch.unique(chunk_i).numel())
    per_chunk = sum(weight_bytes(t) for t in ch) / (ch[0].shape[0] * E_ch)
    bound, by = bound_of(named * per_chunk, 2.0 * 3 * B * T * cfg.n_embd * used_ch
                         * cfg.n_ff_chexp)
    log(f"chunk bank[{route},B={B},T={T},{E_ch} chunk experts of {cfg.n_ff_chexp}x"
        f"{cfg.n_embd},top-{used_ch} by pick // {grp},down {ch[2].qtype.name} "
        f"{ch[2].layout}]: ms {ms:.3f}"
        + (f" (a graph replay; eagerly {eager_ms:.3f})" if B * T <= 16 else " (eagerly)")
        + f" bound_ms {bound:.4f} ({by}) share_of_bound {bound / ms:.4f}; chunks named "
        f"{named}, rows naming one chunk twice {twice} of {B * T}")
    if route != "loop":
        raise AssertionError(f"chunk bank of {cfg.arch} at B*T={B * T}: route {route}")
    return ms


def phase_grovemoe_kernels(torch, entries, cfg, params):
    """Phase 20's rows, on the cut GroveMoE-Inst model's own weights (its
    last layer): A at M = 4 on one chunk's gate (128 x 2048, Q4_K); the
    chunk bank's ms a layer at M = 4 (a graph replay) and at the 4 x 512
    prefill (chunk_bank_row); C at grok-1's heads (48/8 of 128, softcap 30)
    on the engine's prefill shape and E at those heads on the server's
    int8 step (E runs on the server's path only), each beside
    flex_attention with the softcap (the GroveMoE paths launch C and E at
    their own heads).
    -> {"decode": ms, "prefill": ms} of the chunk bank a layer."""
    from tpullm_torch.models.llama import expert_weight
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2626)
    lay, li = params["layers"], cfg.n_layer - 1
    path = "GroveMoE-Inst"
    qt = expert_weight(lay["moe_gate_chexps"], li, 0)
    w_bf16 = qt.dequant(torch.bfloat16)
    x = torch.randn((4, qt.shape[-1]), generator=g, device="cuda").to(torch.bfloat16)
    qmm_row(torch, timer, entries, "qmm_splitk",
            f"qmm_splitk[chunk gate {qt.n_out}x{qt.shape[-1]},{qt.qtype.name},M=4,{path}]", x,
            qt, w_bf16, path=path)
    del w_bf16, x
    bank = {"decode": chunk_bank_row(torch, timer, cfg, lay, li, g, 4, 1),
            "prefill": chunk_bank_row(torch, timer, cfg, lay, li, g, 4, 512)}
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
             path=path, heads=GROK_HEADS, softcap=GROK_SOFTCAP)
    decode_row(torch, timer, entries, g, "grok-1 heads server", 4096, QWEN_SERVER_PROMPTS,
               [0, 0, 0, 0], True, heads=GROK_HEADS, path=f"{path} server",
               softcap=GROK_SOFTCAP)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()
    return bank


def phase_grovemoe(torch, entries):
    """Phase 20, the other MoE families at full width (GroveMoE-Inst), the
    Scout weights freed first: (a) the 1-layer parity against the CPU
    (phase 6's rule and routing count, with the rows that name one chunk
    twice counted); then the model cut to SLICE_LAYERS layers (of 48),
    drawn on the card: (b) its kernel rows (phase_grovemoe_kernels); (c) the
    slice (4 requests of GROVEMOE_NEW tokens, graph replays, then eagerly:
    the same tokens and launch counts; A, B, C, F, the store and the skip
    launched, D not), its
    decode-step profile as graph replays (the skip 3 a layer; A on wqkv, wo
    and each chunk's gate and up a layer, and the lm_head; the store once a
    layer) with the chunk bank's share of the step, and a prefill profile;
    (d) its server (phase_qwen_server: 4 slots of 4096, int8 KV, kernel E,
    the Qwen2-layout tokenizer) with 4 token-id completions
    (GROVEMOE_SERVER_PROMPTS) and 2 chats. -> launch counts by path."""
    counts = {}
    label = "GroveMoE-Inst"
    t = time.perf_counter()
    counts[f"{label} {ONE_LAYER}-layer"] = phase_moe_parity(
        torch, f"{label} (depth cut from {GROVEMOE['n_layer']})", GROVEMOE, seed=13,
        n_layer=ONE_LAYER)
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_moe(GROVEMOE, n_layer=slice_depth(label, GROVEMOE["n_layer"]), seed=0,
                            device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    lay = params["layers"]
    n_w = sum(math.prod(v.shape) for v in lay.values() if hasattr(v, "qtype")) + 2 * (
        cfg.vocab_size * cfg.n_embd)
    log(f"slice {label}: synthesized weights {params_bytes(params) / 1e9:.3f} GB "
        f"({n_w / 1e9:.3f} B weights) in {time.perf_counter() - t:.3f} s; config {cfg.arch} "
        f"rope {cfg.rope_type} {cfg.rope_base:g} heads {cfg.n_head}/{cfg.n_head_kv} of "
        f"{cfg.head_dim} qk_norm {cfg.attn_qk_norm} experts {cfg.n_expert} top-"
        f"{cfg.n_expert_used} of {cfg.n_ff_exp} renorm {cfg.expert_weights_norm} chunk experts "
        f"{cfg.n_expert // cfg.n_group_experts} of {cfg.n_ff_chexp} (group "
        f"{cfg.n_group_experts}, scale {cfg.expert_group_scale:g}); layouts "
        f"{ {k: (v.qtype.name, v.layout) for k, v in lay.items() if hasattr(v, 'qtype')} }")
    t = time.perf_counter()
    bank = phase_grovemoe_kernels(torch, entries, cfg, params)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[label], eng, eager, prompts = phase_slice(
        torch, label, cfg, params, cfg.vocab_size, MOE_KERNELS, ("layer_kernel",),
        new=GROVEMOE_NEW, samples=1)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    out = phase_decode(torch, eng, prompts, f" {label} graph", profiled_steps=2, steps=16)
    step = out["graph_capture_counts_per_step"] or {}
    L, E_ch = cfg.n_layer, cfg.n_expert // cfg.n_group_experts
    want = {"qmm_experts": 3 * L, "qmm_splitk": (2 + 2 * E_ch) * L + 1, "kv_store": L}
    if {k: step.get(k) for k in want} != want or step.get("layer_kernel"):
        raise AssertionError(f"{label} decode step: launches {step}, want {want} (the skip on "
                             "gate, up and down a layer; A on wqkv, wo and each chunk's gate "
                             "and up a layer and the lm_head; the store once a layer)")
    pre = phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "moe_gmm"),
                                f" {label}")
    step_ms = out["wall_ms_q1_median_q3"][1]
    log(f"chunk bank {label}: {L} layers x {bank['decode']:.3f} ms (graph) at M = 4 = "
        f"{L * bank['decode']:.2f} ms of the {step_ms:.2f} ms graph decode step (share "
        f"{L * bank['decode'] / step_ms:.3f}); x {bank['prefill']:.2f} ms at the 4 x 512 "
        f"prefill = {L * bank['prefill']:.1f} ms of its {pre['wall_ms']:.1f} ms (share "
        f"{L * bank['prefill'] / pre['wall_ms']:.3f})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} server"] = phase_qwen_server(torch, cfg, params, label, MOE_SERVER_KERNELS,
                                                  GROVEMOE_SERVER_PROMPTS, GROVEMOE_SERVER_NEW)
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, lay
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Gemma-3n-E4B (google/gemma-3n-E4B-it config.json, text_config): hidden 2048,
# 35 layers, 8/2 heads of 256 (a GQA group of 4), intermediate 16384, vocab
# 262400, the per-layer table's vocab_size_per_layer_input 262144 rows of
# hidden_size_per_layer_input 256 a layer, num_kv_shared_layers 15 (20 owning
# layers, the GGUF parser's min(20, n_layer)), sliding_window 512 with every
# 5th layer full, rope_theta 1e6, rope_local_base_freq 1e4, AltUp over 4
# streams (altup_active_idx 0), laurel_rank 64, activation sparsity 0.95 on
# the first 10 layers (the arch row's n_layer_sparsity and icdf(0.95)),
# final_logit_softcapping 30, rms_norm_eps 1e-6, tied embeddings. The values
# are recalled, not read from the published files (PERF.md §6). Q4_K: the
# layer matrices K-major, the per-layer projection (K 256) and the per-layer
# table (K 8960) planar, the embedding and the stream's projection K-major
GEMMA3N = dict(vocab_size=262400, n_embd=2048, n_layer=35, n_head=8, n_head_kv=2,
               head_dim=256, n_ff=16384, table_rows=262144, n_embd_per_layer=256,
               sliding_window=512, rope_base=1e6, rope_base_swa=1e4, rms_eps=1e-6)
# the parity run's depth cut: 10 layers, the first 5 owning (layers 0-3 SWA,
# layer 4 full), so layers 5-8 read bank 3 and layer 9 bank 4, and every
# layer takes the sparsity cut
GEMMA3N_PARITY = dict(n_layer=10, n_layer_kv_from_start=5)
GEMMA3N_NEW = 17  # tokens a slice request (the first from the prefill)
GEMMA3N_CTX = 4096  # each server slot
GEMMA3N_SERVER_PROMPTS = [2000, 700, 300, 40]  # the burst: past the 512 window
GEMMA3N_KERNELS = ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store")


def plain_products_rows(torch, timer, cfg, params, g):
    """The products of phase 21's path that no kernel runs, on the slice
    model's last layer, each timed (eagerly) at the decode step's M = 4
    and the 4 x 512 prefill's M = 2048 beside its bound: the per-layer
    projection back to n_embd (planar Q4_K at K 256: dequantized whole,
    then torch.matmul), the f32 LAuReL pair (n_embd -> 64 -> n_embd), and
    AltUp's f32 stream expansion (3 x n_embd x n_embd, once a forward).
    -> {name: {M: ms}}."""
    from tpullm_torch.models.llama import altup_expand
    from tpullm_torch.ops.qmm import qmm

    lay = params["layers"]["__groups__"][-1]
    li = next(iter(lay.values())).shape[0] - 1
    d, P, R = cfg.n_embd, cfg.n_embd_per_layer, lay["laurel_l"].shape[-2]
    proj = lay["per_layer_proj"]
    ll, lr = lay["laurel_l"][li], lay["laurel_r"][li]
    out = {}
    for M in (4, 2048):
        xp = torch.randn((M, P), generator=g, device="cuda").to(torch.bfloat16)
        xd = torch.randn((1, M, d), generator=g, device="cuda").to(torch.bfloat16)
        runs = {
            "per_layer_proj (planar Q4_K, K 256)": (
                lambda: qmm(xp, proj, torch.bfloat16, li),
                weight_bytes(proj) / proj.shape[0], 2.0 * M * P * d, 0.0),
            "LAuReL pair (f32)": (
                lambda: (xd.float() @ ll.t()) @ lr.t(), 8.0 * d * R, 0.0, 4.0 * M * d * R),
            "AltUp expansion (f32)": (
                lambda: altup_expand(xd, params["altup_proj"], cfg, torch.bfloat16),
                4.0 * 3 * d * d, 0.0, 2.0 * 3 * M * d * d)}
        for name, (fn, nbytes, flops, f32_flops) in runs.items():
            ms = timer(fn, 5, warmup=1)
            bound, by = bound_of(nbytes, flops, f32_flops)
            out.setdefault(name, {})[M] = ms
            log(f"plain product [{name},M={M},Gemma-3n-E4B]: ms {ms:.4f} bound_ms {bound:.4f} "
                f"({by}) share_of_bound {bound / ms:.4f}")
    return out


def phase_gemma3n_kernels(torch, entries, cfg, params):
    """Phase 21's rows: A (M = 4) and B (M = 2048) on random Q4_K weights at
    Gemma-3n-E4B's per-layer input gate (256 x 2048) and the token stream's
    projection (8960 x 2048); C at 8/2 heads of 256 with the window of 512
    on the engine slice's prefill shape (B 4, T 512, S 1024) and E at those
    heads and window on the server's int8 step (rows at 2000/700/300/40 of
    4096) and the engine's bf16 step, each held against its plain version;
    then the plain products on the model's own weights
    (plain_products_rows). -> the plain products' ms."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2727)
    path, heads, hd = "Gemma-3n-E4B", (cfg.n_head, cfg.n_head_kv), cfg.head_dim
    d, win = cfg.n_embd, cfg.sliding_window
    weight_rows(torch, timer, entries, g,
                [("per_layer_inp_gate", [cfg.n_embd_per_layer], d),
                 ("per_layer_model_proj", [cfg.n_layer * cfg.n_embd_per_layer], d)], path)
    attn_row(torch, timer, entries, g, B=4, T=512, S=1024, n_past=0, vf=[0, 212, 312, 412],
             path=path, heads=heads, hd=hd, window=win)
    decode_row(torch, timer, entries, g, "Gemma-3n-E4B server", GEMMA3N_CTX,
               GEMMA3N_SERVER_PROMPTS, [0, 0, 0, 0], True, heads=heads, path=f"{path} server",
               hd=hd, window=win)
    decode_row(torch, timer, entries, g, "Gemma-3n-E4B engine", 1024, [527] * 4,
               [0, 212, 312, 412], False, heads=heads, path=path, hd=hd, window=win)
    plain = plain_products_rows(torch, timer, cfg, params, g)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()
    return plain


def phase_gemma3n(torch, entries):
    """Phase 21, the per-layer-embedding Gemmas at full width
    (Gemma-3n-E4B), the GroveMoE weights freed first: (a) the parity against
    the CPU (phase 3's rule) of 10 layers, 5 of them owning, so one shared
    layer of each kind (SWA: bank 3; full: bank 4) runs, with E on in the
    decode step (A, B, C, E and the store launched, D not); then the
    35-layer model drawn on the card: (b) its kernel rows
    (phase_gemma3n_kernels); (c) the slice with E on (4 requests of
    GEMMA3N_NEW tokens, graph replays, then eagerly: the same tokens and
    launch counts; A, B, C, E and the store launched, D not); (d) its
    decode-step profile as graph replays, whose capture counts a step must
    be A five times a layer (wqkv or the shared layers' wq, wo, gate/up,
    down, the per-layer input gate) plus the stream's projection and the
    lm_head, the store once an owning layer and never on a shared one, E
    once a layer, and no D; and a prefill profile; (e) its server
    (phase_q8_server: 4 slots of GEMMA3N_CTX, int8 KV, E on, the burst of
    GEMMA3N_SERVER_PROMPTS past the window) with a Qwen2-layout tokenizer
    of the model's 262400 rows: 4 token-id completions and 2 chats. ->
    launch counts by path."""
    from tpullm_torch.models.llama import kv_owners, swa_flags
    from tpullm_torch.tokenizer import Tokenizer
    from tpullm_torch.utils.synth import synth_bpe_vocab, synth_gemma3n

    counts = {}
    label = "Gemma-3n-E4B"
    t = time.perf_counter()
    spec = dict(GEMMA3N, **GEMMA3N_PARITY)
    c = phase_parity(torch, f"{label} (depth cut from {GEMMA3N['n_layer']}, owning layers from "
                     f"20 to {GEMMA3N_PARITY['n_layer_kv_from_start']})", seed=21,
                     flash_decode="1", last_only=True, synth=synth_gemma3n, **spec)
    counts[f"{label} {spec['n_layer']}-layer"] = c
    missing = [k for k in GEMMA3N_KERNELS if c[k] <= 0]
    if missing or c["layer_kernel"]:
        raise AssertionError(f"{label} parity: kernels not launched {missing}, layer kernel "
                             f"{c['layer_kernel']}")
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    n_layer = GEMMA3N["n_layer"]
    cfg, params = synth_gemma3n(**GEMMA3N, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    own, shared = params["layers"]["__groups__"]
    layouts = {k: (v.qtype.name, v.layout) for k, v in {**own, **shared}.items()
               if hasattr(v, "qtype")}
    layouts.update({k: (params[k].qtype.name, params[k].layout)
                    for k in ("tok_embd", "per_layer_tok_embd", "per_layer_model_proj")})
    log(f"slice {label}: synthesized weights {params_bytes(params) / 1e9:.3f} GB in "
        f"{time.perf_counter() - t:.3f} s; config {cfg.arch} heads {cfg.n_head}/{cfg.n_head_kv} "
        f"of {cfg.head_dim} n_ff {cfg.n_ff} vocab {cfg.vocab_size} (table "
        f"{params['per_layer_tok_embd'].n_out} rows of {cfg.n_layer} x {cfg.n_embd_per_layer}) "
        f"owning layers {kv_owners(cfg)} windows "
        f"{[cfg.sliding_window if f else 0 for f in swa_flags(cfg)][:5]}... rope "
        f"{cfg.rope_base:g}/{cfg.rope_base_swa:g} altup {cfg.altup_n} sparsity "
        f"{cfg.n_layer_sparsity} layers softcap {cfg.final_logit_softcap:g} embedding_scale "
        f"{cfg.embedding_scale:.4f} attn_scale {cfg.attn_scale:g}; types and layouts {layouts}")
    if n_layer != cfg.n_layer or kv_owners(cfg) != 20:
        raise AssertionError(f"{label}: {cfg.n_layer} layers, {kv_owners(cfg)} owning")
    t = time.perf_counter()
    plain = phase_gemma3n_kernels(torch, entries, cfg, params)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    set_flash_decode("1")
    try:
        counts[label], eng, eager, prompts = phase_slice(
            torch, label, cfg, params, cfg.vocab_size, GEMMA3N_KERNELS, ("layer_kernel",),
            new=GEMMA3N_NEW, samples=1)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        out = phase_decode(torch, eng, prompts, f" {label} graph", profiled_steps=2, steps=16)
    finally:
        set_flash_decode(None)
    step = out["graph_capture_counts_per_step"] or {}
    L, nks = cfg.n_layer, kv_owners(cfg)
    want = {"qmm_splitk": 5 * L + 2, "kv_store": nks, "flash_decode": L}
    if {k: step.get(k) for k in want} != want or step.get("layer_kernel"):
        raise AssertionError(f"{label} decode step: launches {step}, want {want} (A on wqkv or "
                             "wq, wo, gate/up, down and the per-layer input gate a layer, the "
                             "stream's projection and the lm_head; the store once an owning "
                             "layer, none on the shared ones; E once a layer)")
    pre = phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention"), f" {label}")
    step_ms = out["wall_ms_q1_median_q3"][1]
    log(f"plain products {label}: the LAuReL pair {L} x {plain['LAuReL pair (f32)'][4]:.4f} ms "
        f"and the per-layer projection {L} x "
        f"{plain['per_layer_proj (planar Q4_K, K 256)'][4]:.4f} ms at M = 4 against the "
        f"{step_ms:.2f} ms graph decode step; at the 4 x 512 prefill {L} x "
        f"{plain['LAuReL pair (f32)'][2048]:.3f} and {L} x "
        f"{plain['per_layer_proj (planar Q4_K, K 256)'][2048]:.3f} ms of its "
        f"{pre['wall_ms']:.1f} ms")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tok = Tokenizer(synth_bpe_vocab(cfg.vocab_size, layout="qwen2"))
    log(f"server {label}: synth_bpe_vocab({cfg.vocab_size}, layout='qwen2') and its tokenizer "
        f"in {time.perf_counter() - t:.3f} s")
    counts[f"{label} server"] = phase_q8_server(torch, cfg, params, label,
                                                GEMMA3N_SERVER_PROMPTS, n_ctx=GEMMA3N_CTX,
                                                kernels=GEMMA3N_KERNELS, tok=tok)
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, own, shared
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# Apertus-8B (swiss-ai/Apertus-8B-2509 config.json, recalled, not read from
# the published file: PERF.md §6): hidden 4096, 32 layers, 32/8 heads of 128,
# an ungated xIELU MLP of intermediate 21504, vocab 131072, rope_theta 1.2e7,
# rms_norm_eps 1e-5, per-head q/k RMS norms, an untied lm_head; Q4_K (K 21504
# takes a 1536 tile with a 32-group f32 d), the per-layer xielu.* arrays as
# the JAX synth writes them (utils/synth.py:jax_synth_xielu); no rope_freqs
# tensor, which no JAX graph reads
APERTUS = dict(arch="apertus", vocab_size=131072, n_embd=4096, n_layer=32, n_head=32,
               n_head_kv=8, n_ff=21504, rope_base=1.2e7, rms_eps=1e-5, exact_vocab=True,
               cfg_fields=dict(n_ctx_train=65536))
APERTUS_KEYS = {"context_length": 65536, "embedding_length": 4096, "block_count": 32,
                "feed_forward_length": 21504, "attention.head_count": 32,
                "attention.head_count_kv": 8, "attention.key_length": 128,
                "attention.value_length": 128, "rope.freq_base": 1.2e7,
                "rope.dimension_count": 128, "attention.layer_norm_rms_epsilon": 1e-5,
                "vocab_size": 131072}
APERTUS_CTX = 4096  # each server slot
APERTUS_SERVER_PROMPTS = [2000, 700, 300, 40]  # 4 requests on 4 slots
APERTUS_NEW = 33  # tokens a slice request: the prefill's, then 32 greedy steps
APERTUS_SERVER_NEW = 32
APERTUS_KERNELS = ("qmm_splitk", "qmm", "flash_attention", "flash_decode", "kv_store")
# phase 22b: the other dense singles at published width, 2 layers each, from
# memory (PERF.md §6). Chameleon-7B (facebook/chameleon-7b): 4096, 32/32 heads,
# n_ff 11008 (Q4_K: no K-major tile there, so its down loads planar), vocab
# 65536, rope_theta 1e4, per-head layernorm q/k norms; BitNet b1.58 2B-4T
# (microsoft/bitnet-b1.58-2B-4T): 2560, 20/5 heads, n_ff 6912, vocab 128256,
# rope_theta 5e5, tied, every projection TQ2_0 (planar: no K-major tile at K
# 2560 or 6912), the embedding Q4_K (llama.cpp's quantizer keeps the
# embedding of a TQ2_0 file at Q4_K), sub-norms and scales; CogVLM2-Llama3-19B's
# text side (THUDM/cogvlm2-llama3-chat-19B): Llama-3-8B's widths, 4096, 32/8
# heads, n_ff 14336, vocab 128256, rope_theta 5e5, the fused attn_qkv, and
# the vision expert's five tensors a layer in the file
CHAMELEON = dict(arch="chameleon", vocab_size=65536, n_embd=4096, n_head=32, n_head_kv=32,
                 n_ff=11008, rope_base=1e4, rms_eps=1e-5)
BITNET = dict(arch="bitnet", vocab_size=128256, n_embd=2560, n_head=20, n_head_kv=5, n_ff=6912,
              rope_base=5e5, rms_eps=1e-5, tied=True, qtype="TQ2_0")
COGVLM = dict(vocab_size=128256, n_embd=4096, n_head=32, n_head_kv=8, n_ff=14336,
              rope_base=5e5, rms_eps=1e-5)
SINGLES_LAYERS = 2
SINGLES_KERNELS = ("qmm_splitk", "flash_attention", "flash_decode", "kv_store")


def xielu_rows(torch, timer, cfg, g):
    """apertus's xIELU (models/llama.py:xielu: plain ops, no kernel) at the
    decode step's M = 4 and the 4 x 512 prefill's M = 2048 over n_ff 21504,
    timed beside its byte bound (bf16 up read, bf16 hidden written). ->
    {M: ms}."""
    from tpullm_torch.models.llama import xielu

    out = {}
    for M in (4, 2048):
        u = torch.randn((1, M, cfg.n_ff), generator=g, device="cuda").to(torch.bfloat16)
        ms = timer(lambda: xielu(u, 0, cfg, torch.bfloat16), 10)
        bound, by = bound_of(4.0 * M * cfg.n_ff, 0.0, 9.0 * M * cfg.n_ff)
        out[M] = ms
        log(f"plain op [xIELU,M={M},n_ff={cfg.n_ff},Apertus-8B]: ms {ms:.4f} bound_ms "
            f"{bound:.4f} ({by}) share_of_bound {bound / ms:.4f}")
    return out


def phase_apertus_kernels(torch, entries, cfg):
    """Phase 22's rows: A (M = 4) and B (M = 2048) on random Q4_K weights at
    Apertus-8B's up (21504 x 4096) and down (4096 x 21504: a 1536 K tile, the
    32-group f32 d), each held against its plain version beside cuBLAS on the
    pre-dequantized weight and its bound; then xIELU's ms (xielu_rows). ->
    xIELU's {M: ms}."""
    from tpullm_torch.ops import _cuda

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2828)
    d, n_ff = cfg.n_embd, cfg.n_ff
    weight_rows(torch, timer, entries, g, [("up", [n_ff], d), ("down", [d], n_ff)], "Apertus-8B")
    xi = xielu_rows(torch, timer, cfg, g)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    _cuda.reset_counts()
    return xi


def synth_apertus(torch, n_layer, seed):
    """Apertus-8B cut to ``n_layer`` layers, drawn on the card
    (synth_kmajor_q4k_fast with a torch.Generator), its config checked field
    for field against config_from_gguf of the keys a converted file holds
    (APERTUS_KEYS and the JAX synth's xielu.* arrays) at that depth. ->
    (cfg, params)."""
    import numpy as np

    from tpullm_torch.models.config import config_from_gguf
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast

    cfg, params = synth_kmajor_q4k_fast(**dict(APERTUS, n_layer=n_layer), seed=seed,
                                        centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    meta = GGUFMeta("apertus", dict(APERTUS_KEYS, block_count=n_layer))
    li = np.arange(n_layer)
    meta.metadata.update({"xielu.alpha_n": (0.8 + 0.02 * li).astype(np.float32),
                          "xielu.alpha_p": (0.8 - 0.01 * li).astype(np.float32),
                          "xielu.beta": np.full(n_layer, 0.5, np.float32),
                          "xielu.eps": np.full(n_layer, -1e-6, np.float32)})
    parsed = config_from_gguf(meta)
    fields = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k != "raw_kv"}
    if fields(parsed) != fields(cfg):
        diff = {k: (v, fields(cfg)[k]) for k, v in fields(parsed).items() if fields(cfg)[k] != v}
        raise AssertionError(f"Apertus-8B: the synth's config differs from its keys' {diff}")
    return cfg, params


def phase_apertus(torch, entries):
    """Phase 22, the dense singles' full-width model (Apertus-8B: xIELU on
    the ungated FFN of every layer, per-head q/k RMS norms), the Gemma-3n
    weights freed first: (a) 2 layers against the CPU (phase 3's rule, E on
    in the decode step: A, B, C, E and the store launched, D not: xIELU's
    ungated FFN closes it); then the 32-layer model drawn on the card: (b)
    its kernel rows (phase_apertus_kernels); (c) the slice with E on (4
    requests of 512/300/200/100 tokens, 32 greedy steps, graph replays,
    then eagerly: the same tokens and launch counts); (d) its decode-step
    profile as graph replays (A four times a layer and the lm_head, E and
    the store once a layer; D never), the step's device ms split by kernel
    with xIELU's share from its row, and a prefill profile; (e) its q8
    server (4 slots of APERTUS_CTX, E on, 4 token-id requests of
    APERTUS_SERVER_PROMPTS, APERTUS_SERVER_NEW new tokens each). -> launch
    counts by path."""
    counts = {}
    label = "Apertus-8B"
    t = time.perf_counter()
    c = phase_parity(torch, f"{label} (depth cut from {APERTUS['n_layer']})", seed=28,
                     flash_decode="1", last_only=True, **dict(APERTUS, n_layer=2))
    counts[f"{label} 2-layer"] = c
    missing = [k for k in APERTUS_KERNELS if c[k] <= 0]
    if missing or c["layer_kernel"] or c["moe_gmm"]:
        raise AssertionError(f"{label} parity: kernels not launched {missing}, layer kernel "
                             f"{c['layer_kernel']}, moe_gmm {c['moe_gmm']}")
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_apertus(torch, APERTUS["n_layer"], 0)
    lay = params["layers"]
    n_w = sum(math.prod(v.shape) for v in lay.values() if hasattr(v, "qtype")) + (
        2 * cfg.vocab_size * cfg.n_embd)
    gb = model_gb(params)
    kinds = {k: (v.qtype.name, v.layout, tuple(v.shape)) if hasattr(v, "qtype")
             else tuple(v.shape) for k, v in lay.items()}
    log(f"slice {label}: synthesized Q4_K kmajor weights {gb:.3f} GB ({n_w / 1e9:.3f} B "
        f"weights, {gb * 1e9 / n_w:.3f} bytes a weight) in {time.perf_counter() - t:.3f} s; "
        f"config {cfg.arch} heads {cfg.n_head}/{cfg.n_head_kv} of {cfg.head_dim} n_ff "
        f"{cfg.n_ff} ({'gated' if cfg.ffn_gate else 'ungated'} {cfg.act_fn}) rope "
        f"{cfg.rope_type} {cfg.rope_base:g} vocab {cfg.vocab_size}; xIELU (alpha_n, alpha_p, "
        f"beta, eps) of layers 0 and 31 {cfg.xielu[0]} {cfg.xielu[-1]}; layer tensors {kinds}")
    t = time.perf_counter()
    xi = phase_apertus_kernels(torch, entries, cfg)
    log(f"phase kernels {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    set_flash_decode("1")
    try:
        counts[label], eng, eager, prompts = phase_slice(
            torch, label, cfg, params, cfg.vocab_size, APERTUS_KERNELS,
            ("layer_kernel", "moe_gmm"), new=APERTUS_NEW)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        out = phase_decode(torch, eng, prompts, f" {label} graph")
    finally:
        set_flash_decode(None)
    step = out["graph_capture_counts_per_step"] or {}
    L = cfg.n_layer
    want = {"qmm_splitk": 4 * L + 1, "kv_store": L, "flash_decode": L}
    if {k: step.get(k) for k in want} != want or step.get("layer_kernel"):
        raise AssertionError(f"{label} decode step: launches {step}, want {want} (A on wqkv, "
                             "wo, up and down a layer and the lm_head; the store and E once a "
                             "layer; no D)")
    split = out["device_ms_by_kernel_per_step"]
    dev = out["device_busy_ms_per_step"]
    log(f"decode step {label}: device {dev:.3f} ms a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; xIELU {L} x {xi[4]:.4f} = {L * xi[4]:.3f} ms ({L * xi[4] / dev:.1%} of the "
        f"step, from its row); at the 4 x 512 prefill {L} x {xi[2048]:.4f} ms")
    phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "kv_store"),
                          f" {label}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase slice {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    counts[f"{label} server"] = phase_q8_server(torch, cfg, params, label,
                                                APERTUS_SERVER_PROMPTS, n_ctx=APERTUS_CTX,
                                                kernels=APERTUS_KERNELS,
                                                must_not=("layer_kernel", "moe_gmm"),
                                                new=APERTUS_SERVER_NEW)
    log(f"phase server {label}: {time.perf_counter() - t:.1f} s")
    del cfg, params, lay
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def q4k_blocks(torch, n, K, g):
    """Raw Q4_K blocks of an (n, K) weight as a GGUF file holds them (f16 d
    and dmin, 12 bytes of packed 6-bit sub-scales and sub-mins, 128 bytes of
    nibbles), drawn on the card with ``g`` and centred as random_kmajor
    draws: sub-scales in [1, 8), sub-mins round(7.5 x sub-scale), dmin = d
    near 1e-3. -> uint8 numpy (n * K // 256 * 144,)."""
    nb = K // 256
    ints = lambda lo, hi, *s: torch.randint(lo, hi, (n, nb) + s, generator=g, device="cuda",
                                            dtype=torch.int16).to(torch.uint8)
    sc = ints(1, 8, 8)
    mn = torch.round(sc.float() * 7.5).to(torch.uint8)
    # get_scale_min_k4's packing: bytes 0-3 the sub-scales 0-3, 4-7 the
    # sub-mins 0-3 with the top bits of sub-mins 4-7, 8-11 the low nibbles of
    # sub-scales 4-7 and of sub-mins 4-7 (sub-scales below 16 need no top bits)
    packed = torch.cat([sc[..., :4], mn[..., :4] | ((mn[..., 4:] >> 4) << 6),
                        (sc[..., 4:] & 15) | ((mn[..., 4:] & 15) << 4)], dim=-1)
    d = ((torch.rand((n, nb), generator=g, device="cuda") + 0.5) * 1e-3).to(torch.float16)
    dd = d.view(torch.uint8).reshape(n, nb, 2)
    blocks = torch.cat([dd, dd, packed, ints(0, 256, 128)], dim=-1)
    return blocks.reshape(-1).cpu().numpy()


def write_gguf(path, arch: str, keys: dict, tensors) -> int:
    """A little-endian GGUF v3 file at ``path``: general.architecture, then
    ``keys`` (ints as uint32, floats as float32), then each (name, numpy
    shape (rows, row length), GGMLType, uint8 payload) of ``tensors`` at a
    32-byte aligned offset. -> the bytes written."""
    import struct

    def s(t):
        b = t.encode()
        return struct.pack("<Q", len(b)) + b

    head = [b"GGUF", struct.pack("<IQQ", 3, len(tensors), len(keys) + 1),
            s("general.architecture"), struct.pack("<I", 8), s(arch)]
    for k, v in keys.items():
        head += [s(k), struct.pack("<If", 6, v) if isinstance(v, float)
                 else struct.pack("<II", 4, v)]
    off, offsets = 0, []
    for name, shape, qtype, payload in tensors:
        head += [s(name), struct.pack("<I", len(shape)),
                 *(struct.pack("<Q", x) for x in reversed(shape)),
                 struct.pack("<IQ", int(qtype), off)]
        offsets.append(off)
        off += -(-payload.nbytes // 32) * 32
    head = b"".join(head)
    with open(path, "wb") as f:
        f.write(head + b"\0" * (-len(head) % 32))
        for (_, _, _, payload), o in zip(tensors, offsets):
            f.write(payload.tobytes())
            f.write(b"\0" * (-payload.nbytes % 32))
    return os.path.getsize(path)


def cogvlm_file(torch, path, n_layer, seed):
    """A CogVLM2-Llama3-19B-width GGUF (COGVLM, ``n_layer`` layers) with its
    text side (token_embd, output and the fused attn_qkv, attn_output,
    ffn_gate, ffn_up, ffn_down Q4_K; the norms F32 1 + N(0, 0.1)) and the
    vision expert's five Q4_K tensors a layer (vis_attn_qkv 3 x 4096 rows,
    vis_attn_output, vis_gate, vis_up, vis_down, the JAX synth's shapes),
    written to ``path``. -> (file bytes, the vis_* tensors' bytes)."""
    from tpullm_torch.gguf.constants import GGMLType

    c = COGVLM
    d, hd, ff, V = c["n_embd"], c["n_embd"] // c["n_head"], c["n_ff"], c["vocab_size"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q4k = lambda n, K: (GGMLType.Q4_K, (n, K), q4k_blocks(torch, n, K, g))
    norm = lambda n: (GGMLType.F32, (n,), (1.0 + torch.randn(n, generator=g, device="cuda")
                                           * 0.1).cpu().numpy().view("uint8"))
    tensors = []

    def add(name, spec):
        qtype, shape, payload = spec
        tensors.append((name, shape, qtype, payload))

    add("token_embd.weight", q4k(V, d))
    add("output.weight", q4k(V, d))
    add("output_norm.weight", norm(d))
    vis = 0
    for i in range(n_layer):
        p = f"blk.{i}."
        add(p + "attn_norm.weight", norm(d))
        add(p + "ffn_norm.weight", norm(d))
        add(p + "attn_qkv.weight", q4k((c["n_head"] + 2 * c["n_head_kv"]) * hd, d))
        add(p + "attn_output.weight", q4k(d, c["n_head"] * hd))
        add(p + "ffn_gate.weight", q4k(ff, d))
        add(p + "ffn_up.weight", q4k(ff, d))
        add(p + "ffn_down.weight", q4k(d, ff))
        for name, n, K in (("vis_attn_qkv", 3 * c["n_head"] * hd, d),
                           ("vis_attn_output", d, c["n_head"] * hd), ("vis_gate", ff, d),
                           ("vis_up", ff, d), ("vis_down", d, ff)):
            spec = q4k(n, K)
            vis += spec[2].nbytes
            add(p + name + ".weight", spec)
    keys = {"cogvlm.context_length": 8192, "cogvlm.embedding_length": d,
            "cogvlm.block_count": n_layer, "cogvlm.feed_forward_length": ff,
            "cogvlm.attention.head_count": c["n_head"],
            "cogvlm.attention.head_count_kv": c["n_head_kv"],
            "cogvlm.rope.freq_base": float(c["rope_base"]),
            "cogvlm.rope.dimension_count": hd,
            "cogvlm.attention.layer_norm_rms_epsilon": float(c["rms_eps"]),
            "cogvlm.vocab_size": V}
    return write_gguf(path, "cogvlm", keys, tensors), vis


def planar_tq2_rows(torch, timer, cfg, params, g):
    """The planar TQ2_0 products of BitNet b1.58 2B-4T (no kernel: each
    weight dequantized whole, then torch.matmul) on the model's last layer,
    gate (6912 x 2560) and down (2560 x 6912), at the decode step's M = 4
    and a 4 x 512 prefill's M = 2048, each timed beside its bound (the
    planar bytes once, the product's bf16 operations) and cuBLAS on the
    pre-dequantized bf16 weight. -> {name: {M: ms}}."""
    from tpullm_torch.ops.qmm import qmm

    lay = params["layers"]
    li = next(iter(lay.values())).shape[0] - 1
    out = {}
    for name in ("ffn_gate", "ffn_down"):
        qt = lay[name]
        N, K = qt.shape[-2:]
        w = type(qt)(qt.qtype, (N, K), {k: v[li] for k, v in qt.data.items()}).dequant(
            torch.bfloat16)
        for M in (4, 2048):
            x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
            ms = timer(lambda: qmm(x, qt, torch.bfloat16, li), 5, warmup=1)
            lms = timer(lambda: torch.matmul(x, w.t()), 10)
            bound, by = bound_of(weight_bytes(qt) / qt.shape[0] + 2.0 * M * (N + K),
                                 2.0 * M * N * K)
            out.setdefault(f"{name} {N}x{K}", {})[M] = ms
            log(f"plain product [{name} {N}x{K},planar TQ2_0,M={M},BitNet b1.58 2B-4T]: ms "
                f"{ms:.4f} library_ms {lms:.4f} bound_ms {bound:.4f} ({by}) share_of_bound "
                f"{bound / ms:.4f}")
            del x
        del w
    return out


def phase_dense_singles(torch, entries):
    """Phase 22b, the other dense singles at published width, 2 layers each,
    against the CPU (phase 3's rule, E on in the decode step), each with its
    route through D: (a) Chameleon-7B (synth_dense_single: the per-head
    layernorm q/k norms; its down planar Q4_K at K 11008, so D is off); (b)
    BitNet b1.58 2B-4T (every projection planar TQ2_0, so B has nothing to
    run, the sub-norms and the scales, which keep D off in any case; a tied
    Q4_K embedding), then its
    planar TQ2_0 products timed (planar_tq2_rows); (c) CogVLM2-Llama3-19B's
    text side from a GGUF file written here with its vision expert's tensors
    (cogvlm_file), loaded through the port's loader onto the card: the
    device bytes the load added against the params' bytes and the vis_*
    tensors' bytes, which stay in the file, then the parity (D on, unfolded:
    the fused attn_qkv is no wqkv). -> launch counts by path."""
    from tpullm_torch.gguf.constants import GGMLType
    from tpullm_torch.runtime.loader import load_model
    from tpullm_torch.utils.synth import synth_dense_single

    counts = {}
    L = SINGLES_LAYERS
    # the kernels each run launches, and those it may not: D stays off both
    # (Chameleon's planar down, BitNet's sub-norms and scales); BitNet's
    # projections are all planar, so B has nothing to run (its tied lm_head
    # computes the last position alone, on A)
    for label, spec, seed, must, must_not in (
            ("Chameleon-7B", CHAMELEON, 29, SINGLES_KERNELS + ("qmm",), ("layer_kernel",)),
            ("BitNet b1.58 2B-4T", BITNET, 30, SINGLES_KERNELS, ("layer_kernel", "qmm"))):
        t = time.perf_counter()
        spec = dict(spec, n_layer=L, generator=torch.Generator(device="cuda").manual_seed(seed))
        spec["qtype"] = GGMLType[spec.get("qtype", "Q4_K")]
        c = phase_parity(torch, f"{label} (2 layers)", seed=seed, flash_decode="1",
                         last_only=True, synth=synth_dense_single, **spec)
        counts[f"{label} 2-layer"] = c
        log(f"route {label}: D {'on' if c['layer_kernel'] else 'off'} (launches "
            f"{c['layer_kernel']}), E {c['flash_decode']}, C {c['flash_attention']}, A "
            f"{c['qmm_splitk']}, B {c['qmm']}, the store {c['kv_store']}")
        missing = [k for k in must if c[k] <= 0]
        extra = [k for k in must_not + ("moe_gmm",) if c[k]]
        if missing or extra:
            raise AssertionError(f"{label}: kernels not launched {missing}, launched but off "
                                 f"its path {extra}")
        log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    spec = dict(BITNET, n_layer=L, qtype=GGMLType.TQ2_0)
    cfg, params = synth_dense_single(**spec, generator=torch.Generator(device="cuda")
                                     .manual_seed(31), device="cuda")
    timer = Timer(torch)
    planar_tq2_rows(torch, timer, cfg, params, torch.Generator(device="cuda").manual_seed(32))
    del timer, cfg, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase planar TQ2_0 rows: {time.perf_counter() - t:.1f} s")
    label = "CogVLM2-Llama3-19B text"
    t = time.perf_counter()
    build = ROOT / "tpullm_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    path = build / "cogvlm_smoke.gguf"
    try:
        size, vis = cogvlm_file(torch, str(path), L, 33)
        t_write = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cfg, params, g = load_model(str(path), device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - before
        g.close()
    finally:
        path.unlink(missing_ok=True)
    held = params_bytes(params)
    names = sorted({k for k in params["layers"]})
    log(f"load {label}: a {size / 1e9:.3f} GB file ({vis / 1e9:.3f} GB of vis_* tensors, "
        f"written in {t_write:.1f} s) loaded in {t_load:.1f} s; device bytes added by the load "
        f"{added / 1e9:.4f} GB, the params' {held / 1e9:.4f} GB; layer tensors {names}")
    if any("vis" in k for k in names) or not 0.99 * held <= added < held + vis / 2:
        raise AssertionError(f"{label}: the load added {added} device bytes for {held} bytes "
                             f"of params, {vis} bytes of vis_* tensors in the file: {names}")
    counts[f"{label} 2-layer"] = c = phase_parity(
        torch, f"{label} (2 layers, from its file)", seed=33, flash_decode="1", last_only=True,
        synth=lambda **kw: (cfg, params), **dict(COGVLM, n_layer=L))
    del cfg, params
    log(f"route {label}: D {'on' if c['layer_kernel'] else 'off'} (launches "
        f"{c['layer_kernel']}), E {c['flash_decode']}, C {c['flash_attention']}, A "
        f"{c['qmm_splitk']}, B {c['qmm']}, the store {c['kv_store']}")
    missing = [k for k in SINGLES_KERNELS + ("qmm", "layer_kernel") if c[k] <= 0]
    if missing or c["moe_gmm"]:
        raise AssertionError(f"{label}: kernels not launched {missing}, F {c['moe_gmm']}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase parity {label}: {time.perf_counter() - t:.1f} s")
    return counts


def model_gb(params) -> float:
    """GB of a synthesized model's quantized weights (a tied lm_head once)."""
    groups = params["layers"].get("__groups__") or [params["layers"]]
    qts = [params["tok_embd"], params["output"]] + [
        v for gl in groups for v in gl.values() if hasattr(v, "data")]
    return sum(q.nbytes for q in {id(q): q for q in qts}.values()) / 1e9


def cpu_jiffies():
    """(all, idle, steal) jiffies summed over the CPUs (/proc/stat), or None
    where the file is absent."""
    try:
        v = [int(x) for x in Path("/proc/stat").read_text().split("\n", 1)[0].split()[1:9]]
    except OSError:
        return None
    return sum(v), v[3] + v[4], v[7]


def thread_ticks() -> dict:
    """{thread id: (name, user + system clock ticks)} of this process's
    threads (/proc/self/task), or {} where it is absent."""
    out = {}
    for task in Path("/proc/self/task").glob("*"):
        try:
            text = (task / "stat").read_text()
        except OSError:
            continue
        name = text[text.index("(") + 1: text.rindex(")")]
        f = text[text.rindex(")") + 2:].split()
        out[task.name] = (name, int(f[11]) + int(f[12]))  # utime, stime
    return out


def host_yardstick_ms() -> float:
    """Median of 5 timings of a fixed pure-Python loop: the host's speed
    for this process, independent of the card."""
    ms = []
    for _ in range(5):
        t = time.perf_counter()
        s = 0
        for i in range(1_000_000):
            s += i
        ms.append((time.perf_counter() - t) * 1e3)
    return sorted(ms)[2]


def quartiles(xs):
    q = sorted(xs)
    n = len(q)
    return q[n // 4], q[n // 2], q[(3 * n) // 4]


def device_kernels(prof):
    """[(kernel name, device ms, launches)] of a torch.profiler run, most
    time first; device events only (a host op's device time repeats its
    kernels')."""
    ev = prof.key_averages()
    self_dev = ("self_device_time_total" if hasattr(ev[0], "self_device_time_total")
                else "self_cuda_time_total")
    rows = [(short_kernel(e.key), getattr(e, self_dev) / 1e3, e.count) for e in ev
            if e.device_type.name == "CUDA" and getattr(e, self_dev) > 0]
    return sorted(rows, key=lambda r: -r[1])


# the port's kernels by their CUDA names (kernel A's split-K sum included)
KERNEL_OF = {"qmm_splitk_kernel": "qmm_splitk", "qmm_reduce": "qmm_splitk",
             "qmm_wgmma_kernel": "qmm",
             "flash_kernel": "flash_attention", "layer_kernel": "layer_kernel",
             "moe_gmm_kernel": "moe_gmm", "flash_decode_kernel": "flash_decode",
             "kv_store_kernel": "kv_store", "qmm_experts_kernel": "qmm_experts",
             "qmm_experts_reduce": "qmm_experts", "qmm_experts_combine": "qmm_experts"}


def phase_prefill_profile(torch, eng, prompts, must, label):
    """Where a prefill's time goes, on the slice's model and batch: the
    engine's prefill timed alone (synchronized), then once more under
    torch.profiler. Reports each kernel's device ms and launches, the
    device ms of everything else (routing, sorting, gathers, norms, RoPE,
    elementwise: the torch ops between the kernels) with its largest
    items, and the share of the wall time the device sat idle."""
    from torch.profiler import ProfilerActivity, profile

    tokens, positions, vf, T, lens = eng.prepare_batch(prompts)
    cache = eng.new_cache(len(prompts))
    with torch.inference_mode():
        eng._prefill(tokens, positions, cache, vf)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng._prefill(tokens, positions, cache, vf)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng._prefill(tokens, positions, cache, vf)
            torch.cuda.synchronize()
    by, other = {}, []
    for name, ms, n in device_kernels(prof):
        k = KERNEL_OF.get(name.split("<")[0], "other")
        tot, cnt = by.get(k, (0.0, 0))
        by[k] = (tot + ms, cnt + n)
        if k == "other":
            other.append((name[:60], ms, n))
    busy = sum(ms for ms, _ in by.values())
    out = {"tokens": int(sum(lens)), "rows": int(tokens.numel()), "wall_ms": wall,
           "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
           "device_ms_launches": by, "top_other": other[:8]}
    log(f"prefill profile{label}: {json.dumps(out)}")
    missing = [k for k in must if k not in by]
    if missing or not busy > 0:
        raise AssertionError(f"prefill profile{label}: no device time for {missing}: {out}")
    return out


def graph_pool_gb(torch, eng):
    """GB the caching allocator holds in the engine's graph memory pool (its
    segments stay reserved while the graphs live, and replays allocate
    nothing), or None where the snapshot does not name segment pools."""
    if eng.pool is None:
        return 0.0
    snap = torch.cuda.memory_snapshot()
    if any("segment_pool_id" not in seg for seg in snap):
        return None
    return sum(seg["total_size"] for seg in snap
               if tuple(seg["segment_pool_id"]) == tuple(eng.pool)) / 1e9


RUNTIME_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch")


def phase_decode(torch, eng, prompts, label="", profiled_steps=PROFILED_STEPS,
                 steps=DECODE_STEPS):
    """Phases 5 and 8: where a decode step's time goes, on the slice's model
    and batch, through the engine's own decode step (``decode_step``: a
    graph replay, or the same step run eagerly with cuda_graphs=False) at
    the engine's kv view, greedy, synchronized, so its host clock can be
    read alone. Over the timed steps it also reads what the host did: the
    CPU seconds of the main thread, of the whole process and of each of its
    threads, and the busy and steal shares of all CPUs. Then the same steps
    back to back between CUDA events (no host wait between steps) and under
    torch.profiler: device ms (and by kernel, the ops between kernels as
    "other"), kernels and runtime launch calls per step,
    device-busy share; peak memory over the window (allocated, plus the
    engine's graph pool, whose blocks replays use without allocating).
    ``profiled_steps``: the steps timed back to back and profiled
    (DeepSeek-V2-Lite's: one, a step of its expert loop holding ~20000
    launches); ``steps`` the steps timed one by one (DECODE_STEPS; 8 for
    gpt-oss-20b, whose planar expert loop makes a step ~0.5 s)."""
    from torch.profiler import ProfilerActivity, profile

    from tpullm_torch.ops.sampling import GREEDY, make_sample_fn

    from tpullm_torch.runtime.engine import kv_view_bucket

    sample = make_sample_fn(GREEDY)
    tokens, positions, vf, T, lens = eng.prepare_batch(prompts)
    st = eng.decode_state(len(prompts))
    view = kv_view_bucket(T, eng.decode_chunk, eng.max_seq_len)
    n = [0]

    def step():
        if n[0] % eng.decode_chunk == 0:  # the chunk's token rows are reused
            st.step.zero_()
        n[0] += 1
        eng.decode_step(st, GREEDY, view)

    gc.collect()  # what an earlier phase left (the server's cache) stays out of the peak
    torch.cuda.empty_cache()
    with torch.inference_mode():
        logits, _ = eng._prefill(tokens, positions, st.cache, vf)
        st.tok.copy_(sample(logits))
        st.pos.copy_(torch.from_numpy(lens.astype("int64")))
        st.valid_from.copy_(vf)
        st.slot.fill_(T)
        for _ in range(2):  # warm-up (the graph of this key exists from the slice)
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        yard0 = host_yardstick_ms()
        jif0, ticks0 = cpu_jiffies(), thread_ticks()
        c0, p0, t0 = time.thread_time(), time.process_time(), time.perf_counter()
        wall = []
        for _ in range(steps):
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        c1, p1, t1 = time.thread_time(), time.process_time(), time.perf_counter()
        jif1, ticks1 = cpu_jiffies(), thread_ticks()
        yard1 = host_yardstick_ms()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(profiled_steps):
            step()
        ev1.record()
        torch.cuda.synchronize()
        stream_ms = ev0.elapsed_time(ev1) / profiled_steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled_steps):
                step()
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
    pool = graph_pool_gb(torch, eng)
    kernels = device_kernels(prof)
    busy = sum(ms for _, ms, _ in kernels) / profiled_steps
    by_kernel = {}
    for name, ms, _ in kernels:
        k = KERNEL_OF.get(name.split("<")[0], "other")
        by_kernel[k] = by_kernel.get(k, 0.0) + ms / profiled_steps
    launches = sum(c for _, _, c in kernels) / profiled_steps
    calls = launch_calls(prof, profiled_steps)
    w1, wm, w3 = quartiles(wall)
    hz = os.sysconf("SC_CLK_TCK")
    busiest = sorted(((nm, (k - ticks0.get(tid, (nm, 0))[1]) / hz / (t1 - t0))
                      for tid, (nm, k) in ticks1.items()), key=lambda x: -x[1])[:4]
    out = {
        "way": "graph" if eng.cuda_graphs else "eager",
        "steps": steps, "wall_ms_q1_median_q3": [w1, wm, w3],
        "main_thread_cpu_share": (c1 - c0) / (t1 - t0),
        "process_cpus_busy": (p1 - p0) / (t1 - t0),
        "busiest_threads_cpu_share": busiest,
        "host_yardstick_ms_before_after": [yard0, yard1],
        "back_to_back_ms_per_step": stream_ms,
        "profiled_steps": profiled_steps, "device_busy_ms_per_step": busy,
        "device_busy_share": busy / wm, "kernel_launches_per_step": launches,
        "runtime_launch_calls_per_step": calls,
        "peak_allocated_gb": peak, "graph_pool_gb": pool,
        "peak_gb_with_graph_pool": peak + pool if pool is not None else None,
        "top_device_ms_per_step": [(k[:60], ms / profiled_steps) for k, ms, _ in kernels[:6]],
        "device_ms_by_kernel_per_step": by_kernel,
        "cpus": len(os.sched_getaffinity(0)), "torch_threads": torch.get_num_threads(),
    }
    if eng.cuda_graphs:
        out["graph_capture_counts_per_step"] = {
            k: c for k, c in next(iter(eng.graphs.values())).counts.items() if c} if len(
                eng.graphs) == 1 else None
    if jif0 and jif1:
        tot = max(jif1[0] - jif0[0], 1)
        out["cpus_busy_share"] = 1 - (jif1[1] - jif0[1]) / tot
        out["cpus_steal_share"] = (jif1[2] - jif0[2]) / tot
    log(f"decode steps{label}: {json.dumps(out)}")
    if not (busy > 0 and all(math.isfinite(x) for x in wall)):
        raise AssertionError(f"decode profile saw no device time: {out}")
    return out


# the seeds of the near-tie readings: the Scout parity's own (53) and four more
NEAR_TIE_SEEDS = (53, 54, 55, 56, 57)


def near_tie_readings(torch, spec=None, seeds=NEAR_TIE_SEEDS, n_layer=SCOUT_PARITY_LAYERS,
                      dev="cuda"):
    """The readings NEAR_TIE is set from (``--near-tie-readings``): phase
    19a's prefill (its tokens, Llama-4-Scout or ``spec`` at ``n_layer``
    layers) on ``dev`` in bf16, then on the CPU f32 path teacher-forced to
    those picks, at each of ``seeds``: the routings the CPU f32 path would
    pick otherwise and the largest gap of its picks' probabilities over the
    card's among them (what phase_moe_parity bounds by NEAR_TIE). Then, at
    the first seed, the same with a planted router fault on the card side
    (the router reading the residual stream ahead of ffn_norm:
    moe_router_pre_norm, smallthinker's input), which the bound must
    reject; and the CPU prefill's seconds (f32, bf16) with _moe_loop's rows
    gathered by expert and with every present expert on every row (MAX_ROWS
    lifted). -> the readings as a dict."""
    from unittest import mock

    import numpy as np

    import tpullm_torch.models.llama as llama
    from tpullm_torch.models.llama import KVCache, forward

    spec = spec or SCOUT
    B, T, S = 2, 128, 256
    lens = [128, 100]
    top_k = llama.top_k
    forced = []

    def routed(probs, k):
        return forced.pop(0).to(probs.device) if forced else top_k(probs, k)

    def prefill(p, cfg, d, dtype, tok, posn, vf):
        """-> (the (probs, k) of each top_k call, seconds)."""
        cache = KVCache.create(cfg, B, S, dtype, d)
        with mock.patch.object(llama, "top_k", wraps=routed) as spy, torch.inference_mode():
            t0 = time.perf_counter()
            forward(p, cfg, tok.to(d), posn.to(d), cache, 0, vf.to(d), dtype)
            if d == "cuda":
                torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        assert not forced, "the forced picks outnumber the router's calls"
        return [c.args for c in spy.call_args_list], sec

    out = {"seeds": list(seeds), "gap": [], "flips": []}
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        cfg, params = synth_moe(spec, n_layer=n_layer, seed=seed, device=dev, generator=gen)
        cpu = plain_cpu_copy(torch, params)
        rng = np.random.default_rng(3)
        tok, posn = np.zeros((B, T), np.int64), np.zeros((B, T), np.int64)
        real = torch.zeros((B, T), dtype=torch.bool)
        for b, n in enumerate(lens):
            tok[b, T - n:] = rng.integers(0, cfg.vocab_size, n)
            posn[b, T - n:] = np.arange(n)
            real[b, T - n:] = True
        args = (torch.from_numpy(tok), torch.from_numpy(posn),
                torch.tensor([T - n for n in lens], dtype=torch.int64))
        cases = [("card", cfg)] + ([("planted", dataclasses.replace(
            cfg, moe_router_pre_norm=True))] if i == 0 else [])
        for name, card_cfg in cases:
            calls, _ = prefill(params, card_cfg, dev, torch.bfloat16, *args)
            picks = [top_k(*a).cpu() for a in calls]
            forced[:] = picks
            calls, _ = prefill(cpu, cfg, "cpu", torch.float32, *args)
            own = [top_k(*a) for a in calls]
            gap = max(float((a[0].float().gather(-1, o).sum(-1)
                             - a[0].float().gather(-1, m).sum(-1))[real].max())
                      for a, o, m in zip(calls, own, picks))
            flips = sum(int(((o.sort(-1).values != m.sort(-1).values).any(-1) & real).sum())
                        for o, m in zip(own, picks))
            if name == "card":
                healthy = picks
                out["gap"].append(gap)
                out["flips"].append(flips)
            else:
                out["planted"] = {"gap": gap, "flips": flips}
            log(f"near-tie readings seed {seed} {name}: routings the CPU f32 path picks "
                f"otherwise {flips} of {sum(lens) * cfg.n_layer}, largest gap {gap:.3e}")
        if i == 0:
            secs = {}
            for dtype in (torch.float32, torch.bfloat16):
                for way, rows in (("rows gathered", llama.MAX_ROWS), ("every row", 1 << 30)):
                    forced[:] = healthy
                    with mock.patch.object(llama, "MAX_ROWS", rows):
                        secs[f"{str(dtype)[6:]} {way}"] = prefill(cpu, cfg, "cpu", dtype,
                                                                  *args)[1]
            out["cpu_prefill_s"] = secs
            log(f"near-tie readings: the CPU prefill's seconds by _moe_loop's way {secs}")
        del params, cpu
        if dev == "cuda":
            torch.cuda.empty_cache()
    log(f"near-tie readings: largest gap {max(out['gap']):.3e} over seeds {list(seeds)}, "
        f"planted fault {out['planted']['gap']:.3e} (bound {NEAR_TIE:g})")
    return out


def main() -> int:
    global FULL_DEPTH
    import torch

    args = sys.argv[1:]
    if args not in ([], ["--near-tie-readings"], ["--full-depth"]):
        print(f"chip_smoke: unknown arguments {args}; takes none, --near-tie-readings or "
              f"--full-depth", file=sys.stderr)
        return 2
    FULL_DEPTH = args == ["--full-depth"]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a card",
              file=sys.stderr)
        return 2
    if not (ROOT / "tpullm_torch" / "csrc").is_dir():
        print(f"chip_smoke: no tpullm_torch/ package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from tpullm_torch.ops import _cuda

    info = _cuda.build()
    regs = " ".join(f"{short_kernel(n)}:{r}r/{s}B" for n, r, s in info["ptxas"])
    log(f"build: {info['seconds']:.1f} s (cached {info['cached']}); "
        f"registers/spill bytes {regs}")
    log("kernel A SASS (loop instructions, of them on branches, weights a thread, per weight "
        "off the branches): " + " ".join(f"{k}:{n}/{c}/{w}/{r:.2f}" for k, (n, c, w, r)
                                         in sass_per_weight(info["path"]).items()))
    _cuda.lib()
    if args == ["--near-tie-readings"]:
        print(json.dumps({"near_tie_readings": near_tie_readings(torch)}), flush=True)
        return 0

    t = time.perf_counter()
    entries = []
    timer = Timer(torch)
    phase_kernels(torch, timer, entries)
    phase_moe_kernels(torch, timer, entries)
    phase_flash_decode(torch, timer, entries)
    phase_kv_store(torch, timer, entries)
    phase_qwen_kernels(torch, timer, entries)
    del timer  # its 256 MB L2-flush buffer would count in the slices' peak memory
    torch.cuda.empty_cache()
    _cuda.reset_counts()
    log(f"phase kernels: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_parity(torch)
    log(f"phase parity: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_server_parity(torch)
    log(f"phase server parity: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    from tpullm_torch.utils.synth import synth_kmajor_q4k_fast, synth_mixtral_q4k

    cfg, params = synth_kmajor_q4k_fast(vocab_size=VOCAB, n_embd=D, n_layer=N_LAYER,
                                        n_head=H, n_head_kv=HKV, n_ff=N_FF, seed=0,
                                        centred=True, device="cuda",
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    log(f"slice 8B: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB in "
        f"{time.perf_counter() - t:.3f} s")
    counts, eng, eager, prompts = phase_slice(torch, "8B", cfg, params, VOCAB, DENSE_KERNELS)
    log(f"phase slice 8B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    server_counts, chat_counts = phase_server(torch, cfg, params)
    del cfg, params
    log(f"phase server 8B: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_decode(torch, eng, prompts, " 8B graph")
    phase_decode(torch, eager, prompts, " 8B eager")
    phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention"), " 8B")
    del eng, eager
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase decode steps: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    phase_moe_parity(torch, n_layer=ONE_LAYER)
    log(f"phase parity Mixtral: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params = synth_mixtral_q4k(vocab_size=M_VOCAB, n_embd=D,
                                    n_layer=slice_depth("Mixtral-8x7B", N_LAYER), n_head=H,
                                    n_head_kv=HKV, n_ff=N_FF, n_expert=M_EXPERT,
                                    n_expert_used=M_USED, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"slice Mixtral: synthesized Q4_K kmajor weights {model_gb(params):.3f} GB in "
        f"{time.perf_counter() - t:.3f} s")
    moe_counts, eng, eager, prompts = phase_slice(torch, "Mixtral-8x7B", cfg, params, M_VOCAB,
                                                  MOE_KERNELS, ("layer_kernel",))
    del cfg, params
    log(f"phase slice Mixtral: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    phase_decode(torch, eng, prompts, " Mixtral-8x7B graph")
    phase_prefill_profile(torch, eng, prompts, ("qmm", "flash_attention", "moe_gmm"),
                          " Mixtral-8x7B")
    del eng, eager
    log(f"phase decode steps Mixtral: {time.perf_counter() - t:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    qwen_counts = phase_qwen(torch)
    qwen_moe_counts = phase_qwen_moe(torch, entries)
    gemma_counts = phase_gemma(torch, entries)
    command_r_counts = phase_command_r(torch, entries)
    starcoder_counts = phase_starcoder(torch, entries)
    ernie_counts = phase_ernie(torch, entries)
    deepseek_counts = phase_deepseek(torch, entries)
    phi4_counts = phase_phi4(torch, entries)
    gptoss_counts = phase_gptoss(torch, entries)
    scout_counts = phase_scout(torch, entries)
    grovemoe_counts = phase_grovemoe(torch, entries)
    gemma3n_counts = phase_gemma3n(torch, entries)
    apertus_counts = phase_apertus(torch, entries)
    singles_counts = phase_dense_singles(torch, entries)

    by_path = {"8B": counts, "Mixtral-8x7B": moe_counts, "8B server": server_counts,
               "8B server chat": chat_counts, **qwen_counts, **qwen_moe_counts, **gemma_counts,
               **command_r_counts, **starcoder_counts, **ernie_counts, **deepseek_counts,
               **phi4_counts, **gptoss_counts, **scout_counts, **grovemoe_counts,
               **gemma3n_counts, **apertus_counts, **singles_counts}
    for e in entries:  # each row's launches on the slice of its shapes
        k = e.pop("kernel")
        e["launches_by_path"] = {p: c[k] for p, c in by_path.items()}
        e["launches"] = by_path[{"mixtral": "Mixtral-8x7B"}.get(e.get("path"),
                                                               e.get("path", "8B"))][k]
        e.pop("path", None)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
