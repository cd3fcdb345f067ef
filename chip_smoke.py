#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meilisearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--docs N] [--enc-docs N]

Run from the root of the repository, on a machine with a CUDA device.
Phases, each fatal on failure:
  1. build K1 (csrc/chain_keys.cu), K3 (csrc/osa.cu), K4h
     (csrc/hamming.cu) and K6 (csrc/chain_dp.cu: the DP and the merge
     of its top-k survivors) with nvcc, one process per source, into one
     library; print ptxas registers/spills;
  2. kernels: K1 against its plain torch version on the card, bit for
     bit, for every T of the ladder at D = 2^14 and 2^20, B = 32; K3
     against its plain version byte for byte over a 2^20-word seeded
     vocabulary (lengths 0-32, non-ASCII codepoints, padding rows) kept
     resident with its length order, 19 query words (m = 0 and 32 among
     them, 32 distinct codepoints, 32 codepoints that collide under the
     query table's first multiplier) at max_dist 1 and 2, and three of
     them against the host pass (ops/levenshtein.py) on 2^16 words; K4h
     in both modes against its plain versions element for element (the
     keyed mode's cosines and keys bit for bit, at n_live = 1, n - 5 and
     n) at n = 2^18 + 3 rows for W = 1, 3, 4, 12, 24 and 48 sign words,
     aligned and not; K6 in its three modes against its plain versions
     bit for bit (costs, keys, and chain_query_topk's docids and keys at
     k = 1, 10, 32, 33, tile - 1 and tile, the top-k mode and the merge of
     its survivors, and at tile + 1 and N, the keys mode and the sort of
     all N) for T = 1, 2, 3, 4, 8 and 16 at N = 2^14 + 3, 2^19 and
     355,439, each in the unpadded layout (the direct path at an odd N) and the
     callers' padded one (the bulk path), with INF addends, unmatched and
     invalid columns and docids above 2^23;
  3. keyword path: the port's App ingests N synthetic hackernews documents
     (default 500,000, so D = 2^19) over POST /indexes/hn/documents,
     then 32 client threads send a fixed query set to
     POST /indexes/hn/search; every response must equal the port's host
     scorer, K1 must have launched, and the device path must have served
     with no device error;
  4. typo path: a second App ingests a corpus whose vocabulary holds
     2^20 distinct words (utils/synthetic.py::generate_large_vocab) over
     POST /indexes/typo/documents, then 32 client threads send typo
     queries to POST /indexes/typo/search; every response must equal the
     same store's answer with the host OSA pass, K3 must have launched,
     and no device error may occur;
  5. vector path (hn150k-bge768): a third App ingests 120,000 of the
     configuration's 150,000 synthetic
     hackernews documents with a 768-dimension userProvided embedder
     (every 7th document two vectors: 137,143 rows, padded to 2^18 on the
     card) over POST /indexes/vec/documents, uploads the matrix
     (App.warm_devices), then the 24 requests (20 hybrid searches,
     semanticRatio 1.0 and 0.5, with and without a filter, and 4
     /similar requests) one at a time, and 32 client threads each send
     4 of them in a rotated order (128, each request 4 to 8 times).
     Against the same store's numpy host pass: the
     float round must give the same hits (a group whose host scores lie
     within 1e-6 compared as a set), scores within 1e-5 and the same
     semanticHitCount, through the float leg; after PATCH settings
     switches the embedder to binaryQuantized, every response must be
     equal, through K4h; no device error may occur;
  6. timing: K1 and its plain version at D = 2^20, B = 32, T = 3, K1 per
     launch from the profiler's trace, cold (the L2 cache flushed first)
     and warm, five repeats; K3 and its plain version (byte for byte
     equal again) on the typo path's own resident vocabulary (n = 2^20,
     max_dist 2) for every word the typo pass put through K3, each launch
     timed from the profiler's trace of the pass's own call, cold and
     warm, beside the bound the function needs; the vocabulary's upload
     with its length order; and for the words nearest 5 and 10 letters
     the whole typo-pass device call split into query table, kernel,
     readback and numpy, and the host pass; K4h per launch in each mode
     (ham over every row; keyed, the mode of the binary leg's top-k,
     over the path's live rows), cold and warm, on the vector path's
     resident sign words (n = 2^18, W = 24), its plain versions (equal
     again) and each mode's bound; the float leg's device work, its
     torch.matmul alone, its bound; both legs' kernels by device time
     and their launches per call; both legs' whole search_async call and
     their numpy host passes;
  7. encoder path (hn150k-bgebase-hf): a checkpoint at
     BAAI/bge-base-en-v1.5's published width (BERT, vocab 30,522, hidden
     768, 12 layers, 12 heads, intermediate 3,072; seeded random weights,
     nothing downloaded) is written to a temporary directory; the port's
     encoder on the card must agree with the same checkpoint on the CPU
     within ENC_TOL on 80 texts; a fourth App ingests ENC_DOCS synthetic
     hackernews documents (5,000 of the configuration's 150,000) over HTTP
     with a huggingFace embedder on that
     checkpoint and Meilisearch's default documentTemplate, every document
     embedded at indexing on the card (wall time, tokens, tokens/s, peak
     device memory); the query texts are embedded on the card, then 8
     hybrid searches with a text q (semanticRatio 1.0 and 0.5, with and
     without a filter) are served one at a time and from 32 threads and
     must agree with the same store's host pass by the float round's rule;
     after a write of 1,000 documents and the scheduler's device warm, the
     new generation's matrix must be resident before the first search,
     whose time is printed beside the same request with the upload on its
     path; one query's forward and one indexing chunk are timed on the
     device clock, the chunk against its float32 bound;
  8. chain scorer and scatter-gather (run right after phase 3, on its
     store): `entry.entry()` once against the plain version;
     `entry.dryrun_multichip(1)` in a one-rank NCCL group over 62,500
     documents (keyword, typo, tie-block and filter top-10, facet
     histogram and vector top-10, each against the host), then each
     collective it made timed alone in a one-rank NCCL group; the executor
     path with MEILI_TPU_DEVICE=1 over the dry run's queries and QUERIES
     on phase 3's store (bound to the card), every response equal to
     MEILI_TPU_DEVICE=0 and K6 launched; K6 per launch in each mode,
     cold and warm, at T = 4 and the broadest query's candidate count
     (the cost mode on both paths), its bound and plain version, the
     whole chain_query_topk at k = 10 beside the keys mode and the sort
     of all N, and the whole run_device call against the host pass's
     run_raw; the survivors' merge (K6's select_kernel) per pass at the
     same shapes, its launches counted over entry() and the dry run; its
     wall time;
  9. XLM-R encoder path (hn50k-me5base-hf): a checkpoint at
     intfloat/multilingual-e5-base's published width (XLM-RoBERTa, vocab
     250,002, hidden 768, 12 layers, 12 heads, intermediate 3,072, 514
     positions, pad id 1; seeded random weights) with a seeded 250,002-piece
     SentencePiece-Unigram tokenizer.json (NFKC and NMT's precompiled
     character map, Strip, Replace, Metaspace, <s> $A </s>), both written
     here; the port's encoder on the card must agree with the CPU within
     ENC_TOL on 80 texts (accents, Cyrillic, CJK, Arabic, combining marks,
     runs of spaces, unknown characters, the empty string); a fifth App
     ingests 5,000 synthetic hackernews documents over HTTP with a
     huggingFace embedder on that checkpoint, every document embedded at
     indexing on the card (host tokenization apart from the forwards, wall
     time, tokens, tokens/s, peak device memory); 8 hybrid searches with a
     text q against the same store's host pass by the float round's rule,
     one at a time and from 32 threads; one query's forward and one
     indexing chunk on the device clock, the chunk against its float32
     bound;
  10. workloads: the 7 declarative workloads (workloads/tests/*.json)
     through meilisearch_tpu_torch.xtask.run_workload with every App
     bound to the card and device routing forced
     (xtask.device_routing_forced: their stores sit under the device
     thresholds): per workload, the searches the device answered, K1 and
     K3 launches and float-leg calls; api-keys, movies,
     task-queue-compaction and upgrade must be answered on the device,
     embeddings through the float leg, and the phase with no device
     error; any failure is fatal;
  11. BPE and DistilBERT path: two checkpoints at published widths and
     depth (seeded random weights), each through its own App as phase 9:
     hn25k-distilroberta-hf (sentence-transformers/all-distilroberta-v1:
     RoBERTa, vocab 50,265, hidden 768, 6 layers, 12 heads, 3,072, 514
     positions, pad id 1) with a seeded 50,265-token byte-level BPE
     tokenizer.json (models/fixtures.py), and hn25k-mqadistilbert-hf
     (sentence-transformers/multi-qa-distilbert-cos-v1: DistilBERT, vocab
     30,522, dim 768, 6 layers, 12 heads, hidden_dim 3,072, 512 positions)
     with bge_vocab()'s WordPiece file; for each, the encoder on the card
     against the CPU within ENC_TOL on 80 texts (fault 3.11's characters,
     contractions, runs of whitespace, <mask>), 5,000 documents embedded
     at indexing on the card through the BPE tokenizer or the DistilBERT
     module (tokens/s, host tokenization, peak device memory), 8 hybrid
     searches with a text q against the same store's host pass, one at a
     time and from 32 threads, no device error, and the forward's timing;
  12. MPNet path (hn25k-mpnet-hf): a checkpoint at
     sentence-transformers/all-mpnet-base-v2's published config.json
     (MPNet, vocab 30,527, hidden 768, 12 layers, 12 heads, 3,072, 514
     positions, 32 relative buckets, pad id 1; seeded random weights) with
     MPNet's vocabulary layout around bge_vocab() and MPNetTokenizerFast's
     special tokens (models/fixtures.py), through its own App as phase 11:
     the encoder on the card against the CPU within ENC_TOL (phase 11's
     texts and MPNet's specials written in other cases), 5,000 documents
     embedded at indexing on the card, 8 hybrid searches against the same
     store's host pass, and the forward's timing;
  13. ModernBERT path (hn25k-modernbert-hf): a checkpoint at
     answerdotai/ModernBERT-base's published config.json (ModernBERT,
     vocab 50,368, hidden 768, 22 layers, 12 heads, GeGLU intermediate
     1,152, every third layer global and the rest a 128-token sliding
     window, rotary thetas 160,000 and 10,000, no biases; seeded random
     weights, written as model.safetensors) with a seeded byte-level BPE
     tokenizer.json in ModernBERT's layout (NFC, ByteLevel, [CLS] $A [SEP],
     non-special added tokens, [UNK] [CLS] [SEP] [PAD] [MASK] at ids
     50280-50284) and PreTrainedTokenizerFast's tokenizer_config.json
     (models/fixtures.py), through its own App as phase 11: the encoder on
     the card against the CPU within ENC_TOL on phase 11's texts and, in
     one batch, short texts beside texts of 150 to 512 tokens and one that
     truncation cuts at 512 (so the window bites and padding runs fill
     whole windows), 5,000 documents embedded at indexing on the card, 8
     hybrid searches against the same store's host pass, and the forward's
     timing;
  14. the last refused families, each at its published config.json
     widths and depth (seeded random weights) through its own App as
     phase 11, over 5,000 documents: hn10k-camembert-hf (camembert-base:
     XLM-R's layout, vocab 32,005, 12 layers, pad id 1) with a seeded
     32,005-entry Unigram tokenizer.json in CamembertConverter's layout;
     hn10k-electrasmall-hf (google/electra-small-discriminator: 128-wide
     embeddings projected to 256, 12 layers, 4 heads) with bge_vocab()'s
     WordPiece; hn10k-debertav3-hf (microsoft/deberta-v3-base: disentangled
     attention, 256 buckets over 512 positions, p2c|c2p, shared keys) with
     a seeded 128,000-piece Unigram tokenizer.json in DebertaV2Converter's
     layout and, in one batch, phase 13's long texts (relative distances
     past 128 reach its log buckets); for each the encoder on the card
     against the CPU within ENC_TOL, tokens/s and the host share, peak
     device memory, 256 hybrid responses against the host pass, a query's
     forward and launches, and one chunk against its float32 bound;
  15. decoder embedder path (hn10k-qwen3emb-hf): a checkpoint at
     Qwen/Qwen3-Embedding-0.6B's published config.json widths and depth
     (qwen3: vocab 151,669, hidden 1,024, 7 of its 28 layers, 16 heads of 128 over
     8 KV heads, intermediate 3,072, rope_theta 1,000,000; seeded random
     weights at initializer_range 0.02, written as model.safetensors) with
     a seeded 151,643-entry byte-level BPE in Qwen2's layout (NFC, the
     Split pattern, its specials from <|endoftext|> at 151,643, $A
     <|endoftext|>) and Qwen2Tokenizer's tokenizer_config.json with
     padding_side left (models/fixtures.py), through its own App as phase
     11 over 5,000 documents: the encoder on the card against the CPU
     within ENC_TOL on 85 texts, a left-padded batch under forceCls and
     under mean pooling, card against CPU, tokens/s and the host share,
     peak device memory, 256 hybrid responses against the host pass, a
     query's forward and launches against its weight-read bound, and one
     chunk against its float32 bound;
  16. EmbeddingGemma path (hn10k-embeddinggemma-hf): a checkpoint at
     google/embeddinggemma-300m's published config.json widths
     (gemma3_text: vocab 262,144, hidden 768, 6 of its 24 layers, 3 heads
     of 256 over 1 KV head, intermediate 1,152, five sliding layers then
     one full, bidirectional; seeded random weights at initializer_range 0.02,
     written as model.safetensors) with a seeded 262,144-piece
     sentencepiece BPE in GemmaConverter's layout (byte fallback to the
     256 <0xNN> pieces, unk at 3) and GemmaTokenizer's
     tokenizer_config.json with add_bos_token and add_eos_token
     (models/fixtures.py), through its own App as phase 11 over 5,000
     documents: the encoder on the card against the CPU within ENC_TOL on
     texts that fall back to bytes (emoji, CJK, accents, runs of unknown
     symbols), a left-padded batch under forceCls and under mean pooling,
     and two 2-layer checkpoints of the same widths on phase 13's long
     texts, one with a 16-token sliding window and one causal (layer
     types from sliding_window_pattern 2, rope_scaling linear 8 on the
     full layer only, attn_logit_softcapping 50, which the reference
     ignores, and the erf GELU), each card against CPU; tokens/s and the
     host share, peak device memory, 256 hybrid responses against the
     host pass, a query's forward and launches against its weight-read
     bound, and one chunk against its float32 bound;
  17. Llama-3.2-1B path (hn10k-llama32-1b-hf), after the earlier phases'
     encoders are let go: a checkpoint at meta-llama/Llama-3.2-1B's
     published config.json widths (llama: vocab 128,256, hidden
     2,048, 4 of its 16 layers, 32 heads of 64 over 8 KV heads, intermediate
     8,192, rope_theta 500,000 under rope_scaling llama3, factor 32 over
     8,192 positions; seeded random weights at initializer_range 0.02,
     written as model.safetensors) with a seeded byte-level BPE in
     Llama-3's layout (128,000 pieces, 256 specials) and its
     tokenizer_config.json (models/fixtures.py), through its own App as
     phase 11 over 5,000 documents: the encoder on the card against the
     CPU within ENC_TOL on 85 texts and on phase 13's long texts, and
     three 2-layer checkpoints at its widths on the long texts (qwen3 with
     yarn, a 16-token window from layer 1 and the erf GELU; mistral with
     a 16-token window under linear 2; llama with MLP biases and
     gelu_new), each card against CPU; tokens/s and the host share, peak
     device memory, 256 hybrid responses against the host pass, a query's
     forward and launches against its weight-read bound, and one chunk
     against its float32 bound;
  18. ALBERT and ERNIE 3.0 paths (hn10k-albertsmall-hf,
     hn10k-ernie3base-hf), after the earlier phases' encoders are let go:
     checkpoints at sentence-transformers/paraphrase-albert-small-v2's
     published widths (albert: 6 passes over one shared layer, 128-wide
     embeddings projected to 768, 12 heads, intermediate 3,072, gelu_new,
     vocab 30,000) with a seeded 30,000-entry Unigram tokenizer.json in
     AlbertConverter's layout (NFKD, StripAccents, Lowercase, the charsmap,
     `[CLS] $A [SEP]`), and at nghuyong/ernie-3.0-base-zh's (ernie: 12
     layers of 768, 12 heads, intermediate 3,072, vocab 40,000, 4 token
     types, use_task_id over 3 task types, 2,048 positions) with a seeded
     40,000-entry WordPiece vocabulary laid out as ERNIE 3.0's (CJK
     characters first); seeded random weights at initializer_range 0.02,
     written as pytorch_model.bin; each through its own App as phase 11
     over 5,000 documents: the encoder on the card against the CPU
     within ENC_TOL on 85 texts and on phase 13's long texts, tokens/s and
     the host share, peak device memory, 256 hybrid responses against the
     host pass, a query's forward and launches against its weight-read
     bound, and one chunk against its float32 bound; then eight 2-layer
     checkpoints at published widths on the long texts, card against CPU:
     RoFormer at junnyu/roformer_chinese_base's (with and without
     rotary_value), RemBERT at google/rembert's, Megatron-BERT at
     nvidia/megatron-bert-cased-345m's, BertGeneration at
     google/bert_for_seq_generation_L-24_bbc_encoder's, BERT at
     bge-base's with relative_key and with relative_key_query, and ALBERT
     at paraphrase-albert-small-v2's as 4 passes over 2 groups of 2;
  19. MobileBERT and XLNet paths (hn10k-mobilebert-hf,
     hn10k-xlnetbase-hf), after the earlier phases' encoders are let go:
     checkpoints at google/mobilebert-uncased's published config.json
     (mobilebert: 24 layers, 512 wide around a 128-wide bottleneck, 4
     heads, 4 stacked FFNs of 512, NoNorm, relu, the trigram embedding,
     vocab 30,522) with a seeded 30,522-entry WordPiece vocabulary, and at
     xlnet-base-cased's (xlnet: 12 layers of 768, 12 heads, d_inner 3,072,
     relative attention, vocab 32,000, pad id 5) with a seeded
     32,000-entry Unigram tokenizer.json in XLNetConverter's layout
     (left padding, `$A <sep> <cls>`, `<cls>` of type 2, the pad of type
     3, the token types passed to the model); seeded random weights at
     initializer_range 0.02, written as model.safetensors; each through
     its own App as phase 11 over 5,000 documents: the encoder on the
     card against the CPU within ENC_TOL on 85 texts and on phase 13's
     long texts (XLNet's also left-padded under forceCls and under mean
     pooling), tokens/s and the host share, peak device memory, 256
     hybrid responses against the host pass, a query's forward and
     launches against its weight-read bound, and one chunk against its
     float32 bound; then five 2-layer checkpoints at published widths on
     the long texts, card against CPU: SqueezeBERT at
     squeezebert-uncased's (grouped 1 x 1 convolutions), XLM at
     xlm-mlm-en-2048's over a WordPiece (its zero token types add word row
     0), DeBERTa-v2 at deberta-v2-xlarge's with its ConvLayer, DeBERTa-v2
     without relative attention or absolute positions, and DistilBERT
     with sinusoidal positions and ReLU;
  20. XLM and FlauBERT paths (hn10k-xlmen2048-hf,
     hn10k-flaubertbase-hf), after the earlier phases' encoders are let
     go: checkpoints at FacebookAI/xlm-mlm-en-2048's published config.json
     (xlm: 3 of its 12 layers of 2,048, 16 heads, GELU, vocab 30,145) and at
     flaubert/flaubert_base_cased's (flaubert: 12 layers of 768, 12
     heads, post-norm, vocab 68,729), seeded random weights at 0.02,
     written as model.safetensors, each beside its own tokenizer: a seeded
     BPE in XLM's layout at the published vocabulary size (vocab.json +
     merges.txt with counts, models/fixtures.py::moses_bpe_files) and
     XLMTokenizer's tokenizer_config.json (lowercasing and accent
     stripping around Moses) or FlaubertTokenizer's (cased, French
     Moses); each through its own App as phase 11 over 5,000 documents:
     the encoder on the card against the CPU within ENC_TOL on 86 texts
     and on a long batch of Moses texts (newlines, tabs, French quotes,
     non-breaking spaces, elisions, No. 5, 1,000.5, multi-dots and a
     literal <special1> in front of phase 13's long runs), tokens/s and
     the host tokenization's share, peak device memory, 256 hybrid
     responses against the host pass, a query's forward and launches
     against its weight-read bound, and one chunk against its float32
     bound; then three 2-layer checkpoints at published widths on the
     long texts, card against CPU: flaubert_large_cased's pre-norm layers
     (1,024 wide, layerdrop 0.2), flaubert_base_uncased's `do_lowercase`
     over 67,542 words, and xlm-mlm-100-1280's widths (200,000 words, 100
     languages) without `do_lowercase_and_remove_accent`;
  21. bge-multilingual-gemma2 path (hn10k-bgegemma2-hf), after the
     earlier phases' encoders are let go: first three 2-layer checkpoints
     at published widths over seeded 32,000-piece tokenizers, each on
     phase 13's long texts and a left-padded batch under forceCls and mean
     pooling, card against CPU: gemma2 at gemma-2-2b's widths with a
     16-token window and a softcap of 0.5 (ignored, fault 3.20), gemma at
     gemma-2b's (one KV head of 256, hidden_act gelu beside an unread
     hidden_activation) and phi3 at Phi-3-mini-4k-instruct's (a
     Phi3ForCausalLM file, fused qkv_proj and gate_up_proj, a 16-token
     window, partial_rotary_factor 0.75, a seeded three-field longrope over
     131,072 positions from 4,096); then a checkpoint at
     BAAI/bge-multilingual-gemma2's published config.json widths (gemma2:
     gemma-2-9b's, vocab 256,000, hidden 3,584, 2 of its 42 layers, 16
     heads of 256 over 8 KV heads, query_pre_attn_scalar 256, intermediate
     14,336, a 4,096-token window on every other layer, layer types
     derived; seeded random weights at 0.02, written as model.safetensors)
     with a seeded 256,000-piece sentencepiece BPE in GemmaConverter's
     layout, through its own App as phase 11 over 5,000 documents: the
     encoder on the card against the CPU within ENC_TOL on 83 texts, on
     the long texts and on the left-padded batch under both poolings,
     tokens/s and the host share, peak device memory, 256 hybrid
     responses against the host pass, a query's forward and launches
     against its weight-read bound, and one chunk against its float32
     bound;
  22. Longformer path (hn10k-longformerbase-hf), after the earlier
     phases' encoders are let go: a checkpoint at
     allenai/longformer-base-4096's published config.json (longformer: 12
     layers of 768, 12 heads, intermediate 3,072, a 512-token window on
     every layer, 4,098 positions from pad id 1; seeded random weights at
     0.02, its unread `*_global` projections among them, written as
     pytorch_model.bin) with a seeded 50,265-entry byte-level BPE in
     RoBERTa's layout and LongformerTokenizerFast's tokenizer_config.json,
     through its own App as phase 11 over 5,000 documents: the encoder on
     the card against the CPU within ENC_TOL on 83 texts and on phase 13's
     long texts (the pairs the 256-token reach cuts counted), then four
     2-layer checkpoints at published widths on the long texts, card
     against CPU: Longformer with windows [16, 32], data2vec-text at
     data2vec-text-base's widths, xlm-roberta-xl at xlm-roberta-xl's (2,560
     wide, pre-norms) over a seeded 32,000-piece Unigram, and big_bird at
     bigbird-roberta-base's (block_sparse at block 64 and 3 random blocks,
     which the reference runs full at 512 tokens) over a seeded
     50,358-piece Unigram in BigBirdConverter's layout; tokens/s and the
     host share, peak device memory, 256 hybrid responses against the host
     pass, a query's forward and launches against its weight-read bound
     (the `*_global` weights not counted), and one chunk against its
     float32 bound;
  23. BigBird block-sparse path (hn2k-bigbirdsparse-hf), after the earlier
     phases' encoders are let go: a checkpoint at
     google/bigbird-roberta-base's published config.json (big_bird: 12
     layers of 768, 12 heads, intermediate 3,072, gelu_new, 4,096
     positions, pad id 0) under its model card's block_size 16 and
     num_random_blocks 2, so a call past 144 tokens runs block-sparse
     (seeded random weights at 0.02, written as pytorch_model.bin) with
     phase 22's seeded 50,358-piece Unigram, through its own App over
     1,024 documents whose `text` field is a seeded run of 150-900 of the
     corpus's words (100 of them short), rendered with
     documentTemplateMaxBytes 8,000 (the vector store's DEVICE_MIN_ROWS
     lowered to 1, so 1,024 rows take the float leg): the encoder on the
     card against the CPU within ENC_TOL on 83 texts (full attention) and
     on phase 13's long texts (block-sparse, counted), one block-sparse
     chunk of 512 tokens against its float32 bound over the pattern's
     pairs (the (L, L) count printed beside it), the write's forwards
     (fails unless one ran block-sparse), tokens/s and the host share,
     peak device memory, 256 hybrid responses against the host pass, and
     a query's forward (full attention) and launches against its
     weight-read bound.
  24. SGPT path (hn5k-sgpt125m-hf), after the earlier phases' encoders
     are let go: a checkpoint at
     Muennighoff/SGPT-125M-weightedmean-nli-bitfit's published config.json
     at its full depth (gpt_neo: 12 layers of 768, 12 heads, global and
     local layers alternating with a 256-token window, unscaled scores,
     gelu_new, 2,048 learned positions; seeded random weights and biases
     at 0.02, written as pytorch_model.bin) with a seeded 50,257-entry
     byte-level BPE in GPT-2's layout (`<|endoftext|>` its pad), through
     its own App as phase 11 over 5,000 documents: the encoder on the card
     against the CPU within ENC_TOL on 83 texts, on phase 13's long texts
     (the causal pairs the window cuts counted) and on a batch padded right
     and then left under forceCls and mean pooling; then two 2-layer
     checkpoints at published widths, each padded right and left under
     both poolings, card against CPU: gptj at SGPT-5.8B's widths (4,096
     wide, 16 heads of 256, rotary_dim 64, vocabulary 50,400) over the
     path's BPE, and bloom at udever-bloom-560m's (1,024 wide, 16 heads, a
     250,880-row embedding, ALiBi) over a seeded 32,000-piece BPE in
     BLOOM's layout (its Split pattern, left padding); tokens/s and the
     host share, peak device memory, 256 hybrid responses against the host
     pass, a query's forward and launches against its weight-read bound,
     and one chunk against its float32 bound.
  25. MoE path (hn5k-gritlm8x7b-hf), after the earlier phases' encoders
     are let go: first two 2-layer checkpoints at published widths, each
     one BF16 model.safetensors over a seeded 32,000-piece BPE in Qwen2's
     layout, padded right and left under both poolings, card against CPU:
     qwen2_moe at Qwen1.5-MoE-A2.7B's (60 experts of 1,408, top 4
     unnormalized, a shared expert) and qwen3_moe at Qwen3-30B-A3B's (128
     experts of 768, top 8 renormalized, Q/K norms); then a checkpoint at
     GritLM/GritLM-8x7B's published config.json (mixtral: 4,096 wide, 32
     heads over 8 KV heads, 8 experts of 14,336, top 2, no window) cut to
     2 of its 32 layers, seeded weights drawn on the card and written as
     BF16 shards with their index (MixtralForCausalLM's names) beside a
     seeded 32,000-piece Llama byte-fallback BPE padded left, through its
     own App as phase 11 over 5,000 documents, both encoders reading the
     shards: the encoder on the card against the CPU on 83 texts, phase
     13's long texts and a batch padded right and left under both
     poolings, each under the routing rule (the gates' logits captured by
     forward hooks on both devices: a token whose experts differ where the
     CPU's margin between its k-th and (k+1)-th routing weight is at least
     ROUTE_MARGIN fails the phase; a text with a difference at a smaller
     margin is printed and kept out of the ENC_TOL maximum); the shards'
     read time, tokens/s and the host share, peak device memory, 256
     hybrid responses against the host pass, a query's forward, launches
     and experts hit against its weight-read bound over those experts,
     and one chunk against its float32 bound over the routed work.
  26. BMRetriever path (hn5k-bmretriever410m-hf), after the earlier
     phases' encoders are let go: a checkpoint at
     BMRetriever/BMRetriever-410M's widths (EleutherAI/pythia-410m's
     config.json as recalled: gpt_neox, 24 layers of 1,024, 16 heads of 64
     with 16 rotated channels, intermediate 4,096, the parallel residual)
     at its full depth, seeded weights and biases at 0.02 written as
     GPTNeoXForCausalLM's pytorch_model.bin (`gpt_neox.` names,
     `embed_out` and each layer's stale causal buffers, which the port's
     mapping drops) beside a seeded 50,277-entry byte-level BPE in
     GPT-NeoX-20B's layout (NFC, `<|padding|>` its pad), through its own
     App as phase 11 over 5,000 documents: the encoder on the card against
     the CPU within ENC_TOL on 86 texts, on phase 13's long texts and on a
     batch padded right and then left under forceCls and mean pooling;
     then a 2-layer checkpoint at BMRetriever-1B's widths (pythia-1b's:
     2,048 wide, 8 heads of 256 with 64 rotated channels, intermediate
     8,192) padded right and left under both poolings, card against CPU;
     tokens/s and the host share, peak device memory, 256 hybrid
     responses against the host pass, a query's forward and launches
     against its weight-read bound, and one chunk against its float32
     bound.
Every phase prints its wall as it ends, and the walls are printed
together after phase 26.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result. The run fails if any
module of jax or of the JAX package is loaded at its end.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import resource
import statistics
import subprocess
import sys
import threading
import time
from functools import lru_cache, partial

K1_SOURCE = "meilisearch_tpu_torch/csrc/chain_keys.cu"
K1_REPLACES = "meilisearch_tpu/ops/pallas_scorer.py:256"
K3_SOURCE = "meilisearch_tpu_torch/csrc/osa.cu"
K3_REPLACES = "meilisearch_tpu/ops/device_osa.py:50"
K4H_SOURCE = "meilisearch_tpu_torch/csrc/hamming.cu"
K4H_REPLACES = "meilisearch_tpu/vector/store.py:388"
K6_SOURCE = "meilisearch_tpu_torch/csrc/chain_dp.cu"
K6_REPLACES = "meilisearch_tpu/ops/device_scorer.py:56"
# the survivors' merge replaces chain_query_topk's lax.sort of all N
K6_SELECT_REPLACES = "meilisearch_tpu/ops/device_scorer.py:206"
# the card's peaks for the bounds: HBM3 bytes/s (data sheet), int32 lanes
# (Hopper white paper: 64 INT32 units per SM, 132 SMs, 1.98 GHz), 32-bit
# population counts (16 per clock per SM, the CUDA C++ programming guide's
# throughput table for compute capability 9.0) and float32 outside the
# tensor cores (data sheet)
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 64 * 132 * 1.98e9
POPC_OPS_S = 16 * 132 * 1.98e9
FP32_FLOP_S = 67e12
THREADS = 32
# the integer instructions per letter read of csrc/osa.cu's recurrence,
# counted in its sm_90a SASS (cuobjdump -sass): the transposition and
# diagonal-zero vectors and the deltas (nine LOP3, one add, three shifts)
# and the score at bit m - 1 (two shifts, two ands, one add) with its
# running minimum. Not counted: the match-mask lookup (a hash, a shared
# load, a compare), which another way of finding the mask could spare,
# and the loop's cut test and branch
OSA_OPS_PER_LETTER = 19
# the kernels, by name in a profiler trace
K1_KERNEL, K3_KERNEL, K4H_KERNEL = "chain_keys_kernel", "osa_kernel", "hamming_kernel"
K6_KERNEL = "chain_dp_kernel"
L2_FLUSH_BYTES = 256 << 20  # written before a cold launch: 5x the 50 MB L2
REPEATS = 5  # repeats of a kernel's cold and warm launches in the timing phase
# K4h's checked widths: 32, 96, 100, 384, 768 and 1536 dimensions
HAM_WIDTHS = (1, 3, 4, 12, 24, 48)
# launches that open a traced session, not timed, the first followed by a
# wait (launch_ms): the whole script's later sessions lost up to 26
SENTINELS = 32
TRACE_SETTLE_S = 0.25
# the chain scorer's checks: K6 at every T of this ladder, at these widths
# and at K6_BROAD_N, the candidates of the executor's broadest query
# ('show tell' on the keyword phase's 500,000 documents)
K6_TERMS = (1, 2, 3, 4, 8, 16)
K6_WIDTHS = ((1 << 14) + 3, 1 << 19)
K6_BROAD_N = 355_439
K6_TOPK = 10  # the k at which the top-k mode and chain_query_topk are timed
# K6's int32 operations per column, counted in csrc/chain_dp.cu with each
# compare folded into its predicate (ISETP with a predicate operand): the
# first term's 3 visits of 6 adds; each later term's 9 visits of 6 adds,
# 9 lexicographic mins of 12 compares and 6 selects, 3 mask selects and
# 4 skip adds; the final 3 mins and the clip; the keys mode's packing
K6_OPS_FIRST, K6_OPS_TERM, K6_OPS_FINAL, K6_OPS_PACK = 18, 223, 60, 30
# the dry run's depth: an eighth of the keyword phase's (a quarter before
# phase 21, half before phase 19), the first of the cuts that keep the
# whole script under 1,080 s
DRYRUN_DOCS = 62_500
# the dry run's queries (meilisearch_tpu_torch/entry.py), served through
# the executor with MEILI_TPU_DEVICE=1 beside QUERIES
CHAIN_QUERIES = [
    {"q": "rust database"}, {"q": "machin learnin"}, {"q": "zebra stripe"},
    {"q": "python", "filter": "points > 2500"}, {"q": "rust"},
]
# the typo path's vocabulary: above the device gate (2^19 words), and the
# n = 2^20 rows at which K3 is timed
TYPO_VOCAB_WORDS = 1 << 20
# the vector path's configuration, hn150k-bge768: 150,000 hackernews-like
# documents and a userProvided embedder of 768 dimensions, the width of
# BAAI/bge-base-en-v1.5 (Meilisearch's default huggingFace model); the
# vectors are seeded draws around 512 centres, every 7th document two.
# 120,000 of them since phase 25 came (137,143 rows: the card's matrix
# still pads to 2^18, K4h's n)
VEC_DOCS, VEC_DIM, VEC_CENTRES, VEC_BATCH, VEC_SEED = 120_000, 768, 512, 10_000, 2024
VEC_SETTINGS = {
    "searchableAttributes": ["title", "url", "author"],
    "filterableAttributes": ["points"],
    "embedders": {"default": {"source": "userProvided", "dimensions": VEC_DIM}},
}
VEC_TEXT = ["rust", "database", "machine learning", "cloud", "python web"]
# requests a client sends in each of the vector path's two served rounds:
# a sixth of its 24 in its rotation, 128 a round, every request 4 to 8
# times (8 and 256 until phase 25 came)
VEC_SERVED_PER_CLIENT = 4
# the encoder path, hn150k-bgebase-hf: the vector path's corpus with a
# huggingFace embedder at BAAI/bge-base-en-v1.5's published width (random
# weights from a seed, nothing downloaded) and Meilisearch's default
# documentTemplate; every document is embedded at indexing on the card.
# 5,000 of its 150,000 documents: the depth cut (50,000 until phase 17
# came, 25,000 until phase 23, 10,000 until phase 25) that keeps the
# whole script under its limit
BGE_CONFIG = {
    "vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
}
BGE_INIT_STD = 0.02  # BERT's initializer_range
ENC_DOCS, ENC_WRITE, ENC_SEED = 5_000, 1_000, 2025
ENC_TOL = 1e-4  # max abs error of normalized embeddings, card against the CPU
ENC_TEXT = ["rust compiler", "machine learning database", "cloud security", "python web"]
ENC_TIMED_TOKENS = 128  # tokens per text of the timed indexing chunk
# the XLM-R path, hn50k-me5base-hf: intfloat/multilingual-e5-base's
# published config.json (xlm-roberta-base's widths) with seeded random
# weights, a seeded 250,002-piece SentencePiece-Unigram tokenizer.json
# written as transformers' XLM-R converter writes it (NFKC and NMT's
# character map, Strip, Replace, Metaspace, <s> $A </s>), and 5,000 of
# its 50,000 hackernews documents embedded at indexing on the card (the
# depth cut, 50,000 until phase 18 came, 25,000 until phase 22 and 10,000
# until phase 24 came, that keeps the whole script under its limit; every
# encoder phase from 9 to 22 runs 5,000)
E5_CONFIG = {
    "model_type": "xlm-roberta", "vocab_size": 250_002, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu",
}
E5_DOCS, E5_SEED = 5_000, 2026
E5_TEXT = ["rust compiler", "machine learning database", "поиск cloud security",
           "python web 検索"]
# multilingual texts of the card-against-CPU check (accents, Cyrillic, CJK,
# Arabic, combining marks, runs of spaces, characters no piece holds, and
# the empty string)
E5_CHECK_TEXT = [
    "Café naïve résumé — déjà vu", "Ünïcödé façade coöperate",
    "Привет, мир! Поиск в базе данных", "Москва — столица России", "中文字 搜索引擎 数据库",
    "東京の検索エンジン 日本語", "한국어 검색 엔진", "مرحبا بالعالم بحث", "قاعدة البيانات",
    "élève q́̈", "ﬁne ½ ① Ａｂｃ ™",
    "runs    of     spaces\tand\ttabs\nnew\r\nlines", "   leading and trailing   ", "",
    "emoji \U0001F468‍\U0001F469‍\U0001F467 \U0001F44D\U0001F3FD \U0001F1EB\U0001F1F7"
    " ✈ \U0001D518\U0001D52B\U0001D526",
    "zero​width﻿bom", "Ελληνικά κείμενα", "हिन्दी खोज", "ქართული ტექსტი",
    "straße über " * 8, "<mask> and <s> inside </s>", "Ǆ ǅ ǆ İstanbul ΣΑΣ",
    "tab\there\x07bell\x01", "rust \U0001F680 machine learning ✨ data",
]
# phase 11, the BPE and DistilBERT path: two checkpoints at their published
# config.json widths and depth (6 layers) with seeded random weights, each
# embedding 5,000 of its configuration's 150,000 hackernews documents at
# indexing on the card (25,000 until phase 22 came).
# hn25k-distilroberta-hf: sentence-transformers/all-distilroberta-v1
# (RoBERTa) with a 50,265-token byte-level BPE
# tokenizer.json (models/fixtures.py: merges trained on BPE_TRAIN_DOCS of
# the phase's documents, then seeded merges); hn25k-mqadistilbert-hf:
# sentence-transformers/multi-qa-distilbert-cos-v1 (DistilBERT) with
# bge_vocab()'s WordPiece vocabulary
DISTILROBERTA_CONFIG = {
    "model_type": "roberta", "vocab_size": 50_265, "hidden_size": 768,
    "num_hidden_layers": 6, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "hidden_act": "gelu",
}
DISTILBERT_CONFIG = {
    "model_type": "distilbert", "vocab_size": 30_522, "dim": 768, "n_layers": 6,
    "n_heads": 12, "hidden_dim": 3072, "max_position_embeddings": 512, "activation": "gelu",
    "sinusoidal_pos_embds": False, "pad_token_id": 0,
}
P11_DOCS, P11_SEED, BPE_TRAIN_DOCS = 5_000, 2027, 5_000
# phase 12, hn25k-mpnet-hf: sentence-transformers/all-mpnet-base-v2's
# published config.json with seeded random weights and MPNet's vocabulary
# around bge_vocab()'s WordPiece entries. 5,000 of the configuration's
# 150,000 hackernews documents: the depth cut (25,000 until phase 22 came)
# to keep the whole script under 1,080 s; widths, depth and vocabulary
# size are the published ones
MPNET_CONFIG = {
    "model_type": "mpnet", "vocab_size": 30_527, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "relative_attention_num_buckets": 32,
    "layer_norm_eps": 1e-5, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
    "hidden_act": "gelu", "initializer_range": 0.02,
}
P12_DOCS, P12_SEED = 5_000, 2028
# phase 13, hn25k-modernbert-hf: answerdotai/ModernBERT-base's published
# config.json (transformers' ModernBertConfig defaults) with seeded random
# weights and a seeded 50,368-entry tokenizer in ModernBERT's layout. 5,000
# of the configuration's 150,000 hackernews documents: phases 11 and 12's
# depth cut; widths, depth and vocabulary size are the published ones
MODERNBERT_CONFIG = {
    "model_type": "modernbert", "vocab_size": 50_368, "hidden_size": 768,
    "intermediate_size": 1152, "num_hidden_layers": 22, "num_attention_heads": 12,
    "hidden_activation": "gelu", "max_position_embeddings": 8192, "initializer_range": 0.02,
    "norm_eps": 1e-5, "norm_bias": False, "attention_bias": False, "mlp_bias": False,
    "global_attn_every_n_layers": 3, "local_attention": 128, "global_rope_theta": 160000.0,
    "local_rope_theta": 10000.0, "pad_token_id": 50283, "bos_token_id": 50281,
    "eos_token_id": 50282, "cls_token_id": 50281, "sep_token_id": 50282,
}
P13_DOCS, P13_SEED = 5_000, 2029
# phase 14, the last refused families, each at its published config.json
# widths and depth with seeded random weights, 5,000 of its
# configuration's 150,000 hackernews documents (the depth cut that keeps
# the whole script near 700 s): hn10k-camembert-hf, camembert-base with a
# seeded 32,005-entry Unigram tokenizer.json in CamembertConverter's layout;
# hn10k-electrasmall-hf, google/electra-small-discriminator (128-wide
# embeddings projected to 256) with bge_vocab()'s WordPiece;
# hn10k-debertav3-hf, microsoft/deberta-v3-base (disentangled attention,
# 256 buckets) with a seeded 128,000-piece Unigram tokenizer.json in
# DebertaV2Converter's layout, [MASK] at 128,000, and the long check texts
CAMEMBERT_CONFIG = {
    "model_type": "camembert", "vocab_size": 32_005, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
    "pad_token_id": 1, "bos_token_id": 5, "eos_token_id": 6, "hidden_act": "gelu",
}
ELECTRA_SMALL_CONFIG = {
    "model_type": "electra", "vocab_size": 30_522, "embedding_size": 128, "hidden_size": 256,
    "num_hidden_layers": 12, "num_attention_heads": 4, "intermediate_size": 1024,
    "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
    "pad_token_id": 0, "hidden_act": "gelu",
}
DEBERTA_V3_CONFIG = {
    "model_type": "deberta-v2", "vocab_size": 128_100, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "relative_attention": True, "position_buckets": 256,
    "max_relative_positions": -1, "pos_att_type": "p2c|c2p", "norm_rel_ebd": "layer_norm",
    "share_att_key": True, "position_biased_input": False, "type_vocab_size": 0,
    "layer_norm_eps": 1e-7, "pad_token_id": 0, "hidden_act": "gelu",
}
P14_DOCS, P14_SEED = 5_000, 2030
# phase 15, hn10k-qwen3emb-hf: Qwen/Qwen3-Embedding-0.6B's published
# config.json with seeded random weights (transformers' initializer_range
# 0.02, so the random layers stay finite), a seeded 151,643-entry
# byte-level BPE in Qwen2's layout with its 26 specials (151,669 ids) and
# Qwen3-Embedding's `$A <|endoftext|>` template, and its tokenizer_config's
# padding_side left. 5,000 of the configuration's 150,000 hackernews
# documents: phase 14's depth cut; 7 of its 28 layers, the cut that keeps
# the whole script under 1,080 s with phase 22 (14 from phase 19 on); widths and vocabulary
# size are the published ones
QWEN3_EMBEDDING_CONFIG = {
    "model_type": "qwen3", "vocab_size": 151_669, "hidden_size": 1024,
    "num_hidden_layers": 7, "num_attention_heads": 16, "num_key_value_heads": 8,
    "head_dim": 128, "intermediate_size": 3072, "rope_theta": 1_000_000,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 32_768, "tie_word_embeddings": True,
    "hidden_act": "silu", "attention_bias": False, "attention_dropout": 0.0,
    "use_sliding_window": False, "sliding_window": None, "max_window_layers": 28,
    "rope_scaling": None, "initializer_range": 0.02, "bos_token_id": 151_643,
    "eos_token_id": 151_643,
}
QWEN3_BPE_SIZE = 151_643
P15_DOCS, P15_SEED = 5_000, 2031
# phase 16, hn10k-embeddinggemma-hf: google/embeddinggemma-300m's
# published config.json (gemma3_text, bidirectional: its sliding_window 512
# reaches 512 // 2 + 1 = 257 tokens each way once transformers' config is
# built) with seeded random weights at its initializer_range 0.02, a seeded
# 262,144-piece sentencepiece BPE in GemmaConverter's layout (pad 0, eos 1,
# bos 2, unk 3, the 256 <0xNN> byte pieces) and GemmaTokenizer's
# tokenizer_config.json with add_bos_token and add_eos_token both true.
# 5,000 of the configuration's 150,000 hackernews documents: phase 15's
# depth cut; widths and vocabulary size are the published ones, and 6 of
# its 24 layers (a run of five sliding and one full; 12 until phase 23)
EMBEDDINGGEMMA_CONFIG = {
    "model_type": "gemma3_text", "vocab_size": 262_144, "hidden_size": 768,
    "intermediate_size": 1152, "num_hidden_layers": 6, "num_attention_heads": 3,
    "num_key_value_heads": 1, "head_dim": 256, "query_pre_attn_scalar": 256,
    "sliding_window": 512, "layer_types": ["sliding_attention"] * 5 + ["full_attention"],
    "rope_theta": 1_000_000.0, "rope_local_base_freq": 10_000.0, "rope_scaling": None,
    "rms_norm_eps": 1e-6, "hidden_activation": "gelu_pytorch_tanh", "attention_bias": False,
    "attention_dropout": 0.0, "attn_logit_softcapping": None, "final_logit_softcapping": None,
    "use_bidirectional_attention": True, "max_position_embeddings": 2048,
    "initializer_range": 0.02, "tie_word_embeddings": True, "pad_token_id": 0,
    "eos_token_id": 1, "bos_token_id": 2,
}
# the window check's checkpoint: the same widths, 2 layers (one sliding,
# one full), a 16-token sliding_window (a reach of 9), on the long texts
GEMMA_WINDOW_CONFIG = {**EMBEDDINGGEMMA_CONFIG, "num_hidden_layers": 2, "sliding_window": 16,
                       "layer_types": ["sliding_attention", "full_attention"]}
# and a causal one: layer types from sliding_window_pattern 2 (sliding, then
# full), the larger Gemma 3 decoders' linear 8 on the full layer's rotary
# only, a softcap the reference ignores (fault 3.20), the erf GELU
GEMMA_VARIANT_CONFIG = {
    **{k: v for k, v in GEMMA_WINDOW_CONFIG.items() if k != "layer_types"},
    "use_bidirectional_attention": False, "sliding_window_pattern": 2,
    "rope_scaling": {"rope_type": "linear", "factor": 8.0}, "attn_logit_softcapping": 50.0,
    "hidden_activation": "gelu"}
P16_DOCS, P16_SEED = 5_000, 2032
# phase 17, hn10k-llama32-1b-hf: meta-llama/Llama-3.2-1B's published
# config.json (llama, rope_scaling llama3 factor 32 over 8,192 positions,
# tied embeddings) with seeded random weights at its initializer_range
# 0.02, a seeded byte-level BPE in Llama-3's layout (128,000 pieces, then
# its 256 specials from <|begin_of_text|> at 128,000) and
# PreTrainedTokenizerFast's tokenizer_config.json with pad
# <|finetune_right_pad_id|>. 5,000 of the configuration's 150,000
# hackernews documents: phase 16's depth cut; widths and vocabulary size
# are the published ones, and 4 of its 16 layers (8 until phase 23)
LLAMA32_1B_CONFIG = {
    "model_type": "llama", "vocab_size": 128_256, "hidden_size": 2048,
    "intermediate_size": 8192, "num_hidden_layers": 4, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 64, "rms_norm_eps": 1e-5, "rope_theta": 500_000.0,
    "rope_scaling": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "max_position_embeddings": 131_072, "hidden_act": "silu", "attention_bias": False,
    "attention_dropout": 0.0, "mlp_bias": False, "tie_word_embeddings": True,
    "initializer_range": 0.02, "bos_token_id": 128_000, "eos_token_id": 128_001,
}
LLAMA3_BPE_SIZE, LLAMA3_RESERVED = 128_000, 248
P17_DOCS, P17_SEED = 5_000, 2033
# the decoder variants, 2 layers each at the phase's widths on its
# tokenizer, on phase 13's long texts: (a) Qwen3's documented long-context
# yarn (factor 4 over 32,768) with a 16-token window from layer 1 and the
# erf GELU, (b) a Mistral window of 16 under linear 2, (c) Llama's MLP
# biases (drawn, not 0) and gelu_new
_P17_WIDTHS = {k: LLAMA32_1B_CONFIG[k] for k in (
    "vocab_size", "hidden_size", "intermediate_size", "num_attention_heads",
    "num_key_value_heads", "head_dim", "rms_norm_eps", "rope_theta")}
DECODER_VARIANTS = {
    "(a) qwen3, yarn 4 over 32,768, window 16 from layer 1, gelu": {
        **_P17_WIDTHS, "model_type": "qwen3", "num_hidden_layers": 2,
        "max_position_embeddings": 131_072, "use_sliding_window": True, "sliding_window": 16,
        "max_window_layers": 1, "hidden_act": "gelu",
        "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                         "original_max_position_embeddings": 32_768}},
    "(b) mistral, window 16, linear 2": {
        **_P17_WIDTHS, "model_type": "mistral", "num_hidden_layers": 2, "sliding_window": 16,
        "rope_scaling": {"rope_type": "linear", "factor": 2.0}},
    "(c) llama, mlp_bias, gelu_new": {
        **{k: v for k, v in LLAMA32_1B_CONFIG.items() if k != "num_hidden_layers"},
        "num_hidden_layers": 2, "mlp_bias": True, "hidden_act": "gelu_new"},
}
# phase 18, hn10k-albertsmall-hf: sentence-transformers/
# paraphrase-albert-small-v2's published config.json, and
# hn10k-ernie3base-hf: nghuyong/ernie-3.0-base-zh's; seeded random weights
# at initializer_range 0.02, 5,000 of the configurations' 150,000
# hackernews documents (phase 17's depth cut; widths, depth and vocabulary
# sizes are the published ones)
ALBERT_SMALL_CONFIG = {
    "model_type": "albert", "vocab_size": 30_000, "embedding_size": 128, "hidden_size": 768,
    "num_hidden_layers": 6, "num_hidden_groups": 1, "inner_group_num": 1,
    "num_attention_heads": 12, "intermediate_size": 3072, "max_position_embeddings": 512,
    "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_act": "gelu_new",
    "position_embedding_type": "absolute", "pad_token_id": 0, "bos_token_id": 2,
    "eos_token_id": 3,
}
ERNIE3_BASE_CONFIG = {
    "model_type": "ernie", "vocab_size": 40_000, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072, "max_position_embeddings": 2048,
    "type_vocab_size": 4, "task_type_vocab_size": 3, "use_task_id": True,
    "layer_norm_eps": 1e-5, "hidden_act": "gelu", "pad_token_id": 0,
}
P18_DOCS, P18_SEED = 5_000, 2034
# the BERT-shaped variants, 2 layers each at a published checkpoint's widths
# (ALBERT: 4 passes, the fewest that 2 groups of 2 allow), on phase 13's
# long texts
_ROFORMER_BASE = {
    "model_type": "roformer", "vocab_size": 50_000, "embedding_size": 768, "hidden_size": 768,
    "num_hidden_layers": 2, "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 1536, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
    "hidden_act": "gelu", "rotary_value": False, "pad_token_id": 0}
BERT_VARIANTS = {
    "(a) roformer_chinese_base": _ROFORMER_BASE,
    "(b) roformer_chinese_base, rotary_value": {**_ROFORMER_BASE, "rotary_value": True},
    "(c) rembert": {
        "model_type": "rembert", "vocab_size": 250_300, "input_embedding_size": 256,
        "output_embedding_size": 1664, "hidden_size": 1152, "num_hidden_layers": 2,
        "num_attention_heads": 18, "intermediate_size": 4608, "max_position_embeddings": 512,
        "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_act": "gelu", "pad_token_id": 0},
    "(d) megatron-bert-cased-345m": {
        "model_type": "megatron-bert", "vocab_size": 29_056, "hidden_size": 1024,
        "num_hidden_layers": 2, "num_attention_heads": 16, "intermediate_size": 4096,
        "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12,
        "hidden_act": "gelu", "pad_token_id": 0},
    "(e) bert_for_seq_generation_L-24_bbc_encoder": {
        "model_type": "bert-generation", "vocab_size": 50_358, "hidden_size": 1024,
        "num_hidden_layers": 2, "num_attention_heads": 16, "intermediate_size": 4096,
        "max_position_embeddings": 512, "layer_norm_eps": 1e-12, "hidden_act": "gelu",
        "pad_token_id": 0},
    "(f) bge-base, relative_key": {
        **BGE_CONFIG, "num_hidden_layers": 2, "position_embedding_type": "relative_key"},
    "(g) bge-base, relative_key_query": {
        **BGE_CONFIG, "num_hidden_layers": 2, "position_embedding_type": "relative_key_query"},
    "(h) paraphrase-albert-small-v2, 4 passes over 2 groups of 2": {
        **ALBERT_SMALL_CONFIG, "num_hidden_layers": 4, "num_hidden_groups": 2,
        "inner_group_num": 2},
}
# phase 19, hn10k-mobilebert-hf: google/mobilebert-uncased's published
# config.json (MobileBertConfig's defaults: the 128-wide bottleneck inside
# 512-wide layers, 4 stacked FFNs, NoNorm, the trigram embedding), and
# hn10k-xlnetbase-hf: xlnet-base-cased's; seeded random weights at
# initializer_range 0.02 (NoNorm's scales 1 and MobileBERT's pad row 0, as
# transformers starts them), a seeded 30,522-entry WordPiece and a seeded
# 32,000-piece Unigram in XLNetConverter's layout (left padding, `<cls>`
# last with type 2). 5,000 of the configurations' 150,000 hackernews
# documents: phase 18's depth cut; widths, depth and vocabulary sizes are
# the published ones
MOBILEBERT_UNCASED_CONFIG = {
    "model_type": "mobilebert", "vocab_size": 30_522, "hidden_size": 512,
    "num_hidden_layers": 24, "num_attention_heads": 4, "intermediate_size": 512,
    "hidden_act": "relu", "max_position_embeddings": 512, "type_vocab_size": 2,
    "embedding_size": 128, "true_hidden_size": 128, "intra_bottleneck_size": 128,
    "use_bottleneck": True, "use_bottleneck_attention": False,
    "key_query_shared_bottleneck": True, "num_feedforward_networks": 4,
    "normalization_type": "no_norm", "trigram_input": True, "classifier_activation": False,
    "layer_norm_eps": 1e-12, "pad_token_id": 0,
}
XLNET_BASE_CONFIG = {
    "model_type": "xlnet", "vocab_size": 32_000, "d_model": 768, "n_layer": 12, "n_head": 12,
    "d_head": 64, "d_inner": 3072, "ff_activation": "gelu", "untie_r": True,
    "attn_type": "bi", "bi_data": False, "clamp_len": -1, "same_length": False,
    "mem_len": None, "reuse_len": None, "layer_norm_eps": 1e-12, "pad_token_id": 5,
    "bos_token_id": 1, "eos_token_id": 2,
}
P19_DOCS, P19_SEED = 5_000, 2035
# FacebookAI/xlm-mlm-en-2048's config.json (XLMConfig's names): 2,048
# wide, 16 heads, GELU, one language, 30,145 words; 3 of its 12 layers
# (6 until phase 23)
XLM_EN_2048_CONFIG = {
    "model_type": "xlm", "vocab_size": 30_145, "emb_dim": 2048, "n_layers": 3,
    "n_heads": 16, "gelu_activation": True, "sinusoidal_embeddings": False,
    "causal": False, "n_langs": 1, "use_lang_emb": True, "max_position_embeddings": 512,
    "layer_norm_eps": 1e-12, "pad_index": 2, "pad_token_id": 2, "is_encoder": True}
# the other encoders the JAX package embeds, 2 layers each at a published
# checkpoint's widths, on phase 13's long texts: (a) squeezebert-uncased's
# grouped convolutions, (b) xlm-mlm-en-2048 over a WordPiece (its zero
# token types add word row 0), (c) deberta-v2-xlarge's ConvLayer, (d)
# deberta-v3-base's widths without relative attention or absolute
# positions, (e) multi-qa-distilbert-cos-v1's widths with sinusoidal
# positions and ReLU
P19_VARIANTS = {
    "(a) squeezebert-uncased": {
        "model_type": "squeezebert", "vocab_size": 30_528, "hidden_size": 768,
        "embedding_size": 768, "num_hidden_layers": 2, "num_attention_heads": 12,
        "intermediate_size": 3072, "hidden_act": "gelu", "max_position_embeddings": 512,
        "type_vocab_size": 2, "q_groups": 4, "k_groups": 4, "v_groups": 4,
        "post_attention_groups": 1, "intermediate_groups": 4, "output_groups": 4,
        "layer_norm_eps": 1e-12, "pad_token_id": 0},
    "(b) xlm-mlm-en-2048": {**XLM_EN_2048_CONFIG, "n_layers": 2},
    "(c) deberta-v2-xlarge, ConvLayer": {
        **DEBERTA_V3_CONFIG, "hidden_size": 1536, "num_hidden_layers": 2,
        "num_attention_heads": 24, "intermediate_size": 6144, "conv_kernel_size": 3,
        "conv_act": "gelu"},
    "(d) deberta-v2, no relative attention": {
        **DEBERTA_V3_CONFIG, "num_hidden_layers": 2, "relative_attention": False},
    "(e) distilbert, sinusoidal, relu": {
        **DISTILBERT_CONFIG, "n_layers": 2, "sinusoidal_pos_embds": True, "activation": "relu"},
}
# phase 20 (after phase 19's encoders are let go): xlm-mlm-en-2048 (above)
# and flaubert/flaubert_base_cased's config.json (12 layers of 768, 12
# heads, GELU, post-norm, 68,729 words) with their own tokenizers: a
# seeded BPE in XLM's layout at the published vocabulary sizes
# (models/fixtures.py::moses_bpe_files: the specials at ids 0-13, merges
# trained on the corpus's Moses tokens) and each class's
# tokenizer_config.json (XLM: `do_lowercase_and_remove_accent`; FlauBERT:
# cased). 5,000 of the configurations' 150,000 hackernews documents:
# phase 18's depth cut; widths, depth and vocabulary sizes are the
# published ones
FLAUBERT_BASE_CASED_CONFIG = {
    "model_type": "flaubert", "vocab_size": 68_729, "emb_dim": 768, "n_layers": 12,
    "n_heads": 12, "gelu_activation": True, "sinusoidal_embeddings": False,
    "causal": False, "n_langs": 1, "use_lang_emb": True, "max_position_embeddings": 512,
    "layer_norm_eps": 1e-12, "pad_index": 2, "pad_token_id": 2, "is_encoder": True,
    "pre_norm": False, "layerdrop": 0.0}
P20_DOCS, P20_SEED = 5_000, 2036
P20_TRAINING_DOCS = 2_000  # documents whose Moses tokens the seeded merges learn from
# 2 layers each at a published checkpoint's widths, on the long Moses texts:
# (a) flaubert_large_cased's pre-norm layers (1,024 wide, 16 heads,
# layerdrop 0.2) over flaubert_base_cased's tokenizer; (b)
# flaubert_base_uncased's `do_lowercase` over its own 67,542 words; (c)
# xlm-mlm-100-1280's widths (1,280, 16 heads, 100 languages, 200,000
# words) without `do_lowercase_and_remove_accent`. Each: (config, tokenizer
# class, its flags)
P20_VARIANTS = {
    "(a) flaubert_large_cased, pre_norm": (
        {**FLAUBERT_BASE_CASED_CONFIG, "emb_dim": 1024, "n_heads": 16, "n_layers": 2,
         "pre_norm": True, "layerdrop": 0.2}, "FlaubertTokenizer", {}),
    "(b) flaubert_base_uncased": (
        {**FLAUBERT_BASE_CASED_CONFIG, "n_layers": 2, "vocab_size": 67_542},
        "FlaubertTokenizer", {"do_lowercase": True}),
    "(c) xlm-mlm-100-1280": (
        {**XLM_EN_2048_CONFIG, "emb_dim": 1280, "n_layers": 2, "n_langs": 100,
         "vocab_size": 200_000}, "XLMTokenizer", {"do_lowercase_and_remove_accent": False}),
}
# phase 21 (after phase 20's encoders are let go), hn10k-bgegemma2-hf:
# BAAI/bge-multilingual-gemma2's published config.json (gemma2 at
# gemma-2-9b's widths: 3,584 wide, 16 heads of 256 over 8 KV heads, so Q
# is 4,096 wide, query_pre_attn_scalar 256, intermediate 14,336, a
# 4,096-token window on every other layer from the first, softcaps 50 and
# 30, which the reference's sdpa and its missing LM head leave unread;
# no layer_types, so the module derives them) with seeded random weights
# at its initializer_range 0.02, 2 of its 42 layers (the float32 file of
# all 42 is 37 GB; 4 until phase 22 came), a seeded 256,000-piece sentencepiece BPE in
# GemmaConverter's layout and GemmaTokenizer's tokenizer_config.json
# (left padding, the class's default). 5,000 of the configuration's
# 150,000 hackernews documents: phase 20's depth cut
BGE_GEMMA2_CONFIG = {
    "model_type": "gemma2", "architectures": ["Gemma2Model"], "vocab_size": 256_000,
    "hidden_size": 3584, "intermediate_size": 14_336, "num_hidden_layers": 2,
    "num_attention_heads": 16, "num_key_value_heads": 8, "head_dim": 256,
    "query_pre_attn_scalar": 256, "sliding_window": 4096, "attn_logit_softcapping": 50.0,
    "final_logit_softcapping": 30.0, "rope_theta": 10_000.0, "rms_norm_eps": 1e-6,
    "hidden_activation": "gelu_pytorch_tanh", "hidden_act": "gelu_pytorch_tanh",
    "max_position_embeddings": 8192, "attention_bias": False, "attention_dropout": 0.0,
    "initializer_range": 0.02, "tie_word_embeddings": True, "pad_token_id": 0,
    "eos_token_id": 1, "bos_token_id": 2}
BGE_GEMMA2_PUBLISHED_LAYERS = 42
P21_DOCS, P21_SEED = 5_000, 2037
P21_VARIANT_VOCAB = 32_000  # the variants' seeded pieces (256,000 published for Gemma)
P21_VARIANT_TRAIN_DOCS = 1_000  # documents the variants' trained merges learn from
# the decoder families beside it, 2 layers each at a published
# checkpoint's widths over a seeded 32,000-piece vocabulary, on phase 13's
# long texts and a left-padded batch: (a) gemma2 at gemma-2-2b's widths
# (Gemma2Config's defaults) with a 16-token window that bites and a
# softcap of 0.5 the reference ignores (fault 3.20); (b) gemma at
# gemma-2b's widths (one KV head of 256) with hidden_act `gelu` beside a
# hidden_activation nothing reads; (c) phi3 at Phi-3-mini-4k-instruct's
# widths (Phi3Config's defaults: fused qkv_proj and gate_up_proj, 32,064
# rows) as a Phi3ForCausalLM file, with a 16-token window, a quarter of
# each head passed through unrotated and a three-field longrope over
# 131,072 positions from 4,096 (seeded factor lists, `p21_longrope`)
P21_VARIANTS = {
    "(a) gemma2 at gemma-2-2b's widths, sliding_window 16, attn_logit_softcapping 0.5": {
        "model_type": "gemma2", "vocab_size": P21_VARIANT_VOCAB, "hidden_size": 2304,
        "intermediate_size": 9216, "num_hidden_layers": 2, "num_attention_heads": 8,
        "num_key_value_heads": 4, "head_dim": 256, "query_pre_attn_scalar": 256,
        "sliding_window": 16, "attn_logit_softcapping": 0.5, "final_logit_softcapping": 30.0,
        "rope_theta": 10_000.0, "rms_norm_eps": 1e-6, "hidden_activation": "gelu_pytorch_tanh",
        "max_position_embeddings": 8192, "pad_token_id": 0, "eos_token_id": 1,
        "bos_token_id": 2},
    "(b) gemma at gemma-2b's widths, one KV head, hidden_act gelu": {
        "model_type": "gemma", "vocab_size": P21_VARIANT_VOCAB, "hidden_size": 2048,
        "intermediate_size": 16_384, "num_hidden_layers": 2, "num_attention_heads": 8,
        "num_key_value_heads": 1, "head_dim": 256, "hidden_act": "gelu",
        "hidden_activation": "gelu_pytorch_tanh", "rope_theta": 10_000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 8192, "pad_token_id": 0, "eos_token_id": 1,
        "bos_token_id": 2},
    "(c) phi3 at Phi-3-mini-4k-instruct's widths, Phi3ForCausalLM, sliding_window 16,"
    " partial_rotary_factor 0.75, longrope": {
        "model_type": "phi3", "architectures": ["Phi3ForCausalLM"], "vocab_size": 32_064,
        "hidden_size": 3072, "intermediate_size": 8192, "num_hidden_layers": 2,
        "num_attention_heads": 32, "num_key_value_heads": 32, "hidden_act": "silu",
        "rms_norm_eps": 1e-5, "rope_theta": 10_000.0, "sliding_window": 16,
        "partial_rotary_factor": 0.75, "max_position_embeddings": 131_072,
        "original_max_position_embeddings": 4096, "rope_scaling": None,
        "pad_token_id": 32_000, "eos_token_id": 32_000, "bos_token_id": 1},
}
P21_TEXT = ["<start_of_turn>user hi<end_of_turn>", "x<table>y  z\ttab", "中文 café 😀 naïve"]
# phase 22 (after phase 21's encoders are let go), hn10k-longformerbase-hf:
# allenai/longformer-base-4096's published config.json (longformer: 12
# layers of 768, 12 heads, intermediate 3,072, a 512-token window on every
# layer, so each query reaches 256 tokens each way, 4,098 positions from
# pad id 1, one token type) with seeded random weights at its
# initializer_range 0.02 (its `*_global` projections among them, read and
# never used) and a seeded 50,265-entry byte-level BPE in RoBERTa's layout
# under LongformerTokenizerFast's tokenizer_config.json. 5,000 of the
# configuration's 150,000 hackernews documents, as every phase from 14 on
LONGFORMER_BASE_CONFIG = {
    "model_type": "longformer", "architectures": ["LongformerForMaskedLM"], "vocab_size": 50_265,
    "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "hidden_act": "gelu", "max_position_embeddings": 4098,
    "type_vocab_size": 1, "layer_norm_eps": 1e-5, "attention_window": [512] * 12,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2, "sep_token_id": 2,
    "initializer_range": 0.02}
P22_DOCS, P22_SEED = 5_000, 2038
# RoBERTa's other relatives beside it, 2 layers each at a published
# checkpoint's widths, on phase 13's long texts: (a) Longformer with
# windows [16, 32] (reaches of 8 and 16 tokens, which bite) over the
# path's BPE; (b) data2vec-text at facebook/data2vec-text-base's widths
# over the same BPE (RobertaTokenizer, the type's default class); (c)
# xlm-roberta-xl at facebook/xlm-roberta-xl's widths (2,560 wide, 32
# heads, intermediate 10,240, its pre-norms) over a seeded 32,000-piece
# Unigram in XLM-R's layout (the published 250,880 rows would be 2.57 GB of
# float32 for one check); (d) big_bird at google/bigbird-roberta-base's
# widths (block_sparse at block 64 and 3 random blocks: a threshold of 704
# tokens, so the reference runs full attention at 512) over a seeded
# 50,358-piece Unigram in BigBirdConverter's layout
P22_VARIANTS = {
    "(a) longformer with windows [16, 32]": {
        **LONGFORMER_BASE_CONFIG, "num_hidden_layers": 2, "attention_window": [16, 32]},
    "(b) data2vec-text at data2vec-text-base's widths": {
        "model_type": "data2vec-text", "vocab_size": 50_265, "hidden_size": 768,
        "num_hidden_layers": 2, "num_attention_heads": 12, "intermediate_size": 3072,
        "hidden_act": "gelu", "max_position_embeddings": 514, "type_vocab_size": 1,
        "layer_norm_eps": 1e-5, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2},
    "(c) xlm-roberta-xl at xlm-roberta-xl's widths": {
        "model_type": "xlm-roberta-xl", "vocab_size": 32_000, "hidden_size": 2560,
        "num_hidden_layers": 2, "num_attention_heads": 32, "intermediate_size": 10_240,
        "hidden_act": "gelu", "max_position_embeddings": 514, "type_vocab_size": 1,
        "layer_norm_eps": 1e-5, "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2},
    "(d) big_bird at bigbird-roberta-base's widths, block_sparse run full": {
        "model_type": "big_bird", "vocab_size": 50_358, "hidden_size": 768,
        "num_hidden_layers": 2, "num_attention_heads": 12, "intermediate_size": 3072,
        "hidden_act": "gelu_new", "max_position_embeddings": 4096, "type_vocab_size": 2,
        "layer_norm_eps": 1e-12, "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2,
        "sep_token_id": 66, "attention_type": "block_sparse", "block_size": 64,
        "num_random_blocks": 3, "rescale_embeddings": False, "use_bias": True},
}
P22_TEXT = ["[CLS] x [SEP] y [MASK] z", "x[MASK]y  [MASK]  z", "a <mask> b </s> c"]
# phase 23 (hn2k-bigbirdsparse-hf): google/bigbird-roberta-base's published
# config.json (12 layers of 768, 12 heads, intermediate 3,072, gelu_new,
# 4,096 positions, 2 token types, pad id 0) under its model card's
# block_size 16 and num_random_blocks 2, so any call whose longest text
# passes (5 + 2 x 2) x 16 = 144 tokens runs block-sparse; seeded weights at
# its initializer_range 0.02, written as pytorch_model.bin, beside phase
# 22's seeded 50,358-piece Unigram in BigBirdConverter's layout
BIGBIRD_SPARSE_CONFIG = {
    **P22_VARIANTS["(d) big_bird at bigbird-roberta-base's widths, block_sparse run full"],
    "architectures": ["BigBirdForPreTraining"], "num_hidden_layers": 12, "block_size": 16,
    "num_random_blocks": 2, "initializer_range": 0.02}
# 1,024 documents (2,000 until phase 25 came), each with a `text` field
# of a seeded run of 150-900 of the corpus's words (100 of them short,
# 2-12 words, so that one write mixes both lengths), rendered with
# documentTemplateMaxBytes 8,000 (the default 400 bytes stop near 100
# tokens) so that documents reach 150-512 tokens
P23_DOCS, P23_SHORT, P23_SEED, P23_MAX_BYTES = 1_024, 100, 2039, 8_000
P23_WORDS = (150, 900)
# phase 24 (hn5k-sgpt125m-hf): Muennighoff/SGPT-125M-weightedmean-nli-bitfit's
# config.json (gpt_neo, EleutherAI's gpt-neo-125M widths) at its full depth:
# 12 layers of 768, 12 heads, global and local layers alternating with a
# 256-token window, intermediate 4 x 768, gelu_new, 2,048 positions; seeded
# weights at its initializer_range 0.02 (biases at 0.02 too, so the checks
# see them), written as pytorch_model.bin, beside a seeded 50,257-entry
# byte-level BPE in GPT-2's layout (`<|endoftext|>` also the pad)
SGPT_125M_CONFIG = {
    "model_type": "gpt_neo", "architectures": ["GPTNeoModel"], "vocab_size": 50_257,
    "hidden_size": 768, "num_layers": 12, "num_heads": 12,
    "attention_types": [[["global", "local"], 6]], "intermediate_size": None,
    "window_size": 256, "max_position_embeddings": 2048, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5, "bos_token_id": 50_256, "eos_token_id": 50_256,
    "initializer_range": 0.02}
P24_DOCS, P24_SEED, P24_BIAS_STD = 5_000, 2040, 0.02
# the other SGPT types, 2 layers each at a published embedder's widths, card
# against CPU under both poolings on both padding sides: (a) gptj at
# Muennighoff/SGPT-5.8B-weightedmean-msmarco-specb-bitfit's (gpt-j-6b: 4,096
# wide, 16 heads of 256, a rotary over 64 of them, intermediate 16,384,
# vocabulary 50,400) over the path's GPT-2 BPE; (b) bloom at
# izhx/udever-bloom-560m's (bloom-560m: 1,024 wide, 16 heads, a 250,880-row
# embedding) over a seeded 32,000-piece BPE in BLOOM's layout (its Split
# pattern; 250,680 pieces published)
P24_VARIANTS = {
    "(a) gptj at SGPT-5.8B's widths": {
        "model_type": "gptj", "vocab_size": 50_400, "n_embd": 4096, "n_layer": 2, "n_head": 16,
        "rotary_dim": 64, "n_inner": None, "n_positions": 2048,
        "activation_function": "gelu_new", "layer_norm_epsilon": 1e-5},
    "(b) bloom at udever-bloom-560m's widths": {
        "model_type": "bloom", "vocab_size": 250_880, "hidden_size": 1024, "n_layer": 2,
        "n_head": 16, "layer_norm_epsilon": 1e-5,
        "apply_residual_connection_post_layernorm": False, "pretraining_tp": 1},
}
P24_BLOOM_PIECES, P24_BLOOM_TRAIN_DOCS = 32_000, 1_000
P24_TEXT = ["<|endoftext|> inside <|endoftext|>", "Hello, world! (a|b) x.y 你好。ok",
            "中文 café 😀 naïve — it's DON'T"]
# phase 25: GritLM/GritLM-8x7B's published config.json (MixtralForCausalLM at
# Mixtral-8x7B's widths: 4,096 wide, 32 heads over 8 KV heads, 8 experts of
# 14,336 a layer, top 2, rms_norm_eps 1e-5, rope_theta 1e6, no window,
# vocabulary 32,000), cut to 2 of its 32 layers; seeded weights at 0.02,
# drawn on the card and written as BF16 shards of at most 5 GB with
# model.safetensors.index.json (`model.` names, an untied `lm_head`), as
# the published files hold them, beside a seeded 32,000-piece Llama
# byte-fallback BPE padded on the left with `</s>` as its pad (GritLM's own
# tokenizer_config.json is not on this machine: Llama-2's layout)
GRITLM_8X7B_CONFIG = {
    "model_type": "mixtral", "architectures": ["MixtralForCausalLM"], "vocab_size": 32_000,
    "hidden_size": 4096, "intermediate_size": 14_336, "num_hidden_layers": 2,
    "num_attention_heads": 32, "num_key_value_heads": 8, "num_local_experts": 8,
    "num_experts_per_tok": 2, "hidden_act": "silu", "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "sliding_window": None, "max_position_embeddings": 32_768, "router_aux_loss_coef": 0.02,
    "output_router_logits": False, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "bos_token_id": 1, "eos_token_id": 2}
GRITLM_PUBLISHED_LAYERS = 32
P25_DOCS, P25_SEED, P25_BIAS_STD = 5_000, 2050, 0.02
P25_SHARD_BYTES = 5 * 10**9  # save_pretrained's default max_shard_size, "5GB"
P25_PIECES, P25_TRAIN_DOCS = 32_000, 1_000
# the routing rule of card against CPU: a token whose experts differ where
# the CPU's margin between its k-th and (k+1)-th routing weight is at least
# this fails the phase (a hundred times the rounding the card's gate
# product is expected to differ by); its text, where the margin is
# smaller, is printed and kept out of the ENC_TOL maximum
ROUTE_MARGIN = 1e-5
# texts a chunk of the CPU's reference encodes in phase 25's checks: each
# chunk pads to its own longest text, and every pad runs its experts, so
# the 83 check texts in one batch padded to the longest would cost the CPU
# several times their real tokens' work (a chunk cut from a call's one
# padded batch, forceCls over left padding, keeps that batch's length)
P25_CPU_CHUNK = 4
# the other MoE types, 2 layers each at a published model's widths, as BF16
# model.safetensors, card against CPU under both poolings on both padding
# sides over a seeded 32,000-piece BPE in Qwen2's layout (151,643 pieces
# published; the embeddings keep their 151,936 rows): (a) qwen2_moe at
# Qwen/Qwen1.5-MoE-A2.7B's (2,048 wide, 16 heads, 60 experts of 1,408, top
# 4 unnormalized, a shared expert of 5,632, biases on Q, K and V at 0.02);
# (b) qwen3_moe at Qwen/Qwen3-30B-A3B's (2,048 wide, 32 heads of 128 over 4
# KV heads, Q/K norms, 128 experts of 768, top 8 renormalized)
P25_VARIANTS = {
    "(a) qwen2_moe at Qwen1.5-MoE-A2.7B's widths": {
        "model_type": "qwen2_moe", "vocab_size": 151_936, "hidden_size": 2048,
        "intermediate_size": 5632, "num_hidden_layers": 2, "num_attention_heads": 16,
        "num_key_value_heads": 16, "num_experts": 60, "num_experts_per_tok": 4,
        "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
        "decoder_sparse_step": 1, "norm_topk_prob": False, "qkv_bias": True,
        "hidden_act": "silu", "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "max_position_embeddings": 8192, "use_sliding_window": False, "sliding_window": 32_768,
        "max_window_layers": 21, "torch_dtype": "bfloat16"},
    "(b) qwen3_moe at Qwen3-30B-A3B's widths": {
        "model_type": "qwen3_moe", "vocab_size": 151_936, "hidden_size": 2048,
        "intermediate_size": 6144, "num_hidden_layers": 2, "num_attention_heads": 32,
        "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8,
        "moe_intermediate_size": 768, "norm_topk_prob": True, "decoder_sparse_step": 1,
        "mlp_only_layers": [], "attention_bias": False, "hidden_act": "silu",
        "rms_norm_eps": 1e-6, "rope_theta": 1e6, "max_position_embeddings": 40_960,
        "use_sliding_window": False, "sliding_window": None, "max_window_layers": 48,
        "torch_dtype": "bfloat16"},
}
P25_TEXT = ["<s> inside </s> <unk>", "Hello, world! x.y 你好。ok \U0001F680",
            "  two  spaces\ttab"]
# phase 26 (hn5k-bmretriever410m-hf): BMRetriever/BMRetriever-410M's widths,
# EleutherAI/pythia-410m's config.json as recalled, not read from a file
# (gpt_neox: 24 layers of 1,024, 16 heads of 64 with 16 rotated channels at
# rotary_pct 0.25, intermediate 4,096, gelu, the parallel residual, biases
# on the fused QKV and dense, an untied 50,304-row embedding), at its full
# depth; seeded weights and biases at 0.02, written as GPTNeoXForCausalLM's
# pytorch_model.bin (`gpt_neox.` names, `embed_out`, and the stale causal
# buffers older Pythia files hold), beside a seeded 50,277-entry byte-level
# BPE in GPT-NeoX-20B's layout with `<|padding|>` as its pad (Pythia's
# files name none; BMRetriever's own tokenizer_config.json is not at hand)
BMRETRIEVER_410M_CONFIG = {
    "model_type": "gpt_neox", "architectures": ["GPTNeoXForCausalLM"], "vocab_size": 50_304,
    "hidden_size": 1024, "num_hidden_layers": 24, "num_attention_heads": 16,
    "intermediate_size": 4096, "rotary_pct": 0.25, "rotary_emb_base": 10_000,
    "max_position_embeddings": 2048, "use_parallel_residual": True, "layer_norm_eps": 1e-5,
    "hidden_act": "gelu", "attention_bias": True, "tie_word_embeddings": False,
    "bos_token_id": 0, "eos_token_id": 0, "initializer_range": 0.02}
P26_DOCS, P26_SEED, P26_BIAS_STD = 5_000, 2060, 0.02
P26_PIECES = 50_277  # GPT-NeoX-20B's tokenizer.json entries
# BMRetriever/BMRetriever-1B's widths (EleutherAI/pythia-1b's, as recalled:
# 2,048 wide, 8 heads of 256 with 64 rotated channels, intermediate 8,192)
# cut to 2 of its 16 layers, card against CPU under both poolings on both
# padding sides over the path's BPE
P26_VARIANT = ("BMRetriever-1B at 2 of 16 layers", {
    **BMRETRIEVER_410M_CONFIG, "hidden_size": 2048, "num_hidden_layers": 2,
    "num_attention_heads": 8, "intermediate_size": 8192})
P26_TEXT = ["<|endoftext|> inside <|padding|>", "wide      gaps and\ttabs  end",
            "Café é 中文 \U0001F680 naïve"]
# what Moses does to the encoder's texts: newlines and tabs dropped (two
# words become one), French quotes and non-breaking spaces, elisions,
# `No.` before a number, numbers with commas, multi-dots, a literal
# special token, and the first lowercasing's specials
P20_TEXT = ["hello\nworld\tagain", "« bonjour » l'homme aujourd'hui", "No. 5 costs 1,000.5 ...",
            "Say <special1> and </s> <S> <SPECIAL1>", "ÉLÈVE déjà ΣΑΣ Mr. Smith",
            "x\u00a0% nº\u00a01 5\u00a0000 « a\u00a0» : ;"]
P20_LONG_HEAD = ("hello\nworld\tagain « bonjour » l'homme aujourd'hui\u00a0: No. 5 costs"
                 " 1,000.5 ... <special1>")
# XLNet's specials and its quotes (two backquotes and two single quotes
# become `"`), accents stripped after NFKD, runs of spaces
P19_XLNET_TEXT = ["``quoted'' and ''again``", "Café naïve — déjà vu, ÉLÈVE",
                  "hello <mask> world <cls> <sep>", "x<mask>y  <mask>  z", "runs    of   spaces"]
P19_MOBILEBERT_TEXT = ["hello [MASK] world", "[CLS] x [SEP] y [PAD]", "HELLO World's"]
# ALBERT's quotes, accents (NFKD, then stripped), [MASK] with lstrip and
# full-width forms; ERNIE's CJK characters beside English and its specials
P18_ALBERT_TEXT = ["``quoted'' and ''again``", "Café naïve — déjà vu, ÉLÈVE",
                   "hello [MASK] world", "x[MASK]y  [MASK]  z", "Ａｂｃ ﬁne ½ Ωmega"]
P18_ERNIE_TEXT = ["机器学习的搜索引擎", "中文 相似度 search [MASK]", "一二三 四五 [UNK] 六",
                  "ＡＢＣ full-width ｄｅｆ 七八九"]
# Llama-3's specials, contractions under (?i:...), digit runs and newlines
P17_TEXT = ["x'Sy it'S we'LL don'T x'\u017fy", "<|begin_of_text|> inside <|eot_id|> <|python_tag|>",
            "<|start_header_id|>user<|end_header_id|> hi", "1 12 123 1234567 3.14159",
            "a\r\n\r\n  b  \n c"]
# characters the vocabulary lacks fall back to their UTF-8 bytes: emoji,
# CJK, accents, runs of unknown symbols; Gemma's specials and its
# non-special added tokens
P16_TEXT = ["\U0001F680\U0001F680\U0001F680 ✈✈ \U0001F44D\U0001F3FD", "é è ê ë ñ ß",
            "中文字搜索 東京", "⹃㋿Ᲊꟲ\U00010781",
            "<start_of_turn>user hello<end_of_turn>", "x<table>y <h1>z</h1>", "<bos>a<eos>b",
            "\u200b\ufeff\x00\x07 tab\there"]
# Qwen2's specials, contractions under (?i:...), digit runs and newlines
P15_TEXT = ["x'Sy it'S we'LL don'T x'\u017fy", "<|endoftext|> inside <|im_start|>user<|im_end|>",
            "<think>reason</think> answer", "1 12 123 1234567 3.14159", "a\r\n\r\n  b  \n c"]
# the left-padded batch: short texts (under forceCls their first row is a
# pad query that sees no key) beside long ones
LEFT_PAD_TEXT = ["rust", "", "machine learning database for the cloud", "x'Sy 1234567",
                 "straße über " * 12, " ".join(["search engine"] * 60)]
# phase 26's batch padded right and then left: GPT-2's and GPT-NeoX's specials
P26_SIDES_TEXT = (*LEFT_PAD_TEXT, *P24_TEXT, *P26_TEXT)
# each family's specials, written in and around words
P14_CAMEMBERT_TEXT = ["<s>NOTUSED </s>NOTUSED <unk>NOTUSED", "x<mask>y  <mask>  z",
                      "Bonjour, le monde ! Café naïve, élève"]
P14_ELECTRA_TEXT = ["hello [MASK] world", "[CLS] x [SEP] y [PAD]", "HELLO World's"]
P14_DEBERTA_TEXT = ["hello [MASK] world", "x[MASK]y  [MASK]  z", "[CLS] inside [SEP] [UNK]",
                    "UPPER lower MiXeD, punct...!? (x) 'q'"]
# the synthetic documents average about 31 tokens, under the 129-token
# window: the long check texts (seeded runs of the corpus's words) make it
# bite; each must tokenize to LONG_TOKENS or more, the last past 512
LONG_WORDS, LONG_TOKENS = (160, 240, 330, 900), 150
# MPNet's specials matched on the normalized text, BERT's left as words
MPNET_CHECK_TEXT = ["HELLO <MASK>world", "a<s>b", "x </S> y", "hello[UNK]world",
                    "hello [MASK] a"]
# phase 10: the workloads whose keyword searches the device half serves
# under forced routing (dsr.json's index holds a dynamic search rule, which
# it leaves to the host; network.json sends no search), and the one whose
# hybrid searches take the float leg
WORKLOADS_DEVICE_SERVED = ("api-keys.json", "movies.json", "task-queue-compaction.json",
                           "upgrade.json")
WORKLOADS_FLOAT_LEG = ("embeddings.json",)
P11_TEXT = ["rust compiler", "it's machine learning", "we'll secure the cloud", "python web"]
# the card-against-CPU texts: fault 3.11's characters, contractions, runs of
# whitespace, <mask> and the other specials, and multilingual text
P11_CHECK_TEXT = [
    "a\u2e43b and \u32ff \u1c89 \ua7f2 \U00010781", "it's we'll don't I'm they've you'd",
    "runs    of     spaces\tand\ttabs\nnew\r\nlines", "   leading and trailing   ", "",
    "<mask> and <s> inside </s> <pad> <unk>", "hello <mask> world", "x<mask>y  <mask>  z",
    "Café naïve résumé — déjà vu", "Привет, мир! Поиск", "中文字 搜索引擎", "東京の検索エンジン",
    "한국어 검색 엔진", "مرحبا بالعالم", "élève q\u0301\u0308 Ǆ ǅ ǆ İstanbul ΣΑΣ",
    "emoji \U0001F468\u200d\U0001F469\u200d\U0001F467 \U0001F44D\U0001F3FD \u2708",
    "ﬁne ½ ① Ａｂｃ ™ 2024 3.14 $5", "tab\there\x07bell\x01 zero\u200bwidth\ufeffbom",
    "straße über " * 8, "rust \U0001F680 machine learning \u2728 data",
    "Ελληνικά κείμενα", "हिन्दी खोज", "don't stop-me now (ok) <tag> a_b ~x",
    "HELLO World's 'quoted' \"double\"",
]
# the float round: a run of hits whose host scores lie within SCORE_TIE of
# each other is compared as a set (cuBLAS and numpy sum in other orders,
# which moves a float32 cosine by a few ulps); scores within SCORE_ATOL
SCORE_TIE, SCORE_ATOL = 1e-6, 1e-5
SETTINGS = {
    "searchableAttributes": ["title", "url", "author"],
    "filterableAttributes": ["author", "points", "num_comments"],
    "sortableAttributes": ["points", "created_at"],
}
QUERIES = [
    {"q": "rust"},  # one word
    {"q": "machine learning", "limit": 20},  # multi-word
    {"q": "open source database"},
    {"q": "deep neural network training"},
    {"q": "searhc engine"},  # typo
    {"q": "kubernets"},  # typo
    {"q": "performance benchark memory"},  # typo in a chain
    {"q": '"machine learning" model'},  # phrase
    {"q": "rust", "filter": "points > 1000"},  # filter
    {"q": "python web", "filter": "num_comments < 100", "limit": 30},
    {"q": "ai", "facets": ["author"]},  # facets
    {"q": "cloud", "facets": ["points"], "filter": "points > 2500"},
    {"q": "database", "sort": ["points:desc"]},  # sort
    {"q": "google", "sort": ["created_at:asc"], "limit": 15},
    {"q": "distributed systems", "matchingStrategy": "all"},
    {"q": "security privacy encryption", "matchingStrategy": "all"},
    {"q": "quantum research paper", "showRankingScore": True},
    {"q": "show tell", "showRankingScore": True, "offset": 5, "limit": 10},
]
COMPARED = ("estimatedTotalHits", "facetDistribution")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_phase() -> None:
    from meilisearch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    say(f"K1 + K3 + K4h + K6 build: {time.perf_counter() - t0:.3f} s"
        f" (nvcc {_build.build_seconds:.3f} s; 0 = already built)")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")


def kernel_phase(device) -> int:
    """K1 against chain_keys_torch on the card; returns the max abs error
    (0 when bit-exact; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops.chain_keys import chain_keys, chain_keys_torch
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs
    from meilisearch_tpu_torch.search.device_batch import T_LADDER

    worst = 0
    for D in (1 << 14, 1 << 20):
        for T in T_LADDER:
            args = kernel_args(scorer_inputs(T, D, 32, seed=1000 + T), device)
            got = chain_keys(*args, T=T)
            torch.cuda.synchronize()
            want = chain_keys_torch(*args, T=T)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            say(f"kernel D={D} B=32 T={T}: keys/candw/counts bit-exact={same}"
                f" max_abs_err={err} candidates={int(got[2].sum())}")
            if not same:
                raise AssertionError(f"K1 disagrees with chain_keys_torch at D={D} T={T}")
            worst = max(worst, err)
    return worst


def hamming_kernel_phase(device) -> int:
    """K4h's two modes against their plain versions on the card at
    n = 2^18 + 3 rows (not a multiple of a tile) of seeded words, bit 31
    set on half of them, for W = 1, 3, 4, 12, 24 and 48: the matrix
    16-byte aligned and, on a view one word in, not; the keyed mode at
    n_live = 1, n - 5 and n. Returns the max abs error (0 when equal,
    cosines and keys bit for bit; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops import hamming

    n, worst = (1 << 18) + 3, 0
    for W in HAM_WIDTHS:
        gen = torch.Generator().manual_seed(4000 + W)
        flat = torch.randint(-(1 << 31), 1 << 31, (n * W + 1,), generator=gen,
                             dtype=torch.int64).to(torch.int32).to(device)
        q = flat[-W:].clone()
        for mat in (flat[: n * W].view(n, W), flat[1:].view(n, W)):
            got = hamming.hamming_rows(mat, q)
            torch.cuda.synchronize()
            worst = max(worst, k4h_err(got, hamming.hamming_rows_torch(mat, q), f"ham W={W}"))
            for n_live in (1, n - 5, n):
                got = hamming.hamming_keyed(mat, q, 32 * W, n_live)
                torch.cuda.synchronize()
                want = hamming.hamming_keyed_torch(mat, q, 32 * W, n_live)
                worst = max(worst, k4h_err(got, want, f"keyed W={W} n_live={n_live}"))
    say(f"K4h n={n} W={','.join(map(str, HAM_WIDTHS))}, aligned and not: ham, and keyed at"
        f" n_live = 1, n - 5, n, bit for bit equal to the plain versions, max_abs_err={worst}")
    return worst


def k4h_err(got, want, what: str) -> float:
    """K4h's output, `ham` or the keyed mode's (cos, key), against its
    plain version's: raises unless every tensor is equal bit for bit;
    returns the max abs error (0)."""
    import torch

    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    bits = [(g.view(torch.int32), w.view(torch.int32)) if g.dtype == torch.float32 else (g, w)
            for g, w in pairs]
    if not all(torch.equal(g, w) for g, w in bits):
        raise AssertionError(f"K4h ({what}) disagrees with its plain version")
    return max(float((g.double() - w.double()).abs().max()) for g, w in pairs)


def osa_vocab(n: int, seed: int):
    """(mat (n, 32) int32, lens (n,) int32) numpy: seeded pseudo-words of
    lengths 0-32 over a small alphabet with a few non-ASCII codepoints
    (so matches and transpositions occur), zero rows past each length,
    and padding rows (length 0) at the end and at random."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.array([ord(c) for c in "abcdefghijklmn"] + [0xE9, 0xDF, 0x436, 0x1F600])
    weights = np.r_[np.full(14, 1.0), np.full(4, 0.25)]
    mat = alphabet[rng.choice(len(alphabet), size=(n, 32), p=weights / weights.sum())]
    lens = np.where(rng.random(n) < 0.8, rng.integers(3, 13, n), rng.integers(0, 33, n))
    lens[-4096:] = 0
    mat = np.where(np.arange(32)[None, :] < lens[:, None], mat, 0)
    return mat.astype(np.int32), lens.astype(np.int32)


def osa_queries(mat, lens, seed: int) -> list:
    """19 query words as codepoint lists: the empty word, a 32-letter
    word, 32 distinct codepoints up to U+1F600, 32 codepoints that share
    one slot under the query table's first multiplier (so the table must
    find another), and words taken from the vocabulary with 0-3 edits."""
    import numpy as np

    from meilisearch_tpu_torch.ops.device_osa import FIRST_MULT, SLOT_BITS

    def slot(c: int) -> int:
        return ((c * FIRST_MULT) & 0xFFFFFFFF) >> (32 - SLOT_BITS)

    rng = np.random.default_rng(seed)
    distinct = [ord(c) for c in "abcdefghijklmn"] + [0xE9, 0xDF, 0x436, 0x1F600]
    distinct += [0x41 + k for k in range(14)]
    collide = [c for c in range(0x61, 0x40000) if slot(c) == slot(0x61)][:32]
    out = [[], mat[int(np.flatnonzero(lens == 32)[0])].tolist(), distinct, collide]
    rows = rng.choice(np.flatnonzero(lens >= 4), size=15, replace=False)
    for k, r in enumerate(rows):
        w = mat[r, : lens[r]].tolist()
        for _ in range(k % 4):
            i = int(rng.integers(1, len(w)))
            if rng.random() < 0.5:
                w[i - 1], w[i] = w[i], w[i - 1]  # a transposition
            else:
                w[i] = int(mat[int(rng.integers(0, len(mat))), 0] or 0x61)
        out.append(w)
    return out


def osa_kernel_phase(device) -> int:
    """K3 against osa_device_torch on the card at n = 2^20 (the rows
    resident with their length order, as the typo path keeps them), and
    three queries against the host pass on 2^16 words; returns the max abs
    error (0 when byte-exact; anything else raises)."""
    import numpy as np
    import torch

    from meilisearch_tpu_torch.ops.device_osa import DeviceVocab, osa_device, osa_device_torch
    from meilisearch_tpu_torch.ops.levenshtein import osa_distances

    mat_np, lens_np = osa_vocab(1 << 20, seed=11)
    say(f"K3 edge-case vocabulary, 2^20 rows: {warp_lengths(lens_np)}")
    dv = DeviceVocab(mat_np, lens_np, device)
    mat, lens = dv.mat, dv.lens
    worst, checked = 0, 0
    for qi, word in enumerate(osa_queries(mat_np, lens_np, seed=12)):
        q = np.zeros(32, np.int32)
        q[: len(word)] = word
        qt = torch.from_numpy(q)  # the kernel takes the query on the host
        for max_dist in (1, 2):
            got = osa_device(mat, lens, qt, len(word), max_dist, dv.order)
            torch.cuda.synchronize()
            want = osa_device_torch(mat, lens, qt.to(device), len(word), max_dist)
            err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K3 disagrees with osa_device_torch: m={len(word)}")
            worst = max(worst, err)
            checked += 1
            if qi in (3, 4, 11):
                # the host pass on real (non-padding) rows of a 2^16 slice
                sl = slice(0, 1 << 16)
                real = lens_np[sl] > 0
                text = "".join(map(chr, word))
                full_h, prefix_h = osa_distances(text, mat_np[sl], lens_np[sl], max_dist)
                for g, h in zip(got, (full_h, prefix_h)):
                    if not np.array_equal(g[sl].cpu().numpy()[real], h[real]):
                        raise AssertionError(
                            f"K3 disagrees with the host pass: m={len(word)}"
                        )
                say(f"K3 m={len(word)} max_dist={max_dist}: equal to the host pass"
                    f" on {int(real.sum())} words of a 2^16 slice")
    say(f"K3 n=2^20: {checked} (query, max_dist) cases byte-exact against"
        f" osa_device_torch, max_abs_err={worst}")
    return worst


def _strip(res: dict) -> dict:
    hits = res["hits"]
    out = {
        "ids": [h["id"] for h in hits],
        "scores": [h.get("_rankingScore") for h in hits],
    }
    for key in COMPARED:
        out[key] = res.get(key)
    return out


def ingest(app, client, n_docs: int):
    """Index `n_docs` synthetic hackernews documents as "hn" over
    POST /indexes/hn/documents; returns the index's store."""
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.search.device_batch import _plane_docs

    client.update_settings("hn", SETTINGS)
    t0 = time.perf_counter()
    docs = generate_hackernews_like(n_docs)
    say(f"corpus: {n_docs} docs generated in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    uid = None
    for i in range(0, n_docs, 100_000):
        res = client.post("/indexes/hn/documents", body=docs[i : i + 100_000])
        if res.status != 202:
            raise AssertionError(f"ingest refused: {res.status} {res.json}")
        uid = res.json["taskUid"]
    del docs
    task = app.scheduler.wait_for_task(uid, timeout=900.0)
    ingest_s = time.perf_counter() - t0
    if task.to_json()["status"] != "succeeded":
        raise AssertionError(f"ingest failed: {task.to_json()}")
    store = app.scheduler.index("hn")
    say(f"ingest: {n_docs} docs over HTTP in {ingest_s:.3f} s"
        f" ({n_docs / ingest_s:.1f} docs/s), plane width D={_plane_docs(store)}")
    return store


def main_path_phase(device, n_docs: int) -> dict:
    """Boot the port's App, ingest, serve QUERIES from THREADS clients and
    hold every response against the host scorer."""
    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.ops.chain_keys import LAUNCHES
    from meilisearch_tpu_torch.search.device_batch import serving_stats, warm_kernels
    from meilisearch_tpu_torch.search.perform import perform_search, perform_search_many

    app = App(device=device)
    try:
        client = TestClient(app)
        store = ingest(app, client, n_docs)
        t0 = time.perf_counter()
        if not warm_kernels(store, app.device, wait=True):
            raise AssertionError("the bucket's kernels did not warm")
        say(f"warm: {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        expected = [_strip(perform_search(store, dict(q))) for q in QUERIES]
        say(f"host reference answers: {time.perf_counter() - t0:.3f} s")
        # one forced device drain registers every query's planes in the pool
        t0 = time.perf_counter()
        first = perform_search_many(
            store, [dict(q) for q in QUERIES], device=app.device, force_device=True
        )
        if [_strip(r) for r in first] != expected:
            raise AssertionError("the first device drain differs from the host scorer")
        say(f"first device drain (row registration): {time.perf_counter() - t0:.3f} s")

        serving_stats(reset=True)
        LAUNCHES.reset()
        answers, errors = serve(client, [("/indexes/hn/search", q) for q in QUERIES])
        launches = LAUNCHES.value
        stats = serving_stats()
        if errors:
            raise AssertionError(f"client threads failed: {errors[:3]}")
        say(f"serving stats: {json.dumps(stats)}")
        say(f"K1 launches during the main path: {launches}")

        bad = 0
        for qi, status, body in answers:
            if status != 200 or _strip(body) != expected[qi]:
                bad += 1
                if bad <= 3:
                    say(f"MISMATCH {QUERIES[qi]}: status {status}")
        say(f"responses equal to the host scorer: {len(answers) - bad}/{len(answers)}")
        if bad:
            raise AssertionError(f"{bad} responses differ from the host scorer")
        if launches <= 0:
            raise AssertionError("K1 was not launched on the main path")
        if stats["device_served"] <= 0 or stats["device_errors"] != 0:
            raise AssertionError(f"device path did not serve cleanly: {stats}")
        # the store and its host answers serve phase 8's executor path
        return {"launches": launches, "store": store, "expected": expected}
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


def typo_path_phase(device, n_words: int) -> dict:
    """A second App whose index vocabulary holds `n_words` distinct words:
    32 clients send typo queries; every response must equal the same
    store's answer with the host OSA pass, and K3 must have launched.
    Returns K3's launches, the store (its vocabulary stays resident on the
    device) and the words the typo pass put through K3."""
    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.ops import device_osa
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.search.perform import perform_search
    from meilisearch_tpu_torch.utils.synthetic import generate_large_vocab

    app = App(device=device)
    try:
        client = TestClient(app)
        client.update_settings("typo", {"searchableAttributes": ["title"]})
        t0 = time.perf_counter()
        _vocab, docs, queries = generate_large_vocab(n_words)
        say(f"typo corpus: {len(docs)} docs over a {n_words}-word vocabulary,"
            f" generated in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        res = client.post("/indexes/typo/documents", body=docs)
        if res.status != 202:
            raise AssertionError(f"ingest refused: {res.status} {res.json}")
        task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
        if task.to_json()["status"] != "succeeded":
            raise AssertionError(f"ingest failed: {task.to_json()}")
        del docs
        store = app.scheduler.index("typo")
        n_base = len(store.vocab_snapshot().base_words)
        say(f"typo ingest: {time.perf_counter() - t0:.3f} s over HTTP,"
            f" base vocabulary {n_base} words")
        if n_base < device_osa.MIN_DEVICE_VOCAB:
            raise AssertionError("the vocabulary is below the device OSA gate")

        # the answers with the host OSA pass, then cold derivation caches
        # so the served queries run the typo pass again, on the device
        t0 = time.perf_counter()
        store.device = None
        expected = [_strip(perform_search(store, dict(q))) for q in queries]
        store.device = app.device
        store._derivation_store_cache = None
        store._derivation_merge_cache = None
        say(f"host OSA pass answers: {time.perf_counter() - t0:.3f} s,"
            f" hits per query {[len(e['ids']) for e in expected]}")
        if not all(e["ids"] for e in expected):
            raise AssertionError("a typo query found nothing on the host pass")

        serving_stats(reset=True)
        device_osa.LAUNCHES.reset()
        answers, errors = serve(client, [("/indexes/typo/search", q) for q in queries])
        launches = device_osa.LAUNCHES.value
        stats = serving_stats()
        if errors:
            raise AssertionError(f"client threads failed: {errors[:3]}")
        bad = sum(
            1 for qi, status, body in answers
            if status != 200 or _strip(body) != expected[qi]
        )
        say(f"typo path: {len(answers) - bad}/{len(answers)} responses equal to"
            f" the host OSA pass; K3 launches {launches}; serving stats"
            f" {json.dumps(stats)}")
        if bad:
            raise AssertionError(f"{bad} typo responses differ from the host pass")
        if launches <= 0:
            raise AssertionError("K3 was not launched on the typo path")
        if stats["device_errors"] != 0:
            raise AssertionError(f"device errors on the typo path: {stats}")
        # every cold term with a typo budget ran the device pass once
        # (keys: word, max_typo, is_prefix, is_ngram)
        terms = store._derivation_store_cache["base_terms"]
        words = sorted({key[0] for key in terms if key[1] >= 1})
        return {"launches": launches, "store": store, "words": words}
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


def serve(client, requests: list, rounds: int = 2,
          per_client: int | None = None) -> tuple[list, list]:
    """THREADS clients each send every (path, body) POST request `rounds`
    times, in rotated orders (with `per_client`, only the first that many
    of each client's rotation a round); returns ([(request index, status,
    body)], [errors])."""
    per_client = len(requests) if per_client is None else per_client
    answers: list = []
    latencies: list = []
    errors: list = []
    lock = threading.Lock()

    def client_loop(k: int) -> None:
        try:
            for r in range(rounds):
                for j in range(per_client):
                    qi = (j + k + r) % len(requests)
                    path, body = requests[qi]
                    t = time.perf_counter()
                    res = client.post(path, body=dict(body))
                    dt = time.perf_counter() - t
                    with lock:
                        answers.append((qi, res.status, res.json))
                        latencies.append(dt)
        except BaseException as err:  # noqa: BLE001 — reported by the caller
            with lock:
                errors.append(repr(err))

    threads = [threading.Thread(target=client_loop, args=(k,)) for k in range(THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        errors.append("a client thread did not finish")
    lat = sorted(latencies) or [0.0]
    say(f"served {len(answers)} requests from {THREADS} threads in {wall:.3f} s:"
        f" {len(answers) / wall:.2f} QPS, p50 {lat[len(lat) // 2] * 1e3:.3f} ms,"
        f" p99 {lat[int(len(lat) * 0.99)] * 1e3:.3f} ms")
    return answers, errors


def vector_batch(docs: list, start: int, centres) -> list:
    """docs[start : start + VEC_BATCH] with their `_vectors`: seeded draws
    around the centres (noise 0.5 a dimension), two for every 7th
    document; built just before the batch is posted."""
    import numpy as np

    rng = np.random.default_rng([VEC_SEED, start])
    batch = docs[start : start + VEC_BATCH]
    counts = [2 if (start + i) % 7 == 0 else 1 for i in range(len(batch))]
    rows = centres[rng.integers(0, len(centres), sum(counts))]
    rows = rows + 0.5 * rng.standard_normal(rows.shape, dtype=np.float32)
    out, r = [], 0
    for doc, k in zip(batch, counts):
        vecs = rows[r : r + k].tolist()
        out.append({**doc, "_vectors": {"default": vecs if k == 2 else vecs[0]}})
        r += k
    return out


def vector_requests(store) -> list:
    """The vector path's 24 requests: for 5 stored vectors (plus noise),
    hybrid at semanticRatio 1.0 and, with a text q, 0.5, each with and
    without `filter` (the full-column leg), limit 20, offset 10 for every
    other one, showRankingScore; and 4 POST /similar, 2 filtered."""
    import numpy as np

    rng = np.random.default_rng(VEC_SEED + 1)
    ids = rng.choice(VEC_DOCS, 9, replace=False)
    per_doc = store.vectors["default"]
    out = []
    for r in range(5):
        base = per_doc[store.external_to_internal[str(ids[r])]][0]
        vec = (base + 0.05 * rng.standard_normal(VEC_DIM)).astype(np.float32).tolist()
        for ratio in (1.0, 0.5):
            for filt in (None, "points > 1000"):
                body = {"vector": vec, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                        "limit": 20, "offset": 10 * (r % 2), "showRankingScore": True}
                if ratio < 1.0:
                    body["q"] = VEC_TEXT[r]
                if filt:
                    body["filter"] = filt
                out.append(("/indexes/vec/search", body))
    for j, doc_id in enumerate(ids[5:]):
        body = {"id": int(doc_id), "embedder": "default", "limit": 20,
                "offset": 10 * (j % 2), "showRankingScore": True}
        if j >= 2:
            body["filter"] = "points > 1000"
        out.append(("/indexes/vec/similar", body))
    return out


def _vector_answer(body: dict) -> tuple:
    hits = body["hits"]
    return ([h["id"] for h in hits], [h["_rankingScore"] for h in hits],
            body.get("semanticHitCount"))


def _same_within_ties(got: tuple, want: tuple) -> bool:
    """The float round's rule: semanticHitCount equal, scores within
    SCORE_ATOL, ids in order except inside a run of hits whose host
    scores lie within SCORE_TIE of each other, compared as a set."""
    ids_g, sc_g, shc_g = got
    ids_w, sc_w, shc_w = want
    if shc_g != shc_w or len(ids_g) != len(ids_w):
        return False
    if any(abs(a - b) > SCORE_ATOL for a, b in zip(sc_g, sc_w)):
        return False
    start = 0
    for i in range(1, len(ids_w) + 1):
        if i == len(ids_w) or abs(sc_w[i] - sc_w[i - 1]) > SCORE_TIE:
            if set(ids_g[start:i]) != set(ids_w[start:i]):
                return False
            start = i
    return True


def _request_kind(path: str, body: dict) -> str:
    kind = "similar" if path.endswith("/similar") else f"ratio {body['hybrid']['semanticRatio']}"
    return kind + (" filtered" if "filter" in body else "")


def one_by_one(client, requests: list, label: str) -> list:
    """Each request once, one at a time; prints the median ms by kind and
    returns the answers (each must be 200 with hits)."""
    answers, by_kind = [], {}
    for path, body in requests:
        t = time.perf_counter()
        res = client.post(path, body=dict(body))
        by_kind.setdefault(_request_kind(path, body), []).append((time.perf_counter() - t) * 1e3)
        if res.status != 200 or not res.json["hits"]:
            raise AssertionError(f"{label}: {path} {res.status} {str(res.json)[:300]}")
        answers.append(_vector_answer(res.json))
    say(f"{label}, one request at a time, median ms by kind: "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in sorted(by_kind.items())))
    return answers


def vector_round(app, client, store, requests: list, exact: bool,
                 per_client: int | None = None) -> dict:
    """The expected answers from the same store with its device unbound
    (the numpy host pass), then the requests one at a time on the card
    (timed), then THREADS clients on the card (`per_client` requests each,
    by default all); every answer must agree (exactly, or by the float
    round's rule). Returns the K4h launches and float-leg calls of the
    served run."""
    from meilisearch_tpu_torch.ops import hamming
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.vector import store as vstore

    store.device = None
    expected = one_by_one(client, requests, "host pass")
    store.device = app.device
    say(f"host pass semanticHitCount {[e[2] for e in expected]}")
    one_by_one(client, requests, "on the card")

    serving_stats(reset=True)
    hamming.LAUNCHES.reset()
    vstore.FLOAT_LEGS.reset()
    # one round a client (two took 160-250 s of the run)
    answers, errors = serve(client, requests, rounds=1, per_client=per_client)
    launches, float_legs = hamming.LAUNCHES.value, vstore.FLOAT_LEGS.value
    stats = serving_stats()
    if errors:
        raise AssertionError(f"client threads failed: {errors[:3]}")
    bad = reordered = 0
    for qi, status, body in answers:
        if status != 200:
            bad += 1
            continue
        got = _vector_answer(body)
        same = got == expected[qi]
        if not same and not exact and _same_within_ties(got, expected[qi]):
            same, reordered = True, reordered + (got[0] != expected[qi][0])
        if not same:
            bad += 1
            if bad <= 3:
                path, req = requests[qi]
                say(f"MISMATCH {_request_kind(path, req)}: got {got}, want {expected[qi]}")
    kind = "binary (exact)" if exact else "float (ids within ties, scores 1e-5)"
    say(f"vector path, {kind}: {len(answers) - bad}/{len(answers)} responses agree with"
        f" the host pass ({reordered} with ids reordered within a tie group); K4h launches {launches},"
        f" float-leg calls {float_legs}; serving stats {json.dumps(stats)}")
    if bad:
        raise AssertionError(f"{bad} vector responses differ from the host pass")
    if stats["device_errors"] != 0:
        raise AssertionError(f"device errors on the vector path: {stats}")
    return {"launches": launches, "float_legs": float_legs}


def vector_path_phase(device) -> dict:
    """hn150k-bge768 through a third App: ingest over HTTP, upload, serve
    the float round, switch the embedder to binaryQuantized, serve the
    binary round. Returns K4h's launches and the two searchers (the
    float one keeps its resident matrix for the timing phase)."""
    import numpy as np

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.store import VectorSearcher

    app = App(device=device)
    try:
        client = TestClient(app)
        client.update_settings("vec", VEC_SETTINGS)
        t0 = time.perf_counter()
        docs = generate_hackernews_like(VEC_DOCS, seed=VEC_SEED)
        centres = np.random.default_rng(VEC_SEED).standard_normal(
            (VEC_CENTRES, VEC_DIM), dtype=np.float32
        )
        uid = None
        for start in range(0, VEC_DOCS, VEC_BATCH):
            res = client.post("/indexes/vec/documents", body=vector_batch(docs, start, centres))
            if res.status != 202:
                raise AssertionError(f"ingest refused: {res.status} {res.json}")
            uid = res.json["taskUid"]
        del docs
        task = app.scheduler.wait_for_task(uid, timeout=900.0)
        if task.to_json()["status"] != "succeeded":
            raise AssertionError(f"ingest failed: {task.to_json()}")
        store = app.scheduler.index("vec")
        rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        say(f"vector ingest: {VEC_DOCS} docs with {VEC_DIM}-dim vectors over HTTP in"
            f" {time.perf_counter() - t0:.3f} s (generation included); process peak RSS"
            f" {rss_gb:.3f} GiB")
        t0 = time.perf_counter()
        app.warm_devices()
        float_searcher = VectorSearcher(store, "default")
        m_dev, n = float_searcher._device[("matrix", app.device)]
        say(f"warm_devices (float matrix upload): {time.perf_counter() - t0:.3f} s;"
            f" {n} rows, {m_dev.shape[0]} on the card, {m_dev.numel() * 4 / 1e6:.1f} MB")
        if n != VEC_DOCS + (VEC_DOCS + 6) // 7:
            raise AssertionError(f"unexpected rows: {n}")
        requests = vector_requests(store)
        float_round = vector_round(app, client, store, requests, exact=False,
                                   per_client=VEC_SERVED_PER_CLIENT)
        if float_round["float_legs"] <= 0:
            raise AssertionError("the float leg did not run on the vector path")

        t0 = time.perf_counter()
        res = client.update_settings("vec", {"embedders": {"default": {"binaryQuantized": True}}})
        if res["status"] != "succeeded":
            raise AssertionError(f"the switch to binaryQuantized failed: {res}")
        say(f"PATCH settings binaryQuantized: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        app.warm_devices()
        binary_searcher = VectorSearcher(store, "default")
        if not binary_searcher.quantized:
            raise AssertionError("the embedder is not binary-quantized")
        say(f"warm_devices (sign words pack + upload): {time.perf_counter() - t0:.3f} s")
        binary_round = vector_round(app, client, store, requests, exact=True,
                                    per_client=VEC_SERVED_PER_CLIENT)
        if binary_round["launches"] <= 0:
            raise AssertionError("K4h was not launched on the vector path")
        query = np.asarray(requests[0][1]["vector"], np.float32)
        return {"launches": binary_round["launches"], "float": float_searcher,
                "binary": binary_searcher, "query": query / np.linalg.norm(query)}
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


def bge_vocab() -> list:
    """30,522 WordPiece entries laid out as bert-base-uncased's vocab.txt
    begins ([PAD], [unused0-98], [UNK], [CLS], [SEP], [MASK]), then the
    printable ASCII characters, the corpus's words and the template's
    field names, every character's ## piece, then filler."""
    from meilisearch_tpu_torch.utils.synthetic import WORDS

    chars = [chr(c) for c in range(33, 127)]
    words = WORDS + "title url author https example com user".split()
    vocab = ["[PAD]", *(f"[unused{i}]" for i in range(99)), "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = list(dict.fromkeys(vocab + chars + words + ["##" + c for c in chars]))
    n = BGE_CONFIG["vocab_size"]
    return vocab + [f"filler{i}" for i in range(n - len(vocab))]


def random_state_dict(config: dict, seed: int, bias_std: float = 0.0, dtype=None) -> dict:
    """BERT's initialization of a model of `config` (XLM-R's, DistilBERT's,
    MPNet's, ModernBERT's, the decoders' and Gemma 3's too): weights,
    MPNet's relative attention bias table among them, normal(0,
    BGE_INIT_STD) from a seeded torch.Generator, biases 0 (normal(0,
    bias_std) where given, so a check sees them), LayerNorm and RMSNorm
    scales 1 (Gemma's `1 + w` RMSNorm weights 0, as transformers starts
    them), RoFormer's position table its sinusoids (and DistilBERT's and
    XLM's where the config asks for them), MobileBERT's NoNorm scales 1
    and its pad row 0 (as transformers starts them). The module is built
    on the meta device for its names and shapes. The normal draws are made
    on the card where there is one (a seeded CUDA generator: a billion
    weights in well under a second, where the host's generator took most
    of a 5 GB checkpoint's write) and copied to the host, one tensor at a
    time, for the checkpoint's writer; in `dtype` where given (BF16 rounded
    on the card)."""
    import torch

    from meilisearch_tpu_torch.models import gemma3, mobilebert, roformer
    from meilisearch_tpu_torch.models.checkpoint import new_model
    from meilisearch_tpu_torch.models.decoder import RMSNorm

    with torch.device("meta"):
        model = new_model(config)
    norms = {f"{m}.{p}": 0.0 if isinstance(mod, gemma3.RMSNorm) or p != "weight" else 1.0
             for m, mod in model.named_modules()
             if isinstance(mod, (torch.nn.LayerNorm, RMSNorm, gemma3.RMSNorm, mobilebert.NoNorm))
             for p, _ in mod.named_parameters()}
    # embedding rows transformers starts at 0 (`padding_idx`: MobileBERT's pad)
    zero_rows = {f"{m}.weight": mod.padding_idx for m, mod in model.named_modules()
                 if isinstance(mod, torch.nn.Embedding) and mod.padding_idx is not None}
    sinusoidal = config.get("sinusoidal_pos_embds") or config.get("sinusoidal_embeddings")
    on = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    g = torch.Generator(on).manual_seed(seed)

    dtype = dtype or torch.float32

    def normal(shape, std):
        return (torch.randn(shape, generator=g, device=on) * std).to(dtype).cpu()

    state = {}
    for name, p in model.named_parameters():
        if name in norms:
            state[name] = torch.full(p.shape, norms[name], dtype=dtype)
        elif name == roformer.POSITIONS:
            state[name] = roformer.sinusoidal_table(*p.shape).clone()
        elif sinusoidal and name.endswith("position_embeddings.weight"):
            state[name] = sinusoidal_positions(*p.shape)
        elif name.endswith("bias"):
            state[name] = normal(p.shape, bias_std) if bias_std else torch.zeros(p.shape,
                                                                                  dtype=dtype)
        else:
            state[name] = normal(p.shape, BGE_INIT_STD)
        if name in zero_rows:
            state[name][zero_rows[name]] = 0.0
    return state


def sinusoidal_positions(n_pos: int, dim: int):
    """DistilBERT's and XLM's sinusoidal position table as transformers
    fills it (`create_sinusoidal_embeddings`: float64 angles, sin on the
    even columns, cos on the odd ones, then float32)."""
    import numpy as np
    import torch

    pos = np.arange(n_pos)[:, None] / np.power(10000, 2 * (np.arange(dim) // 2) / dim)[None, :]
    out = torch.empty(n_pos, dim)
    out[:, 0::2] = torch.FloatTensor(np.sin(pos[:, 0::2]))
    out[:, 1::2] = torch.FloatTensor(np.cos(pos[:, 1::2]))
    return out


def write_bge_checkpoint(path: str) -> None:
    """A checkpoint of bge-base's width, written as pytorch_model.bin with
    its vocab."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, BGE_CONFIG, random_state_dict(BGE_CONFIG, ENC_SEED), bge_vocab(),
                     do_lower_case=True)


@lru_cache(maxsize=1)
def e5_charsmap() -> bytes:
    """sentencepiece's nmt_nfkc map as far as the stdlib knows it: every
    code point that NFKC changes, the NMT rules' control characters
    (dropped) and odd spaces (a space), and two-character clusters that
    compose."""
    import unicodedata

    from meilisearch_tpu_torch.models.fixtures import build_charsmap

    mapping = {}
    for cp in range(1, 0x110000):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        norm = unicodedata.normalize("NFKC", ch)
        if norm != ch:
            mapping[ch] = norm
    for cp in [*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F, 0x8F, 0x9F]:
        mapping[chr(cp)] = ""
    for cp in [0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029, 0xFEFF]:
        mapping[chr(cp)] = " "
    for base in "aeiouAEIOU":
        for mark in "\u0300\u0301\u0308":
            mapping[base + mark] = unicodedata.normalize("NFC", base + mark)
    return build_charsmap(mapping)


def e5_pieces(n: int = E5_CONFIG["vocab_size"] - 5, seed: int = E5_SEED) -> list:
    """n (piece, score) entries (249,997: XLM-R's vocabulary less its five
    specials): every character of the scripts the check texts use, alone
    and after U+2581, the corpus's words and their halves, then seeded
    pieces of 2 to 6 characters of the same alphabet to n; scores seeded
    (words above characters above the rest)."""
    import numpy as np

    from meilisearch_tpu_torch.utils.synthetic import WORDS

    rng = np.random.default_rng(seed)
    alphabet = [chr(c) for c in [*range(33, 127), *range(0xC0, 0x180), *range(0x391, 0x3CA),
                                 *range(0x410, 0x450), *range(0x621, 0x64B), *range(0x905, 0x940),
                                 *range(0x10D0, 0x10F1), *range(0x3041, 0x3097),
                                 *range(0x30A1, 0x30FB), *range(0x4E00, 0x5A00),
                                 *range(0xAC00, 0xB000)]]
    words = WORDS + "title url author https example com user".split()
    scores = {}
    for w in words:
        for piece in ("▁" + w, w[: len(w) // 2], w[len(w) // 2:]):
            scores.setdefault(piece, float(rng.uniform(-8.0, -4.0)))
    for ch in alphabet:
        scores.setdefault("▁" + ch, float(rng.uniform(-12.0, -9.0)))
        scores.setdefault(ch, float(rng.uniform(-12.0, -9.0)))
    scores.setdefault("▁", -3.0)
    chars = alphabet[:94 + 192]  # ASCII and Latin letters
    while len(scores) < n:
        idx = rng.integers(0, len(chars), (1 << 16, 6)).tolist()
        lens = rng.integers(2, 7, 1 << 16).tolist()
        spaced = (rng.random(1 << 16) < 0.5).tolist()
        draws = rng.uniform(-16.0, -10.0, 1 << 16).tolist()
        for row, k, sp, score in zip(idx, lens, spaced, draws):
            piece = ("▁" if sp else "") + "".join([chars[i] for i in row[:k]])
            scores.setdefault(piece, score)
    return list(scores.items())[:n]


def write_e5_checkpoint(path: str) -> None:
    """A checkpoint of multilingual-e5-base's width (XLM-R), written as
    pytorch_model.bin with its 250,002-piece Unigram tokenizer.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import xlmr_tokenizer_json

    write_checkpoint(path, E5_CONFIG, random_state_dict(E5_CONFIG, E5_SEED),
                     tokenizer_json=xlmr_tokenizer_json(e5_pieces(), e5_charsmap()))


@lru_cache(maxsize=2)
def cpu_encoder(path: str):
    """The checkpoint's encoder on the CPU, loaded once for a phase's checks;
    kept out of `hf_encoder.encoder`'s cache, which the card's encoders and
    the App share."""
    from meilisearch_tpu_torch.models.hf_encoder import TextEncoder

    return TextEncoder(path, "useModel", device=None)


def encoder_check(path: str, device, texts: list, width: str = "bge-base") -> float:
    """The checkpoint's normalized embeddings of `texts` on the card against
    the CPU (each device's encoder a cached one, so a phase's checks load
    the checkpoint once a device); returns the max abs error (fails above
    ENC_TOL)."""
    import numpy as np

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    t0 = time.perf_counter()
    got = encoder(path, "useModel", device).encode(texts)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = cpu_encoder(path).encode(texts)
    t_cpu = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    say(f"encoder check: {len(texts)} texts at {width} width, card against CPU: max abs"
        f" error {err:.3e} (bound {ENC_TOL:g}); card {t_card:.3f} s (load included),"
        f" CPU {t_cpu:.3f} s (load included)")
    if not err <= ENC_TOL:
        raise AssertionError(f"the encoder on the card is {err:.3e} off the CPU")
    return err


def encoder_requests(index: str = "enc", queries: tuple = tuple(ENC_TEXT)) -> list:
    """An encoder path's 8 hybrid requests: 4 text queries at semanticRatio
    1.0 and 0.5, the last two filtered; limit 20, offset 10 for every other
    one, showRankingScore."""
    out = []
    for r, q in enumerate(queries):
        for ratio in (1.0, 0.5):
            body = {"q": q, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                    "limit": 20, "offset": 10 * (r % 2), "showRankingScore": True}
            if r >= 2:
                body["filter"] = "points > 1000"
            out.append((f"/indexes/{index}/search", body))
    return out


def encoder_path_phase(device, card: str, n_docs: int) -> dict:
    """hn150k-bgebase-hf through a fourth App: (a) a bge-base-width
    checkpoint; (b) the encoder on the card against the CPU; (c) n_docs
    documents embedded at indexing on the card; (d) hybrid searches with a
    text q against the same store's host pass; (e) the first request
    after a write, with the scheduler's warm and without it; (f) the
    forward's timing."""
    import tempfile

    import numpy as np
    import torch

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.models import hf_encoder
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector import embedders
    from meilisearch_tpu_torch.vector import store as vstore
    from meilisearch_tpu_torch.vector.templates import render_document_template

    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        write_bge_checkpoint(path)
        say(f"bge-base-width checkpoint (seeded random weights) written in"
            f" {time.perf_counter() - t0:.3f} s")
        docs = generate_hackernews_like(n_docs + ENC_WRITE, seed=ENC_SEED)
        searchable = set(VEC_SETTINGS["searchableAttributes"])
        texts = [render_document_template(None, d, searchable) for d in docs[:64]]
        err = encoder_check(path, device, texts + [q for q in ENC_TEXT] + VEC_TEXT * 2
                            + [d["title"] for d in docs[64:66]])

        app = App(device=device)
        try:
            client = TestClient(app)
            settings = {**VEC_SETTINGS, "embedders": {"default": {
                "source": "huggingFace", "model": path}}}
            client.update_settings("enc", settings)
            enc = hf_encoder.encoder(path, "useModel", device)
            texts0, tokens0, seconds0 = enc.texts, enc.tokens, enc.seconds
            hf_encoder.FORWARDS.reset()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = client.post("/indexes/enc/documents", body=docs[:n_docs])
            if res.status != 202:
                raise AssertionError(f"ingest refused: {res.status} {res.json}")
            task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
            if task.to_json()["status"] != "succeeded":
                raise AssertionError(f"ingest failed: {task.to_json()}")
            ingest_s = time.perf_counter() - t0
            forwards = hf_encoder.FORWARDS.value
            n_texts, tokens = enc.texts - texts0, enc.tokens - tokens0
            embed_s = enc.seconds - seconds0
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            store = app.scheduler.index("enc")
            say(f"encoder ingest: {n_docs} docs over HTTP in {ingest_s:.3f} s; embedded on the"
                f" card at indexing: {n_texts} texts, {tokens} tokens ({tokens / max(n_texts, 1):.1f}"
                f" a text) in {embed_s:.3f} s ({tokens / embed_s:.1f} tokens/s), {forwards}"
                f" forwards of up to {enc.chunk_texts()} texts; peak device memory {peak:.3f} GiB")
            if n_texts != n_docs or forwards <= 0 or len(store.vectors["default"]) != n_docs:
                raise AssertionError("the documents were not all embedded on the card")
            if next(enc._model.parameters()).device != device:
                raise AssertionError("the encoder is not on the card")
            if not app.scheduler.wait_device_warm(timeout=600.0):
                raise AssertionError("the device warm after the ingest did not end")

            # (d) the query vectors embedded on the card, then both passes
            # read them from the embed cache
            requests = encoder_requests()
            hf_encoder.FORWARDS.reset()
            embedder = embedders.get_embedder(store, "default")
            for q in ENC_TEXT:
                embedder.embed_search(q)
            if hf_encoder.FORWARDS.value != len(ENC_TEXT):
                raise AssertionError("the queries were not embedded on the card")
            serving = vector_round(app, client, store, requests, exact=False)
            if serving["float_legs"] <= 0:
                raise AssertionError("the float leg did not run on the encoder path")

            # (e) fault 3.5: a write, then the first request of the new
            # generation with the scheduler's warm, and with it dropped
            body = dict(requests[0][1])
            texts1 = enc.texts
            t0 = time.perf_counter()
            res = client.post("/indexes/enc/documents", body=docs[n_docs:])
            task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
            if task.to_json()["status"] != "succeeded":
                raise AssertionError(f"the write failed: {task.to_json()}")
            write_s = time.perf_counter() - t0
            if not app.scheduler.wait_device_warm(timeout=600.0):
                raise AssertionError("the device warm after the write did not end")
            warm_s = time.perf_counter() - t0 - write_s
            searcher = vstore.VectorSearcher(store, "default")
            if searcher._device.get(("matrix", device)) is None:
                raise AssertionError("the new generation's matrix is not resident after the write")

            def timed():
                t = time.perf_counter()
                res = client.post("/indexes/enc/search", body=dict(body))
                return (time.perf_counter() - t) * 1e3, res

            t_first, first = timed()  # the new generation's host caches are cold
            t_again, again = timed()
            # as the parent's scheduler left a write: no matrix for the new
            # generation, so the request builds it and uploads it
            store._vector_searcher_cache.pop("default")
            t_upload, upload = timed()
            if any(r.status != 200 or r.json["hits"] != first.json["hits"]
                   for r in (first, again, upload)):
                raise AssertionError("the requests after the write failed or differ")
            say(f"fault 3.5: a write of {ENC_WRITE} docs took {write_s:.3f} s ({enc.texts - texts1}"
                f" texts embedded: every engine-embedded document again), the scheduler's device"
                f" warm {warm_s:.3f} s after it; the same hybrid request (ratio 1.0, q cached)"
                f" after it: first {t_first:.3f} ms (matrix resident, host caches cold), again"
                f" {t_again:.3f} ms, then with the generation's matrix dropped (built and"
                f" uploaded on the request's path, as before the warm) {t_upload:.3f} ms")
            stats = serving_stats()
            if stats["device_errors"] != 0:
                raise AssertionError(f"device errors on the encoder path: {stats}")
            timing = encoder_timing(enc, device, card)
        finally:
            app.search_batcher.stop()
            app.scheduler.stop()
    return {"err": err, "forwards": forwards, **timing}


def hf_path(device, card: str, n_docs: int, *, label: str, index: str, write, seed: int,
            queries: list, check_texts: list, tokenizer: str, model_type: str,
            checks: tuple = (), docs: list | None = None, settings: dict | None = None,
            embedder: dict | None = None, check=encoder_check) -> dict:
    """One checkpoint through its own App: (a) `write(path)` writes it; (b)
    the encoder on the card against the CPU on 80 texts (`check`; and each of
    `checks(path, device, label)`, its error); (c) n_docs
    documents (`docs`, else seeded hackernews ones) embedded at indexing on
    the card, through the tokenizer class and model type named, the index's
    settings VEC_SETTINGS with `settings` over them and the embedder's keys
    `embedder`; (d) hybrid searches with a text q (the `queries`) against
    the same store's host pass; (e) the forward's timing. Returns the
    check's error, the forwards (those that ran block-sparse among them)
    and the timings."""
    import tempfile

    import torch

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.models import big_bird, hf_encoder
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector import embedders
    from meilisearch_tpu_torch.vector.templates import render_document_template

    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as path:
        t0 = time.perf_counter()
        write(path)
        say(f"{label} checkpoint (seeded random weights) written in"
            f" {time.perf_counter() - t0:.3f} s")
        if docs is None:
            docs = generate_hackernews_like(n_docs, seed=seed)
        searchable = set(VEC_SETTINGS["searchableAttributes"])
        texts = [render_document_template(None, d, searchable) for d in docs[:48]]
        texts += list(queries) * 2 + check_texts
        err = check(path, device, texts, label)
        for more in checks:
            err = max(err, more(path, device, label))

        serving_stats(reset=True)
        app = App(device=device)
        try:
            client = TestClient(app)
            client.update_settings(index, {**VEC_SETTINGS, **(settings or {}), "embedders": {
                "default": {"source": "huggingFace", "model": path, **(embedder or {})}}})
            enc = hf_encoder.encoder(path, "useModel", device)
            enc._load()
            chosen = (type(enc._tokenizer).__name__, enc._model.config["model_type"])
            if chosen != (tokenizer, model_type):
                raise AssertionError(f"{label}: the encoder chose {chosen}, not"
                                     f" {(tokenizer, model_type)}")
            before = (enc.texts, enc.tokens, enc.seconds, enc.tokenize_seconds)
            hf_encoder.FORWARDS.reset()
            big_bird.FORWARDS.reset()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = client.post(f"/indexes/{index}/documents", body=docs)
            if res.status != 202:
                raise AssertionError(f"ingest refused: {res.status} {res.json}")
            task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=900.0)
            if task.to_json()["status"] != "succeeded":
                raise AssertionError(f"ingest failed: {task.to_json()}")
            ingest_s = time.perf_counter() - t0
            forwards, sparse = hf_encoder.FORWARDS.value, big_bird.FORWARDS.value
            n_texts, tokens = enc.texts - before[0], enc.tokens - before[1]
            embed_s, tok_s = enc.seconds - before[2], enc.tokenize_seconds - before[3]
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            store = app.scheduler.index(index)
            say(f"{label} ingest on {card} ({tokenizer}, {model_type}): {n_docs} docs over HTTP"
                f" in {ingest_s:.3f} s; embedded on the card at indexing: {n_texts} texts,"
                f" {tokens} tokens ({tokens / max(n_texts, 1):.1f} a text) in {embed_s:.3f} s"
                f" ({tokens / embed_s:.1f} tokens/s), of which host tokenization ({tokenizer})"
                f" {tok_s:.3f} s ({100 * tok_s / embed_s:.1f}%) and the rest"
                f" {embed_s - tok_s:.3f} s; {forwards} forwards of up"
                f" to {enc.chunk_texts()} texts ({sparse} of them block-sparse); peak device"
                f" memory {peak:.3f} GiB")
            if n_texts != n_docs or forwards <= 0 or len(store.vectors["default"]) != n_docs:
                raise AssertionError("the documents were not all embedded on the card")
            if next(enc._model.parameters()).device != device:
                raise AssertionError("the encoder is not on the card")
            if not app.scheduler.wait_device_warm(timeout=600.0):
                raise AssertionError("the device warm after the ingest did not end")

            requests = encoder_requests(index, tuple(queries))
            hf_encoder.FORWARDS.reset()
            embedder = embedders.get_embedder(store, "default")
            for q in queries:
                embedder.embed_search(q)
            if hf_encoder.FORWARDS.value != len(queries):
                raise AssertionError("the queries were not embedded on the card")
            serving = vector_round(app, client, store, requests, exact=False)
            if serving["float_legs"] <= 0:
                raise AssertionError(f"the float leg did not run on the {label} path")
            stats = serving_stats()
            if stats["device_errors"] != 0:
                raise AssertionError(f"device errors on the {label} path: {stats}")
            timing = encoder_timing(enc, device, card, label)
        finally:
            app.search_batcher.stop()
            app.scheduler.stop()
    return {"err": err, "forwards": forwards, "sparse_forwards": sparse,
            "tokens_s": tokens / embed_s, "tokenize_s": tok_s, **timing}


def xlmr_path_phase(device, card: str, n_docs: int) -> dict:
    """hn50k-me5base-hf through a fifth App: a checkpoint of
    multilingual-e5-base's width and its Unigram tokenizer.json, the
    encoder on the card against the CPU on 80 texts, n_docs documents
    embedded at indexing on the card, hybrid searches against the same
    store's host pass, the forward's timing (`hf_path`)."""
    t_phase = time.perf_counter()
    out = hf_path(device, card, n_docs, label="multilingual-e5-base", index="e5",
                  write=write_e5_checkpoint, seed=E5_SEED, queries=E5_TEXT,
                  check_texts=E5_CHECK_TEXT, tokenizer="Unigram", model_type="xlm-roberta")
    say(f"phase 9 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def write_distilroberta_checkpoint(path: str) -> None:
    """A checkpoint of all-distilroberta-v1's width (RoBERTa, 6 layers),
    written as pytorch_model.bin with a 50,265-token byte-level BPE
    tokenizer.json trained on the phase's own texts."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import roberta_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P11_SEED)]
    spec = roberta_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT,
                                  DISTILROBERTA_CONFIG["vocab_size"], seed=P11_SEED)
    write_checkpoint(path, DISTILROBERTA_CONFIG, random_state_dict(DISTILROBERTA_CONFIG, P11_SEED),
                     tokenizer_json=spec)


def write_distilbert_checkpoint(path: str) -> None:
    """A checkpoint of multi-qa-distilbert-cos-v1's width (DistilBERT, 6
    layers, DistilBERT's weight names), written as pytorch_model.bin with
    bge_vocab()'s WordPiece vocab.txt (uncased)."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, DISTILBERT_CONFIG, random_state_dict(DISTILBERT_CONFIG, P11_SEED),
                     bge_vocab(), do_lower_case=True)


def bpe_distilbert_phase(device, card: str, n_docs: int) -> dict:
    """Phase 11, the BPE and DistilBERT path: hn25k-distilroberta-hf and
    hn25k-mqadistilbert-hf, each through its own App (`hf_path`)."""
    t_phase = time.perf_counter()
    out = {}
    for label, index, write, tokenizer, model_type in (
            ("all-distilroberta-v1", "rb", write_distilroberta_checkpoint, "BPE", "roberta"),
            ("multi-qa-distilbert-cos-v1", "db", write_distilbert_checkpoint, "WordPiece",
             "distilbert")):
        out[label] = hf_path(device, card, n_docs, label=label, index=index, write=write,
                             seed=P11_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT,
                             tokenizer=tokenizer, model_type=model_type)
    say(f"phase 11 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def workloads_phase(device) -> None:
    """Phase 10: the declarative workloads (workloads/tests/*.json) through
    the port's xtask runner, every instance's App bound to the card and
    device routing forced; the named workloads must reach the device."""
    import glob
    import os

    from meilisearch_tpu_torch import xtask
    from meilisearch_tpu_torch.ops import chain_keys, device_osa
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.vector import store as vstore

    root = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(root, "workloads", "tests", "*.json")))
    if len(paths) != 7:
        raise AssertionError(f"expected 7 workloads, found {len(paths)}")
    serving_stats(reset=True)
    t0 = time.perf_counter()
    with xtask.device_routing_forced():
        for path in paths:
            name = os.path.basename(path)
            before = serving_stats()
            counts = (chain_keys.LAUNCHES.value, device_osa.LAUNCHES.value,
                      vstore.FLOAT_LEGS.value)
            t = time.perf_counter()
            xtask.run_workload(path, verbose=False, device=device)
            after = serving_stats()
            served = after["device_served"] - before["device_served"]
            k1, k3, legs = (c.value - v for c, v in zip(
                (chain_keys.LAUNCHES, device_osa.LAUNCHES, vstore.FLOAT_LEGS), counts))
            say(f"workload {name} passed on the card with device routing forced in"
                f" {time.perf_counter() - t:.3f} s: {served} searches answered by the device;"
                f" {k1} K1 launches, {k3} K3 launches, {legs} float-leg calls")
            if name in WORKLOADS_DEVICE_SERVED and served <= 0:
                raise AssertionError(f"{name}: no search was answered by the device")
            if name in WORKLOADS_FLOAT_LEG and legs <= 0:
                raise AssertionError(f"{name}: the float leg did not run")
    stats = serving_stats()
    if stats["device_errors"] != 0 or stats["device_served"] <= 0:
        raise AssertionError(f"the workloads did not reach the device cleanly: {stats}")
    say(f"phase 10: {len(paths)} workloads passed with the App bound to the card and device"
        f" routing forced in {time.perf_counter() - t0:.3f} s; device_served"
        f" {stats['device_served']}, device_errors {stats['device_errors']}; serving stats"
        f" {json.dumps(stats)}")


def write_mpnet_checkpoint(path: str) -> None:
    """A checkpoint of all-mpnet-base-v2's width (MPNet, 12 layers, MPNet's
    weight names), written as pytorch_model.bin with MPNet's vocab.txt
    (bge_vocab() between `<s> <pad> </s> <unk>` and `<mask>`) and
    MPNetTokenizerFast's tokenizer_config.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import mpnet_vocab

    vocab = mpnet_vocab(bge_vocab())
    if len(vocab) != MPNET_CONFIG["vocab_size"]:
        raise AssertionError(f"MPNet's vocabulary has {len(vocab)} tokens")
    write_checkpoint(path, MPNET_CONFIG, random_state_dict(MPNET_CONFIG, P12_SEED), vocab,
                     do_lower_case=True)


def mpnet_phase(device, card: str, n_docs: int) -> dict:
    """Phase 12, the MPNet path: hn25k-mpnet-hf through its own App
    (`hf_path`)."""
    t_phase = time.perf_counter()
    out = hf_path(device, card, n_docs, label="all-mpnet-base-v2", index="mp",
                  write=write_mpnet_checkpoint, seed=P12_SEED, queries=P11_TEXT,
                  check_texts=P11_CHECK_TEXT + MPNET_CHECK_TEXT, tokenizer="WordPiece",
                  model_type="mpnet")
    say(f"phase 12 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def long_check(path: str, device, label: str, *, texts: tuple) -> float:
    """`texts` in one batch, card against CPU (`encoder_check`), after
    checking their lengths: all but the short ones at LONG_TOKENS or more,
    the longest cut at the encoder's max_len."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    counts = [len(enc._tokenizer.ids(t)) + len(enc._tokenizer.before) + len(enc._tokenizer.after)
              for t in texts]
    long = [n for n in counts if n >= LONG_TOKENS]
    say(f"{label} long check texts: {counts} tokens before truncation at {enc.max_len}")
    if len(long) < 3 or max(long) <= enc.max_len or min(counts) > 16:
        raise AssertionError(f"the long check texts are not long enough: {counts}")
    return encoder_check(path, device, list(texts), f"{label} (long texts, one batch)")


def long_check_texts(seed: int) -> tuple:
    """Two short texts and seeded runs of LONG_WORDS of the corpus's words."""
    import numpy as np

    from meilisearch_tpu_torch.utils.synthetic import WORDS

    rng = np.random.default_rng(seed)
    runs = [" ".join(rng.choice(WORDS, size=n)) for n in LONG_WORDS]
    return ("rust", runs[0], "", *runs[1:])


def write_modernbert_checkpoint(path: str) -> None:
    """A checkpoint of ModernBERT-base's width (22 layers, ModernBertModel's
    names), written as model.safetensors with a 50,368-entry byte-level BPE
    tokenizer.json in ModernBERT's layout, its merges trained on the
    phase's own texts, and PreTrainedTokenizerFast's
    tokenizer_config.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import modernbert_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P13_SEED)]
    spec = modernbert_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT,
                                     MODERNBERT_CONFIG["vocab_size"], seed=P13_SEED)
    vocab = spec["model"]["vocab"]
    if [vocab[t] for t in ("[CLS]", "[SEP]", "[PAD]")] != [
            MODERNBERT_CONFIG[k] for k in ("cls_token_id", "sep_token_id", "pad_token_id")]:
        raise AssertionError("the tokenizer's specials are not at ModernBERT-base's ids")
    write_checkpoint(path, MODERNBERT_CONFIG, random_state_dict(MODERNBERT_CONFIG, P13_SEED),
                     tokenizer_json=spec)


def modernbert_phase(device, card: str, n_docs: int) -> dict:
    """Phase 13, the ModernBERT path: hn25k-modernbert-hf through its own
    App (`hf_path`), with the long check texts."""
    t_phase = time.perf_counter()
    out = hf_path(device, card, n_docs, label="ModernBERT-base", index="mb",
                  write=write_modernbert_checkpoint, seed=P13_SEED, queries=P11_TEXT,
                  check_texts=P11_CHECK_TEXT + ["hello [MASK] world", "x[MASK]y  [MASK]",
                                                "cafe\u0301 A\u030a", "a   b    c"],
                  tokenizer="BPE", model_type="modernbert",
                  checks=(partial(long_check, texts=long_check_texts(P13_SEED)),))
    say(f"phase 13 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def write_camembert_checkpoint(path: str) -> None:
    """A checkpoint of camembert-base's width (12 layers, RoBERTa's names),
    written as pytorch_model.bin with a 32,005-entry Unigram tokenizer.json
    in CamembertConverter's layout (e5_pieces and e5_charsmap) and
    CamembertTokenizerFast's tokenizer_config.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import camembert_tokenizer_json

    spec = camembert_tokenizer_json(e5_pieces(31_997, P14_SEED), e5_charsmap())
    if len(spec["model"]["vocab"]) != CAMEMBERT_CONFIG["vocab_size"]:
        raise AssertionError(f"CamemBERT's vocabulary has {len(spec['model']['vocab'])} entries")
    write_checkpoint(path, CAMEMBERT_CONFIG, random_state_dict(CAMEMBERT_CONFIG, P14_SEED),
                     tokenizer_json=spec)


def write_electra_checkpoint(path: str) -> None:
    """A checkpoint of electra-small-discriminator's width (12 layers,
    128-wide embeddings and their projection to 256), written as
    pytorch_model.bin with bge_vocab()'s WordPiece vocab.txt (uncased)."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, ELECTRA_SMALL_CONFIG,
                     random_state_dict(ELECTRA_SMALL_CONFIG, P14_SEED), bge_vocab(),
                     do_lower_case=True)


def write_deberta_checkpoint(path: str) -> None:
    """A checkpoint of deberta-v3-base's width (12 layers, DebertaV2Model's
    names), written as pytorch_model.bin with a 128,000-piece Unigram
    tokenizer.json in DebertaV2Converter's layout (do_lower_case and
    split_by_punct false, as published; e5_pieces and e5_charsmap), [MASK]
    at 128,000, and DebertaV2TokenizerFast's tokenizer_config.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import deberta_v3_tokenizer_json

    spec = deberta_v3_tokenizer_json(e5_pieces(127_996, P14_SEED + 1), e5_charsmap())
    mask = [t["id"] for t in spec["added_tokens"] if t["content"] == "[MASK]"]
    if len(spec["model"]["vocab"]) != 128_000 or mask != [128_000]:
        raise AssertionError("the tokenizer is not laid out as deberta-v3-base's")
    write_checkpoint(path, DEBERTA_V3_CONFIG, random_state_dict(DEBERTA_V3_CONFIG, P14_SEED),
                     tokenizer_json=spec)


def families_phase(device, card: str, n_docs: int) -> dict:
    """Phase 14, the last refused families: hn10k-camembert-hf,
    hn10k-electrasmall-hf and hn10k-debertav3-hf, each through its own App
    (`hf_path`); DeBERTa with the long check texts, whose relative
    distances over 128 reach its log buckets."""
    t_phase = time.perf_counter()
    out = {}
    for label, index, write, tokenizer, model_type, check_texts, checks in (
            ("camembert-base", "cb", write_camembert_checkpoint, "Unigram", "camembert",
             E5_CHECK_TEXT + P14_CAMEMBERT_TEXT, ()),
            ("electra-small-discriminator", "el", write_electra_checkpoint, "WordPiece",
             "electra", P11_CHECK_TEXT + P14_ELECTRA_TEXT, ()),
            ("deberta-v3-base", "dv", write_deberta_checkpoint, "Unigram", "deberta-v2",
             E5_CHECK_TEXT + P14_DEBERTA_TEXT,
             (partial(long_check, texts=long_check_texts(P14_SEED)),))):
        t = time.perf_counter()
        out[label] = hf_path(device, card, n_docs, label=label, index=index, write=write,
                             seed=P14_SEED, queries=P11_TEXT, check_texts=check_texts,
                             tokenizer=tokenizer, model_type=model_type, checks=checks)
        say(f"phase 14 {label} wall: {time.perf_counter() - t:.3f} s")
    say(f"phase 14 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def write_qwen3_embedding_checkpoint(path: str) -> None:
    """A checkpoint of Qwen3-Embedding-0.6B's width (7 of its 28 layers,
    DecoderModel's names), written as model.safetensors with a
    151,643-entry byte-level BPE tokenizer.json in Qwen2's layout, its
    merges trained through Qwen2's Split pattern on the phase's own texts,
    Qwen3-Embedding's `$A <|endoftext|>`, and Qwen2Tokenizer's
    tokenizer_config.json with padding_side left."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import qwen2_tokenizer_config, qwen2_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P15_SEED)]
    spec = qwen2_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT, QWEN3_BPE_SIZE,
                                seed=P15_SEED, eos_template=True)
    vocab = spec["model"]["vocab"]
    if len(vocab) != QWEN3_EMBEDDING_CONFIG["vocab_size"] or \
            vocab["<|endoftext|>"] != QWEN3_EMBEDDING_CONFIG["eos_token_id"]:
        raise AssertionError("the tokenizer is not laid out as Qwen3-Embedding-0.6B's")
    write_checkpoint(path, QWEN3_EMBEDDING_CONFIG,
                     random_state_dict(QWEN3_EMBEDDING_CONFIG, P15_SEED), tokenizer_json=spec,
                     tokenizer_config=qwen2_tokenizer_config(spec, padding_side="left"))


@contextlib.contextmanager
def pooled(enc, pooling: str):
    """`enc` with its pooling set to `pooling` inside the block: a check's
    two poolings share the cached encoder's one copy of the model."""
    before = enc.pooling
    enc.pooling = pooling
    try:
        yield enc
    finally:
        enc.pooling = before


def left_pad_check(path: str, device, label: str) -> float:
    """LEFT_PAD_TEXT in one batch, left-padded as the checkpoint's
    tokenizer_config.json asks, under forceCls and under mean pooling:
    card against CPU (`encoder_check`'s bound); returns the larger error."""
    import numpy as np

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    _ids, mask = enc._tokenizer(LEFT_PAD_TEXT, enc.max_len)
    lengths = mask.sum(1).tolist()
    if enc._tokenizer.padding_side != "left" or int(mask[:, -1].min()) != 1 \
            or int(mask[:, 0].min()) != 0:
        raise AssertionError(f"{label}: the check batch is not left-padded: {lengths}")
    errs = {}
    cpu = cpu_encoder(path)
    for pooling in ("forceCls", "useModel"):
        with pooled(enc, pooling), pooled(cpu, pooling):
            got, want = enc.encode(LEFT_PAD_TEXT), cpu.encode(LEFT_PAD_TEXT)
        if not np.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite {pooling} vectors on the card")
        errs[pooling] = float(np.abs(got - want).max())
    say(f"{label} left-padded batch ({lengths} tokens in a row of {mask.shape[1]}), card against"
        f" CPU: forceCls max abs error {errs['forceCls']:.3e}, mean pooling"
        f" {errs['useModel']:.3e} (bound {ENC_TOL:g})")
    if not max(errs.values()) <= ENC_TOL:
        raise AssertionError(f"{label}: the left-padded batch is {errs} off the CPU")
    return max(errs.values())


def qwen3_embedding_phase(device, card: str, n_docs: int) -> dict:
    """Phase 15, the decoder embedder path: hn10k-qwen3emb-hf through its
    own App (`hf_path`), with the left-padded check."""
    t_phase = time.perf_counter()
    out = hf_path(device, card, n_docs, label="Qwen3-Embedding-0.6B", index="q3",
                  write=write_qwen3_embedding_checkpoint, seed=P15_SEED, queries=P11_TEXT,
                  check_texts=P11_CHECK_TEXT + P15_TEXT, tokenizer="BPE", model_type="qwen3",
                  checks=(left_pad_check,))
    say(f"phase 15 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def embeddinggemma_spec() -> dict:
    """The 262,144-piece tokenizer.json in GemmaConverter's layout, its
    merges trained on the phase's own texts; checked against the config's
    vocabulary size and special ids."""
    from meilisearch_tpu_torch.models.fixtures import gemma_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P16_SEED)]
    spec = gemma_tokenizer_json(texts + P11_TEXT, EMBEDDINGGEMMA_CONFIG["vocab_size"],
                                seed=P16_SEED)
    vocab = spec["model"]["vocab"]
    c = EMBEDDINGGEMMA_CONFIG
    if len(vocab) != c["vocab_size"] or [vocab[t] for t in ("<pad>", "<eos>", "<bos>", "<unk>")] \
            != [c["pad_token_id"], c["eos_token_id"], c["bos_token_id"], 3]:
        raise AssertionError("the tokenizer is not laid out as EmbeddingGemma's")
    return spec


def write_gemma_checkpoint(path: str, config: dict, seed: int, spec: dict) -> None:
    """A gemma3_text checkpoint of `config` (Gemma3Model's names, seeded
    weights), written as model.safetensors beside `spec` and
    GemmaTokenizer's tokenizer_config.json with add_bos_token and
    add_eos_token both true."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import gemma_tokenizer_config

    write_checkpoint(path, config, random_state_dict(config, seed), tokenizer_json=spec,
                     tokenizer_config=gemma_tokenizer_config(spec, add_eos_token=True))


def window_check(path: str, device, label: str) -> float:
    """Two 2-layer checkpoints at EmbeddingGemma's widths beside `path`'s
    tokenizer files, GEMMA_WINDOW_CONFIG's (bidirectional) and
    GEMMA_VARIANT_CONFIG's (causal, scaled global rotary, softcap, erf
    GELU): phase 13's long texts in one batch (`long_check`) for each,
    after checking that its reach (9 and 16 tokens) is under their
    lengths and its layers are one sliding, one full; returns the larger
    error."""
    import json
    import os
    import tempfile

    from meilisearch_tpu_torch.models.gemma3 import check_config

    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    err = 0.0
    for config, seed, what in (
            (GEMMA_WINDOW_CONFIG, P16_SEED + 1, "sliding_window 16"),
            (GEMMA_VARIANT_CONFIG, P16_SEED + 2, "(d) causal, sliding_window_pattern 2,"
             " sliding_window 16, rope_scaling linear 8, attn_logit_softcapping 50, gelu")):
        checked = check_config(config)
        reach = checked["window"]
        if reach >= LONG_TOKENS or checked["layer_types"] != ["sliding_attention",
                                                              "full_attention"]:
            raise AssertionError(f"the window ({reach} tokens, {checked['layer_types']}) would"
                                 " not bite")
        with tempfile.TemporaryDirectory() as small:
            write_gemma_checkpoint(small, config, seed, spec)
            err = max(err, long_check(small, device, f"{label} 2 layers, {what} (reach {reach})",
                                      texts=long_check_texts(P16_SEED)))
    return err


def embeddinggemma_phase(device, card: str, n_docs: int) -> dict:
    """Phase 16, the EmbeddingGemma path: hn10k-embeddinggemma-hf through
    its own App (`hf_path`), with the left-padded check and the window
    check."""
    t_phase = time.perf_counter()
    spec = embeddinggemma_spec()
    say(f"EmbeddingGemma tokenizer ({len(spec['model']['vocab'])} pieces,"
        f" {len(spec['model']['merges'])} merges) built in {time.perf_counter() - t_phase:.3f} s")
    out = hf_path(device, card, n_docs, label="embeddinggemma-300m", index="eg",
                  write=lambda path: write_gemma_checkpoint(path, EMBEDDINGGEMMA_CONFIG, P16_SEED,
                                                            spec),
                  seed=P16_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P16_TEXT,
                  tokenizer="BPE", model_type="gemma3_text",
                  checks=(left_pad_check, window_check))
    say(f"phase 16 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def llama32_spec() -> dict:
    """The 128,256-entry tokenizer.json in Llama-3's layout, its merges
    trained on the phase's own texts; checked against the config's
    vocabulary size and special ids."""
    from meilisearch_tpu_torch.models.fixtures import llama3_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P17_SEED)]
    spec = llama3_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT, LLAMA3_BPE_SIZE,
                                 seed=P17_SEED, n_reserved=LLAMA3_RESERVED)
    vocab = spec["model"]["vocab"]
    c = LLAMA32_1B_CONFIG
    if len(vocab) != c["vocab_size"] or [vocab["<|begin_of_text|>"], vocab["<|end_of_text|>"]] \
            != [c["bos_token_id"], c["eos_token_id"]]:
        raise AssertionError("the tokenizer is not laid out as Llama-3.2-1B's")
    return spec


def write_llama_checkpoint(path: str, config: dict, seed: int, spec: dict,
                           bias_std: float = 0.0) -> None:
    """A decoder checkpoint of `config` (DecoderModel's names, seeded
    weights), written as model.safetensors beside `spec` and Llama-3's
    tokenizer_config.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import llama3_tokenizer_config

    write_checkpoint(path, config, random_state_dict(config, seed, bias_std), tokenizer_json=spec,
                     tokenizer_config=llama3_tokenizer_config(spec))


def llama32_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch
    (`long_check`), after checking that the module runs the llama3
    rotary."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    if enc._model.rope.kind != "llama3":
        raise AssertionError(f"{label}: the module runs the {enc._model.rope.kind} rotary")
    return long_check(path, device, f"{label} {LLAMA32_1B_CONFIG['num_hidden_layers']} layers,"
                      " llama3 rope",
                      texts=long_check_texts(P17_SEED))


def decoder_variants_check(path: str, device, label: str) -> float:
    """DECODER_VARIANTS' 2-layer checkpoints beside `path`'s tokenizer files
    (MLP biases drawn at BGE_INIT_STD): phase 13's long texts in one batch
    (`long_check`) for each, after checking that each window's reach is
    under their lengths; returns the largest error."""
    import json
    import os
    import tempfile

    from meilisearch_tpu_torch.models.checkpoint import check_config

    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    err = 0.0
    for i, (what, config) in enumerate(DECODER_VARIANTS.items()):
        checked = check_config(config)
        if checked["window"] is not None and checked["window"] >= LONG_TOKENS:
            raise AssertionError(f"{what}: the window ({checked['window']} tokens) would not bite")
        with tempfile.TemporaryDirectory() as small:
            write_llama_checkpoint(small, config, P17_SEED + 1 + i, spec, bias_std=BGE_INIT_STD)
            err = max(err, long_check(small, device, f"{label} variant {what}",
                                      texts=long_check_texts(P17_SEED)))
    return err


def llama32_phase(device, card: str, n_docs: int) -> dict:
    """Phase 17, the Llama-3.2-1B path: hn10k-llama32-1b-hf through its own
    App (`hf_path`), with the long check and the decoder variants, after
    the earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 17 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    t0 = time.perf_counter()
    spec = llama32_spec()
    say(f"Llama-3 tokenizer ({len(spec['model']['vocab'])} entries,"
        f" {len(spec['model']['merges'])} merges) built in {time.perf_counter() - t0:.3f} s")
    out = hf_path(device, card, n_docs, label="Llama-3.2-1B", index="l32",
                  write=lambda path: write_llama_checkpoint(path, LLAMA32_1B_CONFIG, P17_SEED,
                                                            spec),
                  seed=P17_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P17_TEXT,
                  tokenizer="BPE", model_type="llama",
                  checks=(llama32_long_check, decoder_variants_check))
    say(f"phase 17 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def write_albert_checkpoint(path: str, config: dict = ALBERT_SMALL_CONFIG,
                            seed: int = P18_SEED, spec=None) -> None:
    """An ALBERT checkpoint of `config` (AlbertModel's names, the projection
    as encoder.embedding_hidden_mapping_in), written as pytorch_model.bin
    beside a 30,000-entry Unigram tokenizer.json in AlbertConverter's
    layout (e5_pieces and e5_charsmap) and AlbertTokenizerFast's
    tokenizer_config.json, or beside `spec`."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import albert_tokenizer_json

    if spec is None:
        spec = albert_tokenizer_json(e5_pieces(29_995, P18_SEED), e5_charsmap())
    if len(spec["model"]["vocab"]) != config["vocab_size"]:
        raise AssertionError(f"ALBERT's vocabulary has {len(spec['model']['vocab'])} entries")
    write_checkpoint(path, config, random_state_dict(config, seed), tokenizer_json=spec)


def wordpiece_vocab(size: int) -> list:
    """`size` WordPiece entries laid out as ERNIE 3.0's vocab.txt
    (fixtures.ernie_vocab) over the corpus's words and the template's
    field names."""
    from meilisearch_tpu_torch.models.fixtures import ernie_vocab
    from meilisearch_tpu_torch.utils.synthetic import WORDS

    return ernie_vocab(WORDS + "title url author https example com user".split(), size)


def write_wordpiece_checkpoint(path: str, config: dict, seed: int) -> None:
    """A checkpoint of `config` written as pytorch_model.bin beside a
    WordPiece vocab.txt of its vocabulary size (uncased, BertTokenizer's
    class)."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, config, random_state_dict(config, seed),
                     wordpiece_vocab(config["vocab_size"]), do_lower_case=True)


def albert_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch
    (`long_check`), after checking that its 6 passes run one layer's
    weights."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    passes = enc._model.passes()
    if len(passes) != 6 or any(p is not passes[0] for p in passes):
        raise AssertionError(f"{label}: the passes do not share one layer")
    return long_check(path, device, f"{label} 6 shared passes",
                      texts=long_check_texts(P18_SEED))


def bert_variants_check(path: str, device, label: str) -> float:
    """BERT_VARIANTS' checkpoints (ALBERT's beside `path`'s tokenizer.json,
    the others beside a WordPiece vocabulary of their size): phase 13's
    long texts in one batch (`long_check`) for each, after checking that
    the module runs the variant's mechanism; returns the largest error."""
    import json
    import os
    import tempfile

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    err = 0.0
    for i, (what, config) in enumerate(BERT_VARIANTS.items()):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            if config.get("model_type") == "albert":
                write_albert_checkpoint(small, config, P18_SEED + 1 + i, spec)
            else:
                write_wordpiece_checkpoint(small, config, P18_SEED + 1 + i)
            enc = encoder(small, "useModel", device)
            enc._load()
            mine = {k: enc._model.config.get(k) for k in (
                "model_type", "position_embedding_type", "rotary_value", "num_hidden_groups")}
            if any(config.get(k) not in (None, v) for k, v in mine.items()):
                raise AssertionError(f"{what}: the module reads {mine}")
            err = max(err, long_check(small, device, f"{label} variant {what}",
                                      texts=long_check_texts(P18_SEED)))
            encoder.cache_clear()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error {err:.3e} (bound {ENC_TOL:g})")
    encoder(path, "useModel", device)._load()  # hf_path goes on with `path`'s, cached
    return err


def bert_families_phase(device, card: str, n_docs: int) -> dict:
    """Phase 18, hn10k-albertsmall-hf and hn10k-ernie3base-hf, each through
    its own App (`hf_path`) with the long check (ALBERT's with the
    BERT-shaped variants beside its tokenizer), once the earlier phases'
    encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 18 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    out = {}
    for label, index, write, tokenizer, model_type, check_texts, checks in (
            ("paraphrase-albert-small-v2", "al", write_albert_checkpoint, "Unigram", "albert",
             E5_CHECK_TEXT + P18_ALBERT_TEXT, (albert_long_check, bert_variants_check)),
            ("ernie-3.0-base-zh", "er",
             lambda path: write_wordpiece_checkpoint(path, ERNIE3_BASE_CONFIG, P18_SEED),
             "WordPiece", "ernie", P11_CHECK_TEXT + P18_ERNIE_TEXT,
             (partial(long_check, texts=long_check_texts(P18_SEED)),))):
        t = time.perf_counter()
        out[label] = hf_path(device, card, n_docs, label=label, index=index, write=write,
                             seed=P18_SEED, queries=P11_TEXT, check_texts=check_texts,
                             tokenizer=tokenizer, model_type=model_type, checks=checks)
        say(f"phase 18 {label} wall: {time.perf_counter() - t:.3f} s")
    say(f"phase 18 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def write_mobilebert_checkpoint(path: str) -> None:
    """A checkpoint of google/mobilebert-uncased's config (24 layers,
    MobileBertModel's names) beside a 30,522-entry WordPiece vocab.txt."""
    write_wordpiece_checkpoint(path, MOBILEBERT_UNCASED_CONFIG, P19_SEED)


@lru_cache(maxsize=1)
def xlnet_spec() -> dict:
    """A 32,000-entry Unigram tokenizer.json in XLNetConverter's layout
    (cased, accents stripped, as xlnet-base-cased): its nine specials, then
    e5_pieces, with e5_charsmap."""
    from meilisearch_tpu_torch.models.fixtures import xlnet_tokenizer_json

    spec = xlnet_tokenizer_json(e5_pieces(31_991, P19_SEED), e5_charsmap())
    if len(spec["model"]["vocab"]) != XLNET_BASE_CONFIG["vocab_size"]:
        raise AssertionError("the tokenizer is not laid out as xlnet-base-cased's")
    return spec


def write_xlnet_checkpoint(path: str) -> None:
    """A checkpoint of xlnet-base-cased's config (12 layers, XLNetModel's
    names) beside `xlnet_spec()` and XLNetTokenizerFast's
    tokenizer_config.json."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, XLNET_BASE_CONFIG, random_state_dict(XLNET_BASE_CONFIG, P19_SEED),
                     tokenizer_json=xlnet_spec())


def mobilebert_long_check(path: str, device, label: str) -> float:
    """Phase 13's long texts in one batch (`long_check`), after checking
    that the module runs MobileBERT's mechanisms: NoNorm, the trigram, 4
    FFNs a layer, the shared bottleneck and a zero pad row."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder
    from meilisearch_tpu_torch.models.mobilebert import NoNorm

    enc = encoder(path, "useModel", device)
    enc._load()
    m = enc._model
    layer = m.encoder.layer[0]
    if not (isinstance(m.embeddings.LayerNorm, NoNorm) and m.embeddings.trigram
            and len(layer.ffn) == 3 and layer.bottleneck.attention is not None
            and not bool(m.embeddings.word_embeddings.weight[0].any())):
        raise AssertionError(f"{label}: the module does not run MobileBERT's layout")
    return long_check(path, device, f"{label} (24 layers)", texts=long_check_texts(P19_SEED))


def xlnet_long_check(path: str, device, label: str) -> float:
    """Phase 13's long texts in one batch (`long_check`), after checking
    that the encoder passes XLNet's token types: `<cls>` last with type 2,
    the left padding type 3."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    _ids, mask, types = enc.tokenize(LEFT_PAD_TEXT)
    if not enc._types or types is None or int(types[:, -1].min()) != 2 \
            or not bool((types[mask == 0] == 3).all()) or int(mask[:, 0].min()) != 0:
        raise AssertionError(f"{label}: the token types do not reach the model")
    return long_check(path, device, f"{label} (relative attention)",
                      texts=long_check_texts(P19_SEED))


def p19_variants_check(path: str, device, label: str) -> float:
    """P19_VARIANTS' checkpoints (DeBERTa's beside phase 14's Unigram
    tokenizer.json, the others beside a WordPiece vocabulary of their
    size): phase 13's long texts in one batch (`long_check`) for each,
    after checking that the module runs the variant's mechanism; returns
    the largest error."""
    import tempfile

    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import deberta_v3_tokenizer_json
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    deberta_spec = None
    err = 0.0
    for i, (what, config) in enumerate(P19_VARIANTS.items()):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            if config["model_type"] == "deberta-v2":
                if deberta_spec is None:
                    deberta_spec = deberta_v3_tokenizer_json(e5_pieces(127_996, P14_SEED + 1),
                                                             e5_charsmap())
                write_checkpoint(small, config, random_state_dict(config, P19_SEED + 1 + i),
                                 tokenizer_json=deberta_spec)
            else:
                write_wordpiece_checkpoint(small, config, P19_SEED + 1 + i)
            enc = encoder(small, "useModel", device)
            enc._load()
            c = enc._model.config
            mine = {k: c.get(k) for k in ("model_type", "q_groups", "conv_kernel_size",
                                          "relative_attention", "sinusoidal_pos_embds",
                                          "emb_dim")}
            wrong = [k for k, v in mine.items() if config.get(k) not in (None, v)]
            if config.get("activation") not in (None, c.get("hidden_act")):
                wrong.append("activation")
            if (config["model_type"] == "xlm") is not enc._types:
                wrong.append("token types")  # XLM's only, from BertTokenizer's class
            if wrong:
                raise AssertionError(f"{what}: the module reads {wrong} otherwise: {mine}")
            err = max(err, long_check(small, device, f"{label} variant {what}",
                                      texts=long_check_texts(P19_SEED)))
            encoder.cache_clear()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error {err:.3e} (bound {ENC_TOL:g})")
    encoder(path, "useModel", device)._load()  # hf_path goes on with `path`'s, cached
    return err


def more_families_phase(device, card: str, n_docs: int) -> dict:
    """Phase 19, hn10k-mobilebert-hf and hn10k-xlnetbase-hf, each through
    its own App (`hf_path`) with its checks (XLNet's left-padded batch
    under both poolings, its token types, and P19_VARIANTS beside it), once
    the earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 19 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    out = {}
    for label, index, write, tokenizer, model_type, check_texts, checks in (
            ("mobilebert-uncased", "mb", write_mobilebert_checkpoint, "WordPiece", "mobilebert",
             P11_CHECK_TEXT + P19_MOBILEBERT_TEXT, (mobilebert_long_check,)),
            ("xlnet-base-cased", "xl", write_xlnet_checkpoint, "Unigram", "xlnet",
             E5_CHECK_TEXT + P19_XLNET_TEXT,
             (left_pad_check, xlnet_long_check, p19_variants_check))):
        t = time.perf_counter()
        out[label] = hf_path(device, card, n_docs, label=label, index=index, write=write,
                             seed=P19_SEED, queries=P11_TEXT, check_texts=check_texts,
                             tokenizer=tokenizer, model_type=model_type, checks=checks)
        say(f"phase 19 {label} wall: {time.perf_counter() - t:.3f} s")
    say(f"phase 19 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


@lru_cache(maxsize=None)
def moses_files(vocab_size: int, lang: str, lowercase: bool) -> tuple:
    """(vocab.json's dict, merges.txt's text) of a seeded BPE in XLM's
    layout of `vocab_size` entries, its merges trained on the Moses tokens
    of P20_TRAINING_DOCS rendered documents (fixtures.moses_bpe_files,
    merges.txt with counts)."""
    from meilisearch_tpu_torch.models.fixtures import moses_bpe_files
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(P20_TRAINING_DOCS, seed=P20_SEED)]
    vocab, merges = moses_bpe_files(texts + P20_TEXT, vocab_size, P20_SEED, lang=lang,
                                    lowercase=lowercase, counts=True)
    if len(vocab) != vocab_size:
        raise AssertionError(f"the seeded BPE has {len(vocab)} entries, not {vocab_size}")
    return vocab, merges


def write_moses_checkpoint(path: str, config: dict, seed: int, tokenizer_class: str,
                           flags: dict) -> None:
    """A checkpoint of `config` (XLMModel's names, model.safetensors) beside
    `moses_files` of its vocabulary size (lowercased as the class's flags
    ask; "fr" Moses for FlauBERT) and the class's tokenizer_config.json
    with `flags`."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import moses_tokenizer_config

    flaubert = tokenizer_class == "FlaubertTokenizer"
    lowercase = (flags.get("do_lowercase", False) if flaubert
                 else flags.get("do_lowercase_and_remove_accent", True))
    files = moses_files(config["vocab_size"], "fr" if flaubert else "en", lowercase)
    write_checkpoint(path, config, random_state_dict(config, seed),
                     tokenizer_config=moses_tokenizer_config(tokenizer_class, **flags),
                     moses=files)


def moses_long_texts(seed: int) -> tuple:
    """long_check_texts with P20_LONG_HEAD in front of each long run (so
    truncation at 512 keeps it)."""
    return tuple(f"{P20_LONG_HEAD} {t}" if len(t) > 100 else t for t in long_check_texts(seed))


def moses_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on the long Moses texts in one batch
    (`long_check`), after checking that its tokenizer is the Moses BPE of
    the class it names, gives token types, and runs Moses's quirks: a
    newline joins two words, `<special1>` is one id."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    tok = enc._tokenizer
    _ids, _mask, types = enc.tokenize(["x"])
    if (type(tok).__name__ != "MosesBPE" or types is None
            or tok.ids("hello\nworld") != tok.ids("helloworld")
            or tok.ids("<special1>") != [tok.vocab["<special1>"]]):
        raise AssertionError(f"{label}: the tokenizer is not XLM's Moses BPE")
    return long_check(path, device, f"{label} (Moses texts)", texts=moses_long_texts(P20_SEED))


def p20_variants_check(path: str, device, label: str) -> float:
    """P20_VARIANTS' checkpoints on the long Moses texts in one batch
    (`long_check`) each, after checking that the module and the tokenizer
    read the variant's flags; returns the largest error."""
    import tempfile

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    err = 0.0
    for i, (what, (config, tok_class, flags)) in enumerate(P20_VARIANTS.items()):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            write_moses_checkpoint(small, config, P20_SEED + 1 + i, tok_class, flags)
            enc = encoder(small, "useModel", device)
            enc._load()
            c, tok = enc._model.config, enc._tokenizer
            mine = (c["model_type"], c["emb_dim"], c["pre_norm"], tok.lang, tok.lower_accent,
                    tok.lowercase)
            want = (config["model_type"], config["emb_dim"], config.get("pre_norm", False),
                    "fr" if tok_class == "FlaubertTokenizer" else "en",
                    flags.get("do_lowercase_and_remove_accent", tok_class == "XLMTokenizer"),
                    flags.get("do_lowercase", False))
            if mine != want:
                raise AssertionError(f"{what}: the encoder reads {mine}, not {want}")
            err = max(err, long_check(small, device, f"{label} variant {what}",
                                      texts=moses_long_texts(P20_SEED)))
            encoder.cache_clear()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error {err:.3e} (bound {ENC_TOL:g})")
    encoder(path, "useModel", device)._load()  # hf_path goes on with `path`'s, cached
    return err


def moses_families_phase(device, card: str, n_docs: int) -> dict:
    """Phase 20, hn10k-xlmen2048-hf and hn10k-flaubertbase-hf, each through
    its own App (`hf_path`) with its Moses checks (and P20_VARIANTS beside
    FlauBERT's), once the earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 20 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    out = {}
    for label, index, config, tok_class, checks in (
            ("xlm-mlm-en-2048", "xe", XLM_EN_2048_CONFIG, "XLMTokenizer", (moses_check,)),
            ("flaubert_base_cased", "fb", FLAUBERT_BASE_CASED_CONFIG, "FlaubertTokenizer",
             (moses_check, p20_variants_check))):
        write = partial(write_moses_checkpoint, config=config, seed=P20_SEED,
                        tokenizer_class=tok_class, flags={})
        t = time.perf_counter()
        out[label] = hf_path(device, card, n_docs, label=label, index=index, write=write,
                             seed=P20_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P20_TEXT,
                             tokenizer="MosesBPE", model_type=config["model_type"],
                             checks=checks)
        hf_encoder.encoder.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
        say(f"phase 20 {label} wall: {time.perf_counter() - t:.3f} s")
    say(f"phase 20 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def p21_longrope(n: int = 36) -> dict:
    """Phi-3's three-field longrope with seeded factor lists of n entries
    (rotated width / 2: 96 x 0.75 / 2 = 36), each ascending, the short
    ones in [1, 1.2) and the long ones in [1, 40), as the published 128k
    configurations scale the low frequencies most."""
    import numpy as np

    rng = np.random.default_rng(P21_SEED)
    short = np.sort(1.0 + 0.2 * rng.random(n))
    long = np.sort(1.0 + 39.0 * rng.random(n))
    return {"type": "longrope", "short_factor": [round(float(x), 4) for x in short],
            "long_factor": [round(float(x), 4) for x in long]}


def p21_spec(vocab_size: int, phi3: bool = False, n_docs: int = BPE_TRAIN_DOCS) -> dict:
    """A seeded sentencepiece BPE of `vocab_size` pieces, its merges trained
    on `n_docs` of the phase's own texts: Gemma's layout, or (`phi3`)
    Llama-2's with Phi-3's chat tokens after it; checked against Gemma's
    special ids."""
    from meilisearch_tpu_torch.models import fixtures
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(n_docs, seed=P21_SEED)] + P11_TEXT
    if phi3:
        return fixtures.phi3_tokenizer_json(texts, vocab_size, seed=P21_SEED)
    spec = fixtures.gemma_tokenizer_json(texts, vocab_size, seed=P21_SEED)
    vocab = spec["model"]["vocab"]
    if len(vocab) != vocab_size or [vocab[t] for t in ("<pad>", "<eos>", "<bos>", "<unk>")] \
            != [0, 1, 2, 3]:
        raise AssertionError("the tokenizer is not laid out as Gemma's")
    return spec


def write_p21_checkpoint(path: str, config: dict, seed: int, spec: dict) -> None:
    """A `gemma2`, `gemma` or `phi3` checkpoint of `config` (the port's
    names, seeded weights; a Phi3ForCausalLM's `model.` names and a tied
    `lm_head.weight` where `architectures` says so), written as
    model.safetensors beside `spec` and its class's tokenizer_config.json
    (GemmaTokenizer's, or LlamaTokenizer's with Phi-3's `<|endoftext|>`
    pad), each padding left by default."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.fixtures import gemma_tokenizer_config, phi3_tokenizer_config

    state = random_state_dict(config, seed)
    if config.get("architectures") == ["Phi3ForCausalLM"]:
        state = {**{f"model.{k}": v for k, v in state.items()},
                 "lm_head.weight": state["embed_tokens.weight"]}
    phi3 = config["model_type"] == "phi3"
    write_checkpoint(path, config, state, tokenizer_json=spec,
                     tokenizer_config=(phi3_tokenizer_config if phi3 else gemma_tokenizer_config)(
                         spec))


def bge_gemma2_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch
    (`long_check`), after checking that the module runs Gemma 2's derived
    layer types (sliding, full, ...) with the published window and no Q/K
    norms."""
    from meilisearch_tpu_torch.models.gemma2 import Gemma2Model
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    model, c = enc._model, enc._model.config
    layers = BGE_GEMMA2_CONFIG["num_hidden_layers"]
    if not isinstance(model, Gemma2Model) or c["window"] != BGE_GEMMA2_CONFIG["sliding_window"] \
            or c["layer_types"] != ["sliding_attention", "full_attention"] * (layers // 2) \
            or hasattr(model.layers[0].self_attn, "q_norm"):
        raise AssertionError(f"{label}: the module is not Gemma 2's: {c['layer_types']}")
    return long_check(path, device, f"{label} {layers} layers", texts=long_check_texts(P21_SEED))


def p21_variants_check(device, label: str) -> float:
    """P21_VARIANTS' 2-layer checkpoints, each beside its own seeded
    32,000-piece tokenizer: phase 13's long texts in one batch
    (`long_check`) and the left-padded batch (`left_pad_check`), card
    against CPU, after checking that each module reads the variant's
    traps (the window under the long texts, Gemma's `hidden_act`, Phi-3's
    fused projections, its rotated width and longrope); returns the
    largest error. The earlier encoders are let go after each."""
    import gc
    import tempfile

    import torch

    from meilisearch_tpu_torch.models import activations
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    t0 = time.perf_counter()
    specs = {phi3: p21_spec(P21_VARIANT_VOCAB, phi3, P21_VARIANT_TRAIN_DOCS)
             for phi3 in (False, True)}
    say(f"{label} variants' tokenizers ({P21_VARIANT_VOCAB} pieces each) built in"
        f" {time.perf_counter() - t0:.3f} s")
    err = 0.0
    for i, (what, config) in enumerate(P21_VARIANTS.items()):
        t = time.perf_counter()
        kind = config["model_type"]
        if kind == "phi3":
            rotated = int(config["hidden_size"] // config["num_attention_heads"]
                          * config["partial_rotary_factor"])
            config = {**config, "rope_scaling": p21_longrope(rotated // 2)}
        with tempfile.TemporaryDirectory() as small:
            write_p21_checkpoint(small, config, P21_SEED + 1 + i, specs[kind == "phi3"])
            enc = encoder(small, "useModel", device)
            enc._load()
            model, c = enc._model, enc._model.config
            layer = model.layers[0]
            if kind == "phi3":
                h, heads = config["hidden_size"], config["num_attention_heads"]
                read = (c["window"], layer.self_attn.fused, model.rope.kind, model.rope.dim,
                        tuple(layer.self_attn.qkv_proj.weight.shape))
                want = (config["sliding_window"], True, "longrope", rotated,
                        (3 * h, h) if config["num_key_value_heads"] == heads else None)
            elif kind == "gemma":
                read = (c["window"], layer.mlp.act is activations.ACTIVATIONS["gelu"],
                        layer.self_attn.kv_heads)
                want = (None, True, config["num_key_value_heads"])
            else:
                read = (c["window"], c["layer_types"], c["attn_logit_softcapping"])
                want = (config["sliding_window"], ["sliding_attention", "full_attention"], 0.5)
            if c.get("window") is not None and c["window"] >= LONG_TOKENS:
                raise AssertionError(f"{what}: the window ({c['window']} tokens) would not bite")
            if read != want or enc._tokenizer.padding_side != "left":
                raise AssertionError(f"{what}: the encoder reads {read}, not {want}")
            err = max(err, long_check(small, device, f"{label} variant {what}",
                                      texts=long_check_texts(P21_SEED)),
                      left_pad_check(small, device, f"{label} variant {what}"))
            encoder.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error {err:.3e} (bound {ENC_TOL:g})")
    return err


def bge_gemma2_phase(device, card: str, n_docs: int) -> dict:
    """Phase 21, hn10k-bgegemma2-hf through its own App (`hf_path`) with
    the long and left-padded checks, after the variants' checks
    (`p21_variants_check`), once the earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 21 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    label = "bge-multilingual-gemma2"
    variants_err = p21_variants_check(device, label)
    t0 = time.perf_counter()
    spec = p21_spec(BGE_GEMMA2_CONFIG["vocab_size"])
    say(f"{label} tokenizer ({len(spec['model']['vocab'])} pieces,"
        f" {len(spec['model']['merges'])} merges) built in {time.perf_counter() - t0:.3f} s;"
        f" {BGE_GEMMA2_CONFIG['num_hidden_layers']} of its {BGE_GEMMA2_PUBLISHED_LAYERS}"
        " layers")
    out = hf_path(device, card, n_docs, label=label, index="bg2",
                  write=lambda path: write_p21_checkpoint(path, BGE_GEMMA2_CONFIG, P21_SEED, spec),
                  seed=P21_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P21_TEXT,
                  tokenizer="BPE", model_type="gemma2",
                  checks=(bge_gemma2_long_check, left_pad_check))
    out["err"] = max(out["err"], variants_err)
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 21 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def longformer_spec() -> dict:
    """Phase 22's 50,265-entry byte-level BPE in RoBERTa's layout, its
    merges trained on BPE_TRAIN_DOCS of the phase's own texts (as phase 11
    builds its)."""
    from meilisearch_tpu_torch.models.fixtures import roberta_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P22_SEED)]
    return roberta_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT,
                                  LONGFORMER_BASE_CONFIG["vocab_size"], seed=P22_SEED)


def write_p22_checkpoint(path: str, config: dict, seed: int, spec: dict) -> None:
    """A checkpoint of `config` (seeded weights), written as
    pytorch_model.bin beside `spec` and its model type's
    tokenizer_config.json (LongformerTokenizer's, RobertaTokenizer's,
    XLMRobertaTokenizer's or BigBirdTokenizerFast's; `write_checkpoint`)."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, config, random_state_dict(config, seed), tokenizer_json=spec)


def band_cut(counts: list, reach: int) -> tuple:
    """(pairs outside the band, all pairs): the (query, key) pairs of
    texts of `counts` real tokens that lie more than `reach` apart."""
    cut = sum(max(n - reach - 1, 0) * max(n - reach, 0) for n in counts)
    return cut, sum(n * n for n in counts)


def longformer_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch
    (`long_check`), after checking that the module is Longformer's with
    the published windows and counting the (query, key) pairs its band
    cuts from them."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder
    from meilisearch_tpu_torch.models.longformer import LongformerModel

    enc = encoder(path, "useModel", device)
    enc._load()
    model, c = enc._model, enc._model.config
    if not isinstance(model, LongformerModel) \
            or c["attention_window"] != LONGFORMER_BASE_CONFIG["attention_window"]:
        raise AssertionError(f"{label}: the module is not Longformer's: {type(model).__name__}")
    texts = long_check_texts(P22_SEED)
    _ids, mask, _types = enc.tokenize(list(texts))
    counts = mask.sum(1).tolist()
    reach = c["attention_window"][0] // 2
    cut, total = band_cut(counts, reach)
    say(f"{label}: the band (each query reaches {reach} tokens each way) cuts {cut} of the"
        f" {total} (query, key) pairs of the long texts ({100 * cut / total:.2f}%; texts of"
        f" {counts} tokens)")
    if cut == 0:
        raise AssertionError(f"{label}: the window does not bite on the long texts")
    return long_check(path, device, f"{label} {len(model.encoder.layer)} layers", texts=texts)


def p22_variants_check(path: str, device, label: str, spec: dict) -> float:
    """P22_VARIANTS' 2-layer checkpoints on phase 13's long texts in one
    batch (`long_check`) each, after checking that each module and
    tokenizer read the variant (Longformer's windows and the pairs they
    cut, data2vec-text's RoBERTa embeddings, XLM-RoBERTa-XL's pre-norms,
    BigBird's positions from 0 and its threshold); returns the largest
    error. (a) and (b) read the path's BPE `spec`; (c) and (d) their own
    seeded Unigram tokenizer.json. The earlier encoders are let go after
    each, and `path`'s is loaded again for hf_path."""
    import gc
    import tempfile

    import torch

    from meilisearch_tpu_torch.models import bert, fixtures
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    texts = long_check_texts(P22_SEED)
    err = 0.0
    for i, (what, config) in enumerate(P22_VARIANTS.items()):
        t = time.perf_counter()
        kind = config["model_type"]
        n = config["vocab_size"]
        if kind == "xlm-roberta-xl":  # XLM-R's five specials around the pieces
            tok = fixtures.xlmr_tokenizer_json(e5_pieces(n - 5, P22_SEED))
        elif kind == "big_bird":  # BigBird's seven
            tok = fixtures.bigbird_tokenizer_json(e5_pieces(n - 7, P22_SEED))
        else:
            tok = spec
        if len(tok["model"]["vocab"]) != n:
            raise AssertionError(f"{what}: the tokenizer does not fill the vocabulary")
        with tempfile.TemporaryDirectory() as small:
            write_p22_checkpoint(small, config, P22_SEED + 1 + i, tok)
            enc = encoder(small, "useModel", device)
            enc._load()
            model, c = enc._model, enc._model.config
            emb = model.embeddings
            read = (c["model_type"], type(enc._tokenizer).__name__, emb.padding_idx)
            want = (kind, "Unigram" if kind in ("xlm-roberta-xl", "big_bird") else "BPE",
                    None if kind == "big_bird" else 1)
            if kind == "longformer":
                read += (c["attention_window"],)
                want += (config["attention_window"],)
                _ids, mask, _types = enc.tokenize(list(texts))
                for w in sorted(set(c["attention_window"])):
                    cut, total = band_cut(mask.sum(1).tolist(), w // 2)
                    say(f"{label} variant {what}: window {w} cuts {cut} of {total} pairs"
                        f" ({100 * cut / total:.2f}%)")
            elif kind == "xlm-roberta-xl":
                read += (emb.LayerNorm, model.encoder.layer[0].attention.ln is not None,
                         model.encoder.ln is not None, c["hidden_size"])
                want += (None, True, True, config["hidden_size"])
            elif kind == "big_bird":
                read += (model.sparse_threshold, emb.scale, c["hidden_act"])
                want += (bert.sparse_threshold(config), None, "gelu_new")
            if read != want:
                raise AssertionError(f"{what}: the encoder reads {read}, not {want}")
            err = max(err, long_check(small, device, f"{label} variant {what}", texts=texts))
            encoder.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error {err:.3e} (bound {ENC_TOL:g})")
    encoder(path, "useModel", device)._load()  # hf_path goes on with `path`'s, cached
    return err


def longformer_phase(device, card: str, n_docs: int) -> dict:
    """Phase 22, hn10k-longformerbase-hf through its own App (`hf_path`)
    with the long check and P22_VARIANTS inside its checks, once the
    earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 22 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    label = "longformer-base-4096"
    reach = LONGFORMER_BASE_CONFIG["attention_window"][0] // 2
    t0 = time.perf_counter()
    spec = longformer_spec()
    say(f"{label} tokenizer ({len(spec['model']['vocab'])} entries,"
        f" {len(spec['model']['merges'])} merges) built in {time.perf_counter() - t0:.3f} s;"
        f" at the timed chunk's {ENC_TIMED_TOKENS} tokens the band ({reach} each way) holds"
        f" {100 * (1 - band_cut([ENC_TIMED_TOKENS], reach)[0] / ENC_TIMED_TOKENS ** 2):.1f}% of"
        " the scores the port computes")
    out = hf_path(device, card, n_docs, label=label, index="lf",
                  write=lambda path: write_p22_checkpoint(path, LONGFORMER_BASE_CONFIG, P22_SEED,
                                                          spec),
                  seed=P22_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P22_TEXT,
                  tokenizer="BPE", model_type="longformer",
                  checks=(longformer_long_check, partial(p22_variants_check, spec=spec)))
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 22 wall: {time.perf_counter() - t_phase:.3f} s")
    return out



def p23_documents(n_docs: int) -> list:
    """Phase 23's documents: seeded hackernews ones, each with a `text`
    field, a seeded run of P23_WORDS of the corpus's words
    (`long_check_texts`' generator), but P23_SHORT spread among them whose
    text is 2-12 words."""
    import numpy as np

    from meilisearch_tpu_torch.utils.synthetic import WORDS, generate_hackernews_like

    rng = np.random.default_rng(P23_SEED)
    short = set(rng.choice(n_docs, P23_SHORT, replace=False).tolist())
    docs = generate_hackernews_like(n_docs, seed=P23_SEED)
    for i, doc in enumerate(docs):
        n = int(rng.integers(2, 13) if i in short else rng.integers(P23_WORDS[0], P23_WORDS[1] + 1))
        doc["text"] = " ".join(rng.choice(WORDS, size=n))
    return docs


def pattern_pairs(L: int, block: int, r: int) -> int:
    """The (query, key) pairs a batch row of L tokens (a multiple of
    `block`) scores under BigBird's block-sparse pattern, each key once."""
    from meilisearch_tpu_torch.models.big_bird import block_counts

    return int((block_counts(L // block, r) > 0).sum()) * block * block


def sparse_chunk_timing(enc, card: str, label: str) -> dict:
    """One indexing chunk at 512 tokens (chunk_texts() texts, every token
    real), which runs block-sparse: device time by CUDA events, median of
    REPEATS, against its float32 bound counted over the pattern's pairs
    (the port computes every (L, L) score and masks the rest; both counts
    printed)."""
    import torch

    from meilisearch_tpu_torch.models import big_bird

    c = enc._model.config
    n, L = enc.chunk_texts(), enc.max_len
    g = torch.Generator().manual_seed(P23_SEED)
    ids = torch.randint(1000, c["vocab_size"], (n, L), generator=g)
    mask = torch.ones((n, L), dtype=torch.int64)
    big_bird.FORWARDS.reset()
    ms = _median_ms(lambda: enc.forward(ids, mask), reps=REPEATS)
    if big_bird.FORWARDS.value == 0:
        raise AssertionError(f"{label}: the 512-token chunk did not run block-sparse")
    pairs = pattern_pairs(L, c["block_size"], c["num_random_blocks"])
    layers, width = c["num_hidden_layers"], c["hidden_size"]
    linear = 2 * projection_weights(enc._model) * n * L
    flops = linear + 4 * pairs * width * layers * n
    dense = encoder_flops(enc._model, n, L)
    bound_ms = flops / FP32_FLOP_S * 1e3
    say(f"timing {label} on {card}: one block-sparse chunk ({n} texts x {L} tokens) {ms:.4f} ms"
        f" (CUDA events, median of {REPEATS}); the pattern scores {pairs} of the {L * L}"
        f" (query, key) pairs a row ({100 * pairs / (L * L):.2f}%): {flops / 1e12:.3f} TFLOP with"
        f" the pattern ({linear / 1e12:.3f} of it Linear), {dense / 1e12:.3f} TFLOP with the"
        f" (L, L) product the port computes; {flops / ms / 1e9:.2f} TFLOP/s of the pattern's"
        f" work, bound {bound_ms:.4f} ms ({FP32_FLOP_S / 1e12:.0f} TFLOP/s float32),"
        f" {bound_ms / ms:.2f} of the bound")
    return {"sparse_chunk_ms": ms, "sparse_chunk_bound_ms": bound_ms}


def bigbird_sparse_check(path: str, device, label: str, *, card: str, timing: dict) -> float:
    """The phase's checkpoint: the module reads the model card's blocks
    (threshold 144); the path's 83 check texts ran full attention on both
    devices; phase 13's long texts in one batch (`long_check`) run
    block-sparse, card against CPU; then one 512-token chunk timed
    (`sparse_chunk_timing`, into `timing`)."""
    from meilisearch_tpu_torch.models import big_bird
    from meilisearch_tpu_torch.models.bert import BertModel
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    model = enc._model
    if not isinstance(model, BertModel) or model.sparse_threshold != 144:
        raise AssertionError(f"{label}: the module does not run the model card's blocks:"
                             f" {type(model).__name__}, threshold"
                             f" {getattr(model, 'sparse_threshold', None)}")
    if big_bird.FORWARDS.value:
        raise AssertionError(f"{label}: the check texts ran block-sparse")
    err = long_check(path, device, label, texts=long_check_texts(P23_SEED))
    sparse = big_bird.FORWARDS.value
    say(f"{label}: {sparse} block-sparse forwards on the long texts (card and CPU)")
    if sparse < 2:
        raise AssertionError(f"{label}: the long texts did not run block-sparse on both devices")
    timing.update(sparse_chunk_timing(enc, card, label))
    return err


def bigbird_sparse_phase(device, card: str, n_docs: int) -> dict:
    """Phase 23, hn2k-bigbirdsparse-hf through its own App (`hf_path`),
    its documents P23_WORDS long with documentTemplateMaxBytes
    P23_MAX_BYTES, the long check and the sparse chunk's timing inside its
    checks, once the earlier phases' encoders are let go. Fails unless the
    write ran block-sparse."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import big_bird, fixtures, hf_encoder
    from meilisearch_tpu_torch.vector import store as vstore

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 23 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    label = "bigbird-roberta-base (block 16, 2 random blocks)"
    config = BIGBIRD_SPARSE_CONFIG
    t0 = time.perf_counter()
    spec = fixtures.bigbird_tokenizer_json(e5_pieces(config["vocab_size"] - 7, P22_SEED))
    docs = p23_documents(n_docs)
    say(f"{label} tokenizer ({len(spec['model']['vocab'])} pieces) and {n_docs} documents"
        f" ({P23_SHORT} short) built in {time.perf_counter() - t0:.3f} s")
    big_bird.FORWARDS.reset()
    timing = {}
    # 1,024 rows are under the device legs' DEVICE_MIN_ROWS: the matrix is
    # sent to the card all the same, so the hybrid round takes the float leg
    min_rows, vstore.DEVICE_MIN_ROWS = vstore.DEVICE_MIN_ROWS, 1
    try:
        out = hf_path(device, card, n_docs, label=label, index="bb",
                      write=lambda path: write_p22_checkpoint(path, config, P23_SEED, spec),
                      seed=P23_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P22_TEXT,
                      tokenizer="Unigram", model_type="big_bird",
                      checks=(partial(bigbird_sparse_check, card=card, timing=timing),),
                      docs=docs,
                      settings={"searchableAttributes": [*VEC_SETTINGS["searchableAttributes"],
                                                         "text"]},
                      embedder={"documentTemplateMaxBytes": P23_MAX_BYTES})
    finally:
        vstore.DEVICE_MIN_ROWS = min_rows
    if out["sparse_forwards"] <= 0:
        raise AssertionError(f"{label}: no forward of the write ran block-sparse")
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 23 wall: {time.perf_counter() - t_phase:.3f} s")
    return {**out, **timing}


def sgpt_spec() -> dict:
    """Phase 24's 50,257-entry byte-level BPE in GPT-2's layout, its merges
    trained on BPE_TRAIN_DOCS of the phase's own texts (as phase 22 builds
    its), `<|endoftext|>` last."""
    from meilisearch_tpu_torch.models.fixtures import GPT2_EOS, gpt2_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P24_SEED)]
    n = SGPT_125M_CONFIG["vocab_size"]
    spec = gpt2_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT + P24_TEXT, n, seed=P24_SEED)
    if len(spec["model"]["vocab"]) != n or spec["model"]["vocab"][GPT2_EOS] != n - 1:
        raise AssertionError("the tokenizer is not laid out as GPT-2's")
    return spec


def bloom_spec() -> dict:
    """The BLOOM variant's seeded P24_BLOOM_PIECES-piece BPE in BLOOM's
    layout (its specials at 0-3, its Split pattern), merges trained on
    P24_BLOOM_TRAIN_DOCS of the phase's texts."""
    from meilisearch_tpu_torch.models.fixtures import BLOOM_HEAD, bloom_tokenizer_json
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(P24_BLOOM_TRAIN_DOCS, seed=P24_SEED)]
    spec = bloom_tokenizer_json(texts + P11_TEXT + P24_TEXT, P24_BLOOM_PIECES, seed=P24_SEED)
    vocab = spec["model"]["vocab"]
    if len(vocab) != P24_BLOOM_PIECES or [vocab[t] for t in BLOOM_HEAD] != [0, 1, 2, 3]:
        raise AssertionError("the tokenizer is not laid out as BLOOM's")
    return spec


def write_p24_checkpoint(path: str, config: dict, seed: int, spec: dict) -> None:
    """A checkpoint of `config` (seeded weights, biases at P24_BIAS_STD),
    written as pytorch_model.bin beside `spec` and its class's
    tokenizer_config.json (GPT2Tokenizer's with `<|endoftext|>` as pad,
    right padding; BloomTokenizerFast's, left; `write_checkpoint`)."""
    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    write_checkpoint(path, config, random_state_dict(config, seed, P24_BIAS_STD),
                     tokenizer_json=spec)


def window_cut(counts: list, window: int) -> tuple:
    """(causal pairs outside a local layer's window, all causal pairs) of
    texts of `counts` real tokens, query i seeing keys i - window + 1 .. i."""
    cut = sum(max(n - window, 0) * (max(n - window, 0) + 1) // 2 for n in counts)
    return cut, sum(n * (n + 1) // 2 for n in counts)


def sgpt_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch
    (`long_check`), after checking that the module is GPT-Neo's with the
    published layer types and window and counting the causal (query, key)
    pairs its local layers cut from them."""
    from meilisearch_tpu_torch.models.gpt_neo import GPTNeoModel, check_config
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    model, c = enc._model, enc._model.config
    types = check_config(SGPT_125M_CONFIG)["layer_types"]  # global, local, ...
    if not isinstance(model, GPTNeoModel) or c["window"] != SGPT_125M_CONFIG["window_size"] \
            or c["layer_types"] != types or types[:2] != ["global", "local"]:
        raise AssertionError(f"{label}: the module is not GPT-Neo's: {type(model).__name__}")
    texts = long_check_texts(P24_SEED)
    _ids, mask, _types = enc.tokenize(list(texts))
    counts = mask.sum(1).tolist()
    cut, total = window_cut(counts, c["window"])
    say(f"{label}: the local layers' window (each query sees itself and the {c['window'] - 1}"
        f" keys before it) cuts {cut} of the {total} causal (query, key) pairs of the long"
        f" texts ({100 * cut / total:.2f}%; texts of {counts} tokens)")
    if cut == 0:
        raise AssertionError(f"{label}: the window does not bite on the long texts")
    return long_check(path, device, f"{label} {len(model.h)} layers", texts=texts)


@contextlib.contextmanager
def padded(enc, side: str):
    """`enc` padding on `side` inside the block (its tokenizer's
    `padding_side`, which tokenizer_config.json sets at load)."""
    before = enc._tokenizer.padding_side
    enc._tokenizer.padding_side = side
    try:
        yield enc
    finally:
        enc._tokenizer.padding_side = before


def sides_check(path: str, device, label: str, texts: tuple = (*LEFT_PAD_TEXT, *P24_TEXT)) -> float:
    """`texts` in one batch padded right and then left, each under forceCls
    and mean pooling, card against CPU (`encoder_check`'s bound); returns
    the largest error. Under left padding GPT-Neo's and GPT-J's positions
    count from the padded start, and forceCls pools a pad's state."""
    import numpy as np

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc, cpu = encoder(path, "useModel", device), cpu_encoder(path)
    enc._load()
    cpu._load()
    errs = {}
    for side in ("right", "left"):
        with padded(enc, side), padded(cpu, side):
            _ids, mask = enc._tokenizer(list(texts), enc.max_len)
            at, real = (-1 if side == "left" else 0), mask.sum(1) > 0  # GPT-2 gives "" no token
            if int(mask[real, at].min()) != 1 or int(mask[:, -1 - at].min()) != 0:
                raise AssertionError(f"{label}: the check batch is not padded {side}")
            for pooling in ("forceCls", "useModel"):
                with pooled(enc, pooling), pooled(cpu, pooling):
                    got, want = enc.encode(list(texts)), cpu.encode(list(texts))
                if not np.isfinite(got).all():
                    raise AssertionError(f"{label}: non-finite {pooling} vectors on the card")
                errs[side, pooling] = float(np.abs(got - want).max())
    say(f"{label} padded right and left ({mask.sum(1).tolist()} tokens in a row of"
        f" {mask.shape[1]}), card against CPU: "
        + ", ".join(f"{side} {pooling} {e:.3e}" for (side, pooling), e in errs.items())
        + f" (bound {ENC_TOL:g})")
    if not max(errs.values()) <= ENC_TOL:
        raise AssertionError(f"{label}: a padded batch is {errs} off the CPU")
    return max(errs.values())


def p24_variants_check(path: str, device, label: str, spec: dict) -> float:
    """P24_VARIANTS' 2-layer checkpoints, each padded right and left under
    both poolings (`sides_check`), card against CPU, after checking that
    each module reads the variant (GPT-J's rotary width and heads, BLOOM's
    heads, width and Split pattern); returns the largest error. The
    earlier encoders are let go after each, and `path`'s is loaded again
    for hf_path."""
    import gc
    import tempfile

    import torch

    from meilisearch_tpu_torch.models import bpe
    from meilisearch_tpu_torch.models.bloom import BloomModel
    from meilisearch_tpu_torch.models.gptj import GPTJModel
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    t0 = time.perf_counter()
    specs = {"gptj": spec, "bloom": bloom_spec()}
    say(f"{label} variants: BLOOM's tokenizer ({P24_BLOOM_PIECES} pieces) built in"
        f" {time.perf_counter() - t0:.3f} s")
    err = 0.0
    for i, (what, config) in enumerate(P24_VARIANTS.items()):
        t = time.perf_counter()
        kind = config["model_type"]
        with tempfile.TemporaryDirectory() as small:
            write_p24_checkpoint(small, config, P24_SEED + 1 + i, specs[kind])
            enc = encoder(small, "useModel", device)
            enc._load()
            model, c, tok = enc._model, enc._model.config, enc._tokenizer
            read = (type(model), c["hidden_size"], c["num_attention_heads"], tok.padding_side)
            if kind == "gptj":
                read += (c["rotary_dim"], model.h[0].attn.rotary)
                want = (GPTJModel, config["n_embd"], config["n_head"], "right",
                        config["rotary_dim"], config["rotary_dim"])
            else:
                read += (tok.split is bpe.split_pattern(bpe.BLOOM_SPLIT),
                         model.word_embeddings.weight.shape[0])
                want = (BloomModel, config["hidden_size"], config["n_head"], "left", True,
                        config["vocab_size"])
            if read != want:
                raise AssertionError(f"{what}: the encoder reads {read}, not {want}")
            err = max(err, sides_check(small, device, f"{label} variant {what}"))
            encoder.cache_clear()
            cpu_encoder.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error {err:.3e} (bound {ENC_TOL:g})")
    encoder(path, "useModel", device)._load()  # hf_path goes on with `path`'s, cached
    return err


def sgpt_phase(device, card: str, n_docs: int) -> dict:
    """Phase 24, hn5k-sgpt125m-hf through its own App (`hf_path`) with the
    long check, both padding sides and P24_VARIANTS inside its checks,
    once the earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 24 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    label = "SGPT-125M-weightedmean-nli-bitfit"
    window = SGPT_125M_CONFIG["window_size"]
    t0 = time.perf_counter()
    spec = sgpt_spec()
    say(f"{label} tokenizer ({len(spec['model']['vocab'])} entries,"
        f" {len(spec['model']['merges'])} merges) built in {time.perf_counter() - t0:.3f} s;"
        f" all {SGPT_125M_CONFIG['num_layers']} layers; at the timed chunk's {ENC_TIMED_TOKENS}"
        f" tokens the {window}-token window cuts"
        f" {window_cut([ENC_TIMED_TOKENS], window)[0]} causal pairs")
    out = hf_path(device, card, n_docs, label=label, index="sgpt",
                  write=lambda path: write_p24_checkpoint(path, SGPT_125M_CONFIG, P24_SEED, spec),
                  seed=P24_SEED, queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P24_TEXT,
                  tokenizer="BPE", model_type="gpt_neo",
                  checks=(sgpt_long_check, sides_check, partial(p24_variants_check, spec=spec)))
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 24 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def p25_spec(qwen: bool = False) -> dict:
    """A seeded 32,000-piece BPE, its merges trained on P25_TRAIN_DOCS of
    the phase's own texts: Llama-2's sentencepiece layout with byte
    fallback (GritLM-8x7B's `LlamaTokenizer`), or Qwen2's byte-level one."""
    from meilisearch_tpu_torch.models import fixtures
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(P25_TRAIN_DOCS, seed=P25_SEED)] + P11_TEXT
    if qwen:
        return fixtures.qwen2_tokenizer_json(texts, P25_PIECES, seed=P25_SEED)
    return fixtures.llama_tokenizer_json(texts, P25_PIECES, seed=P25_SEED)


def write_p25_checkpoint(path: str, config: dict, seed: int, spec: dict) -> None:
    """A checkpoint of `config` with seeded weights (biases at
    P25_BIAS_STD) rounded to BF16 on the card, as the published files hold
    them: GritLM-8x7B's (`MixtralForCausalLM`: `model.` names and an
    untied `lm_head.weight`) as shards of at most P25_SHARD_BYTES and their
    index, the variants' as one model.safetensors; beside `spec` and its
    class's tokenizer_config.json (LlamaTokenizer's, padding left with
    `</s>`; Qwen2Tokenizer's, padding right)."""
    import torch

    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint

    state = random_state_dict(config, seed, P25_BIAS_STD, dtype=torch.bfloat16)
    sharded = config.get("architectures") == ["MixtralForCausalLM"]
    if sharded:
        state = {**{f"model.{k}": v for k, v in state.items()},
                 "lm_head.weight": state["embed_tokens.weight"]}
    write_checkpoint(path, config, state, tokenizer_json=spec,
                     shard_bytes=P25_SHARD_BYTES if sharded else None)


@contextlib.contextmanager
def gate_log(model):
    """Inside the block, each forward of `model` appends (attention mask,
    [gate logits of each sparse block, in layer order]) to the list it
    yields, both as float32 CPU tensors (forward hooks on the gates: the
    module runs as it always does)."""
    from meilisearch_tpu_torch.models.moe import SparseMoeBlock

    records = []
    hooks = [model.register_forward_pre_hook(
        lambda _m, args: records.append((args[1].detach().cpu(), [])))]
    for block in (m for m in model.modules() if isinstance(m, SparseMoeBlock)):
        hooks.append(block.gate.register_forward_hook(
            lambda _m, _args, out: records[-1][1].append(out.detach().float().cpu())))
    try:
        yield records
    finally:
        for h in hooks:
            h.remove()


def _per_text(records: list) -> list:
    """[(mask row, [its (L, experts) logits a sparse layer])], one a text in
    the order encoded."""
    out = []
    for mask, layers in records:
        B, L = mask.shape
        rows = [lg.view(B, L, -1) for lg in layers]
        out.extend((mask[b], [r[b] for r in rows]) for b in range(B))
    return out


def routing_rule(card: list, cpu: list, k: int, label: str) -> dict:
    """The routing rule over one encode's gate logits (`gate_log` records)
    on the card and the CPU: for each text, the positions both devices
    computed (every position where both padded it alike, else its real
    tokens), the sparse layers in order, up to the first where the card's
    top-k experts differ from the CPU's at any position. A difference
    where the CPU's margin between its k-th and (k+1)-th routing weight is
    at least ROUTE_MARGIN raises; a smaller one marks the text (its margin
    kept). Returns {"tokens": positions compared, "flipped": tokens whose
    experts differ, "texts": {text index: smallest margin}}."""
    import torch

    card, cpu = _per_text(card), _per_text(cpu)
    if len(card) != len(cpu):
        raise AssertionError(f"{label}: {len(card)} texts routed on the card, {len(cpu)} on"
                             " the CPU")
    out = {"tokens": 0, "flipped": 0, "texts": {}}
    for t, ((m_card, l_card), (m_cpu, l_cpu)) in enumerate(zip(card, cpu)):
        same = m_card.shape == m_cpu.shape and torch.equal(m_card, m_cpu)
        for layer, (a, b) in enumerate(zip(l_card, l_cpu)):
            if not same:
                a, b = a[m_card.bool()], b[m_cpu.bool()]
            weights = torch.softmax(b, dim=-1)
            top = weights.topk(min(k + 1, weights.shape[-1]), dim=-1)
            want = top.indices[:, :k].sort(dim=-1).values
            got = torch.softmax(a, dim=-1).topk(k, dim=-1).indices.sort(dim=-1).values
            differ = (got != want).any(dim=-1)
            out["tokens"] += int(differ.numel())
            if not bool(differ.any()):
                continue
            margin = (top.values[:, k - 1] - top.values[:, k])[differ]
            out["flipped"] += int(differ.sum())
            if float(margin.max()) >= ROUTE_MARGIN:
                raise AssertionError(
                    f"{label}: text {t} takes other experts on the card in sparse layer {layer} at"
                    f" positions {differ.nonzero().flatten().tolist()[:8]}, where the CPU's margin"
                    f" is {float(margin.max()):.3e} (the rule's bound {ROUTE_MARGIN:g})")
            out["texts"][t] = float(margin.min())
            break  # later layers read the changed states
    return out


def routed_compare(enc, cpu, texts: list, label: str) -> float:
    """`texts` through `enc` (the card) and `cpu` (the same checkpoint on
    the CPU, in chunks of P25_CPU_CHUNK texts), each as its pooling asks,
    under the routing rule: a text whose experts differ at a margin under
    ROUTE_MARGIN is printed with its error and margin and kept out of the
    maximum; every other text is held to ENC_TOL. Returns the maximum over
    the texts held."""
    import numpy as np

    from meilisearch_tpu_torch.models import hf_encoder

    enc._load()
    cpu._load()
    t0 = time.perf_counter()
    with gate_log(enc._model) as on_card:
        got = enc.encode(texts)
    t1 = time.perf_counter()
    chunk, hf_encoder.CHUNK_TEXTS = hf_encoder.CHUNK_TEXTS, P25_CPU_CHUNK
    try:
        with gate_log(cpu._model) as on_cpu:
            want = cpu.encode(texts)
    finally:
        hf_encoder.CHUNK_TEXTS = chunk
    t2 = time.perf_counter()
    rule = routing_rule(on_card, on_cpu, enc._model.config["num_experts_per_tok"], label)
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite vectors on the card")
    errs = np.abs(got - want).max(axis=1)
    held = [e for t, e in enumerate(errs) if t not in rule["texts"]]
    for t, margin in rule["texts"].items():
        say(f"{label}: text {t} ({len(texts[t])} characters) takes other experts on the card at"
            f" a CPU margin of {margin:.3e} (< {ROUTE_MARGIN:g}); its error {errs[t]:.3e} is not"
            " held to ENC_TOL")
    err = float(max(held)) if held else 0.0
    say(f"{label} routing: {rule['tokens']} (token, sparse layer) pairs compared, {rule['flipped']}"
        f" with other experts on the card, {len(rule['texts'])} of {len(texts)} texts left out;"
        f" max abs error {err:.3e} over the {len(held)} held (bound {ENC_TOL:g}); card"
        f" {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")
    if not err <= ENC_TOL:
        raise AssertionError(f"{label}: the encoder on the card is {err:.3e} off the CPU")
    return err


def routed_check(path: str, device, texts: list, width: str) -> float:
    """`encoder_check` under the routing rule (`routed_compare`), mean
    pooling."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    t0 = time.perf_counter()
    enc, cpu = encoder(path, "useModel", device), cpu_encoder(path)
    enc._load()
    cpu._load()
    say(f"encoder check: {len(texts)} texts at {width} width (both encoders loaded in"
        f" {time.perf_counter() - t0:.3f} s)")
    return routed_compare(enc, cpu, texts, f"{width}, card against CPU")


def routed_sides_check(path: str, device, label: str,
                       texts: tuple = (*LEFT_PAD_TEXT, *P25_TEXT)) -> float:
    """`texts` in one batch padded right and then left, each under forceCls
    and mean pooling, card against CPU under the routing rule; returns the
    largest error held. Under left padding forceCls pools a pad's state
    (Qwen2-MoE's: the uniform average its additive mask gives)."""
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc, cpu = encoder(path, "useModel", device), cpu_encoder(path)
    enc._load()
    cpu._load()
    err = 0.0
    for side in ("right", "left"):
        with padded(enc, side), padded(cpu, side):
            _ids, mask = enc._tokenizer(list(texts), enc.max_len)
            at, real = (-1 if side == "left" else 0), mask.sum(1) > 0  # Qwen2 gives "" no token
            if int(mask[real, at].min()) != 1 or int(mask[:, -1 - at].min()) != 0:
                raise AssertionError(f"{label}: the check batch is not padded {side}")
            for pooling in ("forceCls", "useModel"):
                with pooled(enc, pooling), pooled(cpu, pooling):
                    err = max(err, routed_compare(
                        enc, cpu, list(texts), f"{label} padded {side}, {pooling} ({mask.shape[1]}"
                        " tokens a row)"))
    return err


def moe_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch under
    the routing rule, after checking that the module runs Mixtral's sparse
    block in every layer (8 experts, top 2, renormalized) over Mistral's
    attention with no window, and that the shards were read."""
    from meilisearch_tpu_torch.models.decoder import DecoderModel
    from meilisearch_tpu_torch.models.hf_encoder import encoder
    from meilisearch_tpu_torch.models.moe import SparseMoeBlock

    enc = encoder(path, "useModel", device)
    enc._load()
    model, c = enc._model, enc._model.config
    blocks = [layer.block_sparse_moe for layer in model.layers]
    read = (type(model), c["window"], enc._tokenizer.padding_side,
            [(len(b.experts), b.top_k, b.normalize, b.shared) for b in blocks])
    want = (DecoderModel, None, "left", [(8, 2, True, False)] * len(model.layers))
    if read != want or not all(isinstance(b, SparseMoeBlock) for b in blocks):
        raise AssertionError(f"{label}: the encoder reads {read}, not {want}")
    texts = list(long_check_texts(P25_SEED))
    _ids, mask, _types = enc.tokenize(texts)
    say(f"{label} {len(model.layers)} layers long check texts: {mask.sum(1).tolist()} tokens"
        f" in a row of {mask.shape[1]}")
    return routed_compare(enc, cpu_encoder(path), texts,
                          f"{label} {len(model.layers)} layers (long texts, one batch)")


def p25_variants_check(device, label: str) -> float:
    """P25_VARIANTS' 2-layer checkpoints over a seeded Qwen2 BPE, each
    padded right and left under both poolings (`routed_sides_check`), card
    against CPU under the routing rule, after checking that each module
    reads the variant (experts, top-k, renormalization, the shared expert,
    Q/K norms, biases); returns the largest error. The encoders are let go
    after each."""
    import gc
    import tempfile

    import torch

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    t0 = time.perf_counter()
    spec = p25_spec(qwen=True)
    say(f"{label} variants' tokenizer ({len(spec['model']['vocab'])} entries, Qwen2's layout)"
        f" built in {time.perf_counter() - t0:.3f} s")
    err = 0.0
    for i, (what, config) in enumerate(P25_VARIANTS.items()):
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as small:
            write_p25_checkpoint(small, config, P25_SEED + 1 + i, spec)
            t_write = time.perf_counter() - t
            enc = encoder(small, "useModel", device)
            enc._load()
            t_card = time.perf_counter() - t - t_write
            cpu_encoder(small)._load()
            say(f"{label} variant {what}: written in {t_write:.3f} s, loaded on the card in"
                f" {t_card:.3f} s, on the CPU in {time.perf_counter() - t - t_write - t_card:.3f} s")
            layer = enc._model.layers[0]
            block, attn = layer.mlp, layer.self_attn
            read = (len(block.experts), block.top_k, block.normalize, block.shared,
                    attn.qk_norm, attn.q_proj.bias is not None, attn.o_proj.bias is not None,
                    attn.zero_unseen, enc._tokenizer.padding_side)
            qwen2 = config["model_type"] == "qwen2_moe"
            want = (config["num_experts"], config["num_experts_per_tok"], not qwen2, qwen2,
                    not qwen2, qwen2, False, not qwen2, "right")
            if read != want:
                raise AssertionError(f"{what}: the encoder reads {read}, not {want}")
            err = max(err, routed_sides_check(small, device, f"{label} variant {what}"))
            encoder.cache_clear()
            cpu_encoder.cache_clear()
            gc.collect()
            torch.cuda.empty_cache()
        say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s")
    say(f"{label} variants: largest error held {err:.3e} (bound {ENC_TOL:g})")
    return err


@contextlib.contextmanager
def timed_reads(seconds: list):
    """Inside the block, each checkpoint's weight read (`read_weights`:
    every shard read and widened) appends its wall seconds to `seconds`."""
    from meilisearch_tpu_torch.models import checkpoint

    read = checkpoint.read_weights

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return read(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t)

    checkpoint.read_weights = timed
    try:
        yield seconds
    finally:
        checkpoint.read_weights = read


def moe_phase(device, card: str, n_docs: int) -> dict:
    """Phase 25, hn5k-gritlm8x7b-hf: P25_VARIANTS' checks first, then
    GritLM-8x7B's 2 layers from BF16 shards through its own App
    (`hf_path`, its checks under the routing rule: the 83 texts, the long
    batch, both padding sides under both poolings), once the earlier
    phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 25 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    label = "GritLM-8x7B"
    variants_err = p25_variants_check(device, label)
    t0 = time.perf_counter()
    spec = p25_spec()
    say(f"{label} tokenizer ({len(spec['model']['vocab'])} pieces, Llama-2's layout) built in"
        f" {time.perf_counter() - t0:.3f} s; {GRITLM_8X7B_CONFIG['num_hidden_layers']} of its"
        f" {GRITLM_PUBLISHED_LAYERS} layers")

    def write(path):
        import os

        write_p25_checkpoint(path, GRITLM_8X7B_CONFIG, P25_SEED, spec)
        shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        size = sum(os.path.getsize(os.path.join(path, f)) for f in shards)
        say(f"{label} weights: {len(shards)} BF16 shards and model.safetensors.index.json,"
            f" {size / 1e9:.3f} GB")
        if len(shards) < 2 or not os.path.exists(os.path.join(path,
                                                                "model.safetensors.index.json")):
            raise AssertionError(f"{label}: the weights are not sharded: {shards}")

    reads = []
    with timed_reads(reads):
        out = hf_path(device, card, n_docs, label=label, index="gm8", write=write, seed=P25_SEED,
                      queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P25_TEXT, tokenizer="BPE",
                      model_type="mixtral", check=routed_check,
                      checks=(moe_long_check, routed_sides_check))
    say(f"{label} shards read and widened to float32: "
        + ", ".join(f"{x:.3f} s" for x in reads) + " (card, then CPU)")
    out["err"] = max(out["err"], variants_err)
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 25 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def bmretriever_spec() -> dict:
    """Phase 26's 50,277-entry byte-level BPE in GPT-NeoX-20B's layout
    (`<|endoftext|>` and `<|padding|>` at 0 and 1, the space runs from
    50,254), its merges trained on BPE_TRAIN_DOCS of the phase's own texts."""
    from meilisearch_tpu_torch.models.fixtures import (
        GPT_NEOX_ADDED,
        GPT_NEOX_HEAD,
        gpt_neox_tokenizer_json,
    )
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    searchable = set(VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(BPE_TRAIN_DOCS, seed=P26_SEED)]
    spec = gpt_neox_tokenizer_json(texts + P11_TEXT + P11_CHECK_TEXT + P24_TEXT + P26_TEXT,
                                   P26_PIECES, seed=P26_SEED)
    vocab = spec["model"]["vocab"]
    if len(vocab) != P26_PIECES or [vocab[t] for t in GPT_NEOX_HEAD] != [0, 1] \
            or vocab[GPT_NEOX_ADDED[0]] != P26_PIECES - len(GPT_NEOX_ADDED):
        raise AssertionError("the tokenizer is not laid out as GPT-NeoX-20B's")
    return spec


def write_p26_checkpoint(path: str, config: dict, seed: int, spec: dict) -> int:
    """A checkpoint of `config` as GPTNeoXForCausalLM's pytorch_model.bin:
    the module's seeded weights (biases at P26_BIAS_STD) under `gpt_neox.`,
    a seeded `embed_out.weight`, and each layer's stale
    `attention.bias` (the causal table over max_position_embeddings),
    `attention.masked_bias` and `attention.rotary_emb.inv_freq`, beside
    `spec` and GPTNeoXTokenizer's tokenizer_config.json (`<|padding|>` its
    pad, right padding; `write_checkpoint`). Returns the tensors the
    port's mapping must drop."""
    import torch

    from meilisearch_tpu_torch.models.checkpoint import write_checkpoint
    from meilisearch_tpu_torch.models.gpt_neox import check_config

    rotary = check_config(config)["rotary_dim"]
    state = {f"gpt_neox.{k}": v for k, v in random_state_dict(config, seed, P26_BIAS_STD).items()}
    g = torch.Generator().manual_seed(seed + 1)
    state["embed_out.weight"] = torch.randn((config["vocab_size"], config["hidden_size"]),
                                            generator=g) * BGE_INIT_STD
    n = config["max_position_embeddings"]
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool)).view(1, 1, n, n)
    inv_freq = 1.0 / (config["rotary_emb_base"]
                      ** (torch.arange(0, rotary, 2, dtype=torch.int64).float() / rotary))
    for i in range(config["num_hidden_layers"]):
        at = f"gpt_neox.layers.{i}.attention."
        state[at + "bias"] = causal
        state[at + "masked_bias"] = torch.tensor(-1e9)
        state[at + "rotary_emb.inv_freq"] = inv_freq
    write_checkpoint(path, config, state, tokenizer_json=spec)
    return 1 + 3 * config["num_hidden_layers"]


def p26_widths(config: dict) -> tuple:
    """(heads, head width, rotated channels) of a GPT-NeoX config, as
    GPTNeoXAttention takes them (`int(head_size * rotary_pct)`)."""
    heads = config["num_attention_heads"]
    head = config["hidden_size"] // heads
    return heads, head, int(head * config["rotary_pct"])


def p26_long_check(path: str, device, label: str) -> float:
    """The phase's checkpoint on phase 13's long texts in one batch
    (`long_check`), after checking that the module reads the published
    widths: GPT-NeoX's, heads of 64 with 16 rotated channels, the parallel
    residual, a 3,072-wide fused QKV, all 24 layers."""
    from meilisearch_tpu_torch.models.gpt_neox import GPTNeoXModel
    from meilisearch_tpu_torch.models.hf_encoder import encoder

    enc = encoder(path, "useModel", device)
    enc._load()
    model, c = enc._model, enc._model.config
    read = (type(model), c["head_dim"], c["rotary_dim"], c["use_parallel_residual"],
            model.layers[0].attention.query_key_value.out_features, len(model.layers))
    want = (GPTNeoXModel, *p26_widths(BMRETRIEVER_410M_CONFIG)[1:3], True,
            3 * BMRETRIEVER_410M_CONFIG["hidden_size"],
            BMRETRIEVER_410M_CONFIG["num_hidden_layers"])
    if read != want:
        raise AssertionError(f"{label}: the encoder reads {read}, not {want}")
    return long_check(path, device, f"{label} {len(model.layers)} layers",
                      texts=long_check_texts(P26_SEED))


def p26_variant_check(path: str, device, label: str, spec: dict) -> float:
    """P26_VARIANT's 2-layer checkpoint padded right and left under both
    poolings (`sides_check`), card against CPU, after checking that the
    module reads its widths; returns the largest error. Its encoders are
    let go after, and `path`'s is loaded again for hf_path."""
    import gc
    import tempfile

    import torch

    from meilisearch_tpu_torch.models.hf_encoder import encoder

    t = time.perf_counter()
    what, config = P26_VARIANT
    with tempfile.TemporaryDirectory() as small:
        write_p26_checkpoint(small, config, P26_SEED + 1, spec)
        enc = encoder(small, "useModel", device)
        enc._load()
        c = enc._model.config
        read = (c["num_attention_heads"], c["head_dim"], c["rotary_dim"], c["hidden_size"],
                c["intermediate_size"], len(enc._model.layers))
        want = (*p26_widths(config), config["hidden_size"], config["intermediate_size"],
                config["num_hidden_layers"])
        if read != want:
            raise AssertionError(f"{what}: the encoder reads {read}, not {want}")
        err = sides_check(small, device, f"{label} variant {what}", texts=P26_SIDES_TEXT)
        encoder.cache_clear()
        cpu_encoder.cache_clear()
        gc.collect()
        torch.cuda.empty_cache()
    say(f"{label} variant {what}: {time.perf_counter() - t:.3f} s, largest error {err:.3e}"
        f" (bound {ENC_TOL:g})")
    encoder(path, "useModel", device)._load()  # hf_path goes on with `path`'s, cached
    return err


def bmretriever_phase(device, card: str, n_docs: int) -> dict:
    """Phase 26, hn5k-bmretriever410m-hf through its own App (`hf_path`)
    with the long check, both padding sides and P26_VARIANT inside its
    checks, once the earlier phases' encoders are let go."""
    import gc

    import torch

    from meilisearch_tpu_torch.models import hf_encoder

    t_phase = time.perf_counter()
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 26 starts with {torch.cuda.memory_allocated(device) / 2**30:.3f} GiB allocated"
        " on the card")
    label = "BMRetriever-410M"
    t0 = time.perf_counter()
    spec = bmretriever_spec()
    dropped = []

    def write(path):
        dropped.append(write_p26_checkpoint(path, BMRETRIEVER_410M_CONFIG, P26_SEED, spec))

    say(f"{label} tokenizer ({len(spec['model']['vocab'])} entries,"
        f" {len(spec['model']['merges'])} merges) built in {time.perf_counter() - t0:.3f} s;"
        f" all {BMRETRIEVER_410M_CONFIG['num_hidden_layers']} layers")
    out = hf_path(device, card, n_docs, label=label, index="bmr", write=write, seed=P26_SEED,
                  queries=P11_TEXT, check_texts=P11_CHECK_TEXT + P24_TEXT + P26_TEXT,
                  tokenizer="BPE", model_type="gpt_neox",
                  checks=(p26_long_check, partial(sides_check, texts=P26_SIDES_TEXT),
                          partial(p26_variant_check, spec=spec)))
    say(f"{label}: the GPTNeoXForCausalLM file's {dropped[0]} tensors outside GPTNeoXModel"
        " (`embed_out` and the stale causal buffers) dropped at load on both devices")
    hf_encoder.encoder.cache_clear()
    cpu_encoder.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 26 wall: {time.perf_counter() - t_phase:.3f} s")
    return out


def encoder_flops(model, n: int, L: int) -> float:
    """The float32 operations of one forward over n texts of L tokens: the
    Linear and Conv1d layers and XLNet's token projections (ALBERT's
    shared ones once for each pass that runs them), QK^T and PV (over
    heads x head_dim, wider than the model in Qwen3; over MobileBERT's
    true_hidden_size, narrower), the relative keys' einsum(Q, pos) (and
    einsum(K, pos)), for DeBERTa-v2 the c2p and p2c products against the
    (2 span)-row relative embeddings and those embeddings' projections,
    for XLNet its position keys (`r` over the 2L rows of the position
    table, once a forward) and scores (the embeddings, MPNet's bias table
    and the bucket and distance gathers are gathers, not products); of a
    sparse MoE block, the gate, the num_experts_per_tok experts each token
    runs and the shared expert (`routed_weights`), never the experts it
    is not routed to."""
    from meilisearch_tpu_torch.models.albert import AlbertModel
    from meilisearch_tpu_torch.models.bert import RELATIVE_KEYS
    from meilisearch_tpu_torch.models.deberta_v2 import DebertaV2Model, attention_span
    from meilisearch_tpu_torch.models.mobilebert import MobileBertModel
    from meilisearch_tpu_torch.models.xlnet import XLNetModel

    c = model.config
    h, layers = c["hidden_size"], c["num_hidden_layers"]
    width = c["num_attention_heads"] * c["head_dim"] if c.get("head_dim") else h
    if isinstance(model, MobileBertModel):
        width = c["true_hidden_size"]
    linear = routed_weights(model)
    if isinstance(model, XLNetModel):  # `r` is charged below, on 2L rows
        linear -= sum(layer.rel_attn.r.numel() for layer in model.layer)
    if isinstance(model, AlbertModel):
        passes = model.passes()
        layers = len(passes)
        linear = (projection_weights(model.embeddings_project)
                  + sum(projection_weights(p) for p in passes))
    flops = 2 * linear * n * L + 4 * L * L * width * layers * n
    if c.get("position_embedding_type") in RELATIVE_KEYS:
        kinds = 1 + (c["position_embedding_type"] == "relative_key_query")
        flops += 2 * L * L * width * layers * n * kinds
    if isinstance(model, DebertaV2Model) and c["relative_attention"]:
        span, kinds = attention_span(c), len(set(c["pos_att_type"]))
        flops += layers * kinds * (4 * L * span * h * n + 4 * span * h * h)
    if isinstance(model, XLNetModel):
        # the position keys over 2L rows, once a forward, and the position
        # scores against them, before rel_shift
        flops += layers * (2 * 2 * L * h * h + 2 * L * 2 * L * width * n)
    return flops


def projection_weights(module) -> int:
    """The weights of `module`'s Linear and Conv1d layers and XLNet's
    einsum projections (`q`, `k`, `v`, `o`, `r`); Longformer's `*_global`
    projections are not counted: no token is global, so no forward reads
    them."""
    from torch import nn

    from meilisearch_tpu_torch.models.longformer import LongformerModel
    from meilisearch_tpu_torch.models.xlnet import XLNetModel

    n = sum(m.weight.numel() for m in module.modules() if isinstance(m, (nn.Linear, nn.Conv1d)))
    if isinstance(module, LongformerModel):
        n -= sum(getattr(layer.attention.self, f"{w}_global").weight.numel()
                 for layer in module.encoder.layer for w in ("query", "key", "value"))
    if isinstance(module, XLNetModel):
        n += sum(getattr(layer.rel_attn, w).numel() for layer in module.layer
                 for w in ("q", "k", "v", "o", "r"))
    return n


def routed_weights(model, hit: list | None = None) -> int:
    """`projection_weights` as one token reads them: of each sparse MoE
    block, the gate, the shared expert and num_experts_per_tok experts
    (`hit`: the count of distinct experts each block's tokens ran, in
    layer order, for a forward's weight reads)."""
    from meilisearch_tpu_torch.models.moe import SparseMoeBlock

    n = projection_weights(model)
    blocks = [m for m in model.modules() if isinstance(m, SparseMoeBlock)]
    for i, block in enumerate(blocks):
        runs = block.top_k if hit is None else hit[i]
        n -= (len(block.experts) - runs) * projection_weights(block.experts[0])
    return n


def experts_hit(enc, ids, mask, types) -> list:
    """The distinct experts each sparse block of `enc`'s model runs in one
    forward of (ids, mask), from its gates' logits (`gate_log`)."""
    import torch

    with gate_log(enc._model) as records:
        enc.forward(ids, mask, types)
    k = enc._model.config["num_experts_per_tok"]
    (_mask, layers), = records
    return [int(torch.softmax(lg, -1).topk(k, -1).indices.unique().numel()) for lg in layers]


def encoder_timing(enc, device, card: str, width: str = "bge-base") -> dict:
    """(f) One query's forward (1 text, about 16 tokens) and one indexing
    chunk (chunk_texts() texts of ENC_TIMED_TOKENS tokens): device time by
    CUDA events, median of REPEATS; the query's kernels and launches; the
    chunk's TFLOP/s against the float32 bound."""
    import torch

    query = "rust compiler performance benchmark for machine learning on gpu"
    ids, mask, types = enc.tokenize([query])
    q_ms = _median_ms(lambda: enc.forward(ids, mask, types), reps=REPEATS)
    _kernel_ms, launches = leg_breakdown(f"one query's forward ({ids.shape[1]} tokens)",
                                         lambda: enc.forward(ids, mask, types), device)
    # a query reads every Linear (Conv1d, XLNet projection) weight once
    # (float32), of a sparse block the experts its tokens hit
    hit = None
    if "num_experts_per_tok" in enc._model.config:
        hit = experts_hit(enc, ids, mask, types)
        say(f"  one query's forward ({ids.shape[1]} tokens) runs {hit} experts of its sparse"
            " layers")
    linear = routed_weights(enc._model, hit) if hit is not None else projection_weights(enc._model)
    q_bound_ms = max(4 * linear / HBM_BYTES_S,
                     encoder_flops(enc._model, 1, ids.shape[1]) / FP32_FLOP_S) * 1e3
    c = enc._model.config
    n, L = enc.chunk_texts(), ENC_TIMED_TOKENS
    g = torch.Generator().manual_seed(ENC_SEED)
    cids = torch.randint(1000, c["vocab_size"], (n, L), generator=g)
    cmask = torch.ones((n, L), dtype=torch.int64)
    ctypes = None if types is None else torch.zeros_like(cids)
    chunk_ms = _median_ms(lambda: enc.forward(cids, cmask, ctypes), reps=REPEATS)
    flops = encoder_flops(enc._model, n, L)
    bound_ms = flops / FP32_FLOP_S * 1e3
    say(f"timing the {width}-width encoder on {card}: one query's forward ({ids.shape[1]}"
        f" tokens) {q_ms:.4f} ms"
        f" (CUDA events, median of {REPEATS}), {launches:.0f} launches, bound"
        f" {q_bound_ms:.4f} ms ({4 * linear / 1e9:.3f} GB of Linear weights over"
        f" {HBM_BYTES_S / 1e12:.2f} TB/s); one indexing chunk"
        f" ({n} texts x {L} tokens) {chunk_ms:.4f} ms, {flops / chunk_ms / 1e9:.2f} TFLOP/s,"
        f" bound {bound_ms:.4f} ms ({flops / 1e12:.3f} TFLOP over {FP32_FLOP_S / 1e12:.0f}"
        f" TFLOP/s float32), {bound_ms / chunk_ms:.2f} of the bound")
    return {"query_ms": q_ms, "query_launches": launches, "query_bound_ms": q_bound_ms,
            "chunk_ms": chunk_ms, "chunk_bound_ms": bound_ms}


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_bound_ms(args, T: int) -> tuple[float, str]:
    """The least time K1 could take on these inputs: the larger of the
    bytes it must move (each distinct pool row named, the bitmaps and the
    small inputs read once; keys, bitmap and counts written once) over
    the HBM rate, and its integer operations over the int32 rate. The
    operation count is per (query, document) pair, counting fused
    instructions (IADD3, LOP3, byte extract, min) in csrc/chain_keys.cu:
    about 35 for t = 0, 75 for each later term, 3 per ExactAttribute
    level and 4 for the masks."""
    import torch

    byte_pool, rows, adj, mand, use_valid, universe, live = args
    B, D = rows.shape[0], byte_pool.shape[1] * 4
    n_rows = int(torch.unique(rows).numel())
    small = sum(int(x.numel()) * 4 for x in (rows, adj, mand, use_valid))
    moved = n_rows * D + 4 * (universe.numel() + live.numel()) + small
    moved += B * D * 4 + B * (D // 32) * 4 + B * 4
    ops = (35 + 75 * (T - 1) + 3 * (T + 1) + 4) * B * D
    return max(moved / HBM_BYTES_S, ops / INT32_OPS_S) * 1e3, (
        "bytes" if moved / HBM_BYTES_S > ops / INT32_OPS_S else "operations"
    )


def k3_bound_ms(lens, m: int, max_dist: int) -> tuple[float, str]:
    """The least time K3 could take for one query word of `m` letters over
    a vocabulary of these lengths (numpy; 0 = padding row): the larger of
    the bytes the function must move over the HBM rate and its integer
    operations over the int32 rate. Every OSA distance is at least the
    length difference, D[m][j] >= |m - j|, and the outputs are clipped at
    max_dist + 1. Bytes: the 4-byte length of every row; for a word of
    len >= m - max_dist, the 32-byte sectors that hold its letters
    j < min(len, m + max_dist) (none at m = 0, where the outputs follow
    from the length); the two int8 outputs. Operations: the cheaper of
    8 per DP cell of the band |i - j| <= max_dist + 1 (a cell off it is
    above the clip), min(len, i + max_dist + 1) - max(1, i - max_dist - 1)
    + 1 cells for query row i, and OSA_OPS_PER_LETTER per letter read, the
    bit-vector recurrence's instructions in csrc/osa.cu."""
    import numpy as np

    counts = np.bincount(np.asarray(lens, np.int64), minlength=33)
    length = np.arange(len(counts))
    if m == 0:
        needed = np.zeros_like(length)
    else:
        needed = np.where(length >= max(m - max_dist, 1), np.minimum(length, m + max_dist), 0)
    n = len(lens)
    moved = 4 * n + 32 * int((counts * ((needed + 7) // 8)).sum()) + 2 * n
    cells = 0
    for i in range(1, m + 1):
        hi = np.minimum(length, i + max_dist + 1)
        cells += int((counts * np.maximum(hi - max(1, i - max_dist - 1) + 1, 0)).sum())
    ops = min(8 * cells, OSA_OPS_PER_LETTER * int((counts * needed).sum()))
    t_bytes, t_ops = moved / HBM_BYTES_S, ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def timing_phase(device, card: str, typo: dict, vector: dict) -> dict:
    from meilisearch_tpu_torch.ops.chain_keys import chain_keys, chain_keys_torch
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs

    out = {}
    args = kernel_args(scorer_inputs(3, 1 << 20, 32, seed=7), device)
    # plain, kernel, kernel, plain: both sides see the same card state
    plain = [_median_ms(lambda: chain_keys_torch(*args, T=3), reps=5)]
    events = _median_ms(lambda: chain_keys(*args, T=3), reps=30)
    k1 = repeated_launch_ms(K1_KERNEL, lambda: chain_keys(*args, T=3), device)
    plain.append(_median_ms(lambda: chain_keys_torch(*args, T=3), reps=5))
    bound, by = k1_bound_ms(args, 3)
    out["chain_keys"] = {"ms": k1["cold_ms"], "plain_ms": statistics.median(plain),
                         "bound_ms": bound, "bound_by": by}
    say(f"timing D=2^20 B=32 T=3 on {card}: K1 per launch (trace, median of"
        f" {REPEATS} repeats of 10) cold {k1['cold_ms']:.4f} ms (repeats"
        f" {_spread(k1['cold'])}), warm {k1['warm_ms']:.4f} ms (repeats"
        f" {_spread(k1['warm'])}); wrapper back to back (CUDA events, median of 30)"
        f" {events:.4f} ms; chain_keys_torch {out['chain_keys']['plain_ms']:.4f} ms"
        f" (runs {plain}); bound {bound:.4f} ms ({by}); cold"
        f" {bound / k1['cold_ms']:.2f} of the bound")
    del args
    out["osa"] = osa_timing(card, typo)
    out["hamming"] = vector_timing(card, vector)
    return out


def k4h_bound_ms(n: int, w: int, n_live: int | None = None) -> tuple[float, str]:
    """The least time K4h could take on an (n, w) matrix: the larger of
    the bytes it must move over the HBM rate and its population counts
    over the card's POPC rate (the XORs and adds go to other units at a
    higher rate). Mode ham (n_live None): the matrix and the query read
    once, n int32 distances written once. Mode keyed: only the first
    n_live rows read (the pad rows' outputs do not depend on the matrix),
    n float32 cosines and n int64 keys written once."""
    n_read, out_bytes = (n, 4) if n_live is None else (n_live, 12)
    moved = n_read * w * 4 + w * 4 + n * out_bytes
    t_bytes, t_ops = moved / HBM_BYTES_S, n_read * w / POPC_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def float_leg_bound_ms(n: int, dim: int, kb: int) -> tuple[float, str]:
    """The least time the float leg could take: the matrix, the norms and
    the query read once and the kb (value, index) pairs written once, over
    the HBM rate; its 2 * n * dim float32 operations over the card's
    float32 rate outside the tensor cores."""
    moved = n * dim * 4 + n * 4 + dim * 4 + kb * 12
    t_bytes, t_ops = moved / HBM_BYTES_S, 2 * n * dim / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def leg_breakdown(label: str, call, device, reps: int = 10) -> tuple[float, float]:
    """Print the device time per call of each kernel that `call` launches
    (torch.profiler, `reps` calls back to back), their sum and the
    launches per call; return the last two. Only the kernels count: a
    torch op's entry repeats its kernels' device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize(device)
    # the device's activity alone: the kernels' times and counts are the
    # same as with the host's ops recorded too, at a fraction of the
    # trace's cost (on an H100, 0.6-1.0 s against 2.6 s for ten queries of
    # bge-base's width)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows = sorted(((e.self_device_time_total / reps / 1e3, e.key) for e in kernels), reverse=True)
    launches = sum(e.count for e in kernels) / reps
    total = sum(ms for ms, _ in rows)
    say(f"  {label}: device time per call {total:.4f} ms in {len(rows)} kernels,"
        f" {launches:.1f} launches; " + "; ".join(f"{ms:.4f} {name[:60]}" for ms, name in rows[:6]))
    return total, launches


def vector_timing(card: str, vector: dict) -> dict:
    """K4h on the vector path's resident sign words (n = 2^18, W = 24), in
    each mode (ham over every row; keyed with the path's n_live rows
    live): equal to its plain version, then plain, kernel (traced per
    launch, cold and warm, REPEATS repeats), plain; each mode's bound. The
    float leg on the resident float matrix: its device work (CUDA events
    around `_device_topk_dispatch`), its torch.matmul alone (the library
    call), its bound. Both legs' kernels and launches per call, and their
    whole search_async call and numpy host passes on the host clock.
    Returns the kernels line's numbers: the keyed mode's, the one the
    binary leg's top-k launches."""
    import numpy as np
    import torch

    from meilisearch_tpu_torch.ops import hamming
    from meilisearch_tpu_torch.vector.store import _device_topk_dispatch, _pack_signs

    binary, floating, q = vector["binary"], vector["float"], vector["query"]
    dev = binary.device
    m_dev, n = binary._device[("matrix", dev)]
    n_pad, w = m_dev.shape
    qd = torch.from_numpy(_pack_signs(q[None, :])[0].view(np.int32)).to(dev)
    modes = {
        "ham": (lambda: hamming.hamming_rows(m_dev, qd),
                lambda: hamming.hamming_rows_torch(m_dev, qd), k4h_bound_ms(n_pad, w)),
        "keyed": (lambda: hamming.hamming_keyed(m_dev, qd, binary.dim, n),
                  lambda: hamming.hamming_keyed_torch(m_dev, qd, binary.dim, n),
                  k4h_bound_ms(n_pad, w, n)),
    }
    lines = {}
    for mode, (call, plain_call, (bound, by)) in modes.items():
        got = call()
        torch.cuda.synchronize()
        err = k4h_err(got, plain_call(), f"{mode} on the resident sign words")
        plain = [_median_ms(plain_call, reps=5)]
        k4 = repeated_launch_ms(K4H_KERNEL, call, dev)
        plain.append(_median_ms(plain_call, reps=5))
        say(f"timing K4h {mode} n={n_pad} n_live={n} W={w} on {card}: per launch (trace,"
            f" median of {REPEATS} repeats of 10) cold {k4['cold_ms']:.4f} ms (repeats"
            f" {_spread(k4['cold'])}), warm {k4['warm_ms']:.4f} ms (repeats"
            f" {_spread(k4['warm'])}); plain version {statistics.median(plain):.4f} ms (runs"
            f" {plain}); bound {bound:.4f} ms ({by}); cold {bound / k4['cold_ms']:.2f}, warm"
            f" {bound / k4['warm_ms']:.2f} of the bound; equal")
        lines[mode] = {"ms": k4["cold_ms"], "plain_ms": statistics.median(plain),
                       "bound_ms": bound, "bound_by": by, "max_abs_err": err}

    k = 30  # offset + limit of the path's paged requests
    fm, fn = floating._device[("matrix", dev)]
    qf = torch.from_numpy(q).to(dev)
    lib = _median_ms(lambda: torch.matmul(fm, qf), reps=20)
    leg = _median_ms(lambda: _device_topk_dispatch(floating, q, k), reps=20)
    bin_leg = _median_ms(lambda: _device_topk_dispatch(binary, q, k), reps=20)
    kb = 1 << (4 * k - 1).bit_length()
    fbound, fby = float_leg_bound_ms(fm.shape[0], fm.shape[1], kb)
    whole = {}
    for name, searcher in (("float", floating), ("binary", binary)):
        host = copy.copy(searcher)
        host.device = None  # the numpy pass over the same matrix
        for side, s in ((name, searcher), (name + " host", host)):
            times = []
            for _ in range(20 if side == name else 5):
                t0 = time.perf_counter()
                s.search_async(q, k)()
                times.append((time.perf_counter() - t0) * 1e3)
            whole[side] = statistics.median(times)
    for name, searcher in (("float", floating), ("binary", binary)):
        leg_breakdown(f"the {name} leg", lambda s=searcher: _device_topk_dispatch(s, q, k), dev)
    say(f"timing float leg n={fm.shape[0]} dim={fm.shape[1]} k={k} (kb={kb}) on {card}:"
        f" device work (CUDA events around _device_topk_dispatch, median of 20)"
        f" {leg:.4f} ms; torch.matmul alone {lib:.4f} ms; bound {fbound:.4f} ms ({fby});"
        f" the binary leg's device work {bin_leg:.4f} ms")
    say(f"timing search_async(q, {k})() on {card}, host clock, medians: float"
        f" {whole['float']:.3f} ms, binary {whole['binary']:.3f} ms; numpy host pass:"
        f" float {whole['float host']:.3f} ms, binary {whole['binary host']:.3f} ms")
    return lines["keyed"]


def warp_lengths(lens) -> str:
    """The word lengths K3's warps see: the mean length of the real rows,
    and the mean over warps (32 consecutive rows, one thread each) of the
    longest, the length every lane of the warp runs its DP rows to."""
    import numpy as np

    lens = np.asarray(lens)
    longest = lens[: len(lens) // 32 * 32].reshape(-1, 32).max(axis=1)
    return (f"mean word length {lens[lens > 0].mean():.3f}, mean longest per"
            f" warp {longest.mean():.3f}")


def launch_ms(kernel: str, runs: list, device, per_call: int = 1) -> list:
    """A kernel's device time per call, from torch.profiler's CUDA trace:
    for each (call, reps, cold) of `runs`, in order, `reps` calls of
    `call`, each of which must launch the kernel whose traced name holds
    `kernel` `per_call` times, and each after a write of L2_FLUSH_BYTES
    when `cold` (so the kernel finds the L2 cache as a call between
    searches finds it); returns, per run, the ms of each call's launches
    summed. The trace may miss a
    session's first launches (a 10 us kernel lost 2 of 100 on the card;
    in the whole script's later sessions K1 lost 11-15, K3 10-12 and K4h
    21-26, whether or not the session first waited 0.25 s), so SENTINELS
    calls open it, the first followed by a wait of TRACE_SETTLE_S, and the
    runs take the last launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    runs[0][0]()  # untraced warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # as leg_breakdown
        runs[0][0]()
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
        for _ in range(SENTINELS - 1):
            runs[0][0]()
        torch.cuda.synchronize()
        for call, reps, cold in runs:
            for _ in range(reps):
                if cold:
                    flush.fill_(1)
                call()
        torch.cuda.synchronize()
    launches = sorted(
        (e.time_range.start, e.time_range.elapsed_us() / 1e3)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and kernel in e.name
    )
    want = sum(reps for _call, reps, _cold in runs) * per_call
    sentinels = SENTINELS * per_call
    if not want <= len(launches) <= want + sentinels:
        raise AssertionError(f"the trace holds {len(launches)} {kernel} launches,"
                             f" not {want} (+ up to {sentinels} of the sentinels)")
    if len(launches) < want + sentinels:
        say(f"  the trace of {kernel} kept {len(launches)} of {want + sentinels} launches"
            f" ({sentinels} of the sentinels first)")
    out, k = [], len(launches) - want
    for _call, reps, _cold in runs:
        out.append([sum(ms for _start, ms in launches[k + r * per_call : k + (r + 1) * per_call])
                    for r in range(reps)])
        k += reps * per_call
    return out


def repeated_launch_ms(kernel: str, call, device, per_call: int = 1) -> dict:
    """REPEATS repeats of 10 cold and 10 warm calls of `call`, traced (each
    launching the kernel `per_call` times, summed a call): the median of
    the repeats' medians, cold and warm, with each list."""
    traced = launch_ms(kernel, [(call, 10, cold) for _ in range(REPEATS)
                                for cold in (True, False)], device, per_call)
    cold = [statistics.median(t) for t in traced[0::2]]
    warm = [statistics.median(t) for t in traced[1::2]]
    return {"cold": cold, "warm": warm, "cold_ms": statistics.median(cold),
            "warm_ms": statistics.median(warm)}


def _spread(xs: list) -> str:
    return f"{min(xs):.4f}-{max(xs):.4f}"


def osa_timing(card: str, typo: dict) -> dict:
    """K3 on the typo path's resident vocabulary (`store._device_vocab`),
    for every word the typo pass put through it, at the pass's max_dist 2:
    held byte for byte against its plain version, then timed in turns
    (plain, kernel, plain; the plain version one call each time by CUDA
    events, the first after its byte-for-byte check: a median of 3 after a
    warm-up each time until phase 25 came).
    The kernel is timed per launch from the trace of the pass's own call
    (`launch_ms` over `osa_distances_device`), 10 calls cold, the L2
    cache flushed before each (the kernels line's time), and 10 warm. Also
    the wrapper per call (CUDA events around one `osa_device` call, the
    host's query table included), the vocabulary's upload with its length
    order, and for the words nearest 5 and 10 letters the whole call split
    into its parts and the host pass. Returns the kernels line's numbers:
    the mean per launch over the words, and the largest error."""
    import numpy as np
    import torch

    from meilisearch_tpu_torch.ops.device_osa import (
        DeviceVocab,
        launch,
        length_order,
        osa_device,
        osa_device_torch,
        osa_distances_device,
        query_params,
        query_tensor,
    )
    from meilisearch_tpu_torch.ops.levenshtein import MAX_LEN, osa_distances

    store, words = typo["store"], typo["words"]
    mat_np, lens_np = store._derivation_store_cache["packed"]
    _, dv = store._device_vocab
    lens_all = dv.lens.cpu().numpy()
    say(f"K3 timing vocabulary, {dv.n} rows: vocabulary order:"
        f" {warp_lengths(lens_all)}; length order (dv.order):"
        f" {warp_lengths(lens_all[dv.order.cpu().numpy()])}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = DeviceVocab(mat_np, lens_np, dv.device)
    torch.cuda.synchronize()
    upload = (time.perf_counter() - t0) * 1e3
    order_ms = _median_ms(lambda: length_order(fresh.lens), reps=5)
    del fresh
    say(f"DeviceVocab upload of {dv.n_real} words ({dv.n} rows) on {card}:"
        f" {upload:.3f} ms host clock with its length order; the order alone"
        f" {order_ms:.4f} ms (CUDA events)")
    rows = []
    for word in words:
        q, m = query_tensor(word)
        qd = q.to(dv.device)
        got = osa_device(dv.mat, dv.lens, q, m, 2, dv.order)
        torch.cuda.synchronize()
        want = osa_device_torch(dv.mat, dv.lens, qd, m, 2)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K3 disagrees with osa_device_torch on {word!r}")
        err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
        plain = _median_ms(lambda: osa_device_torch(dv.mat, dv.lens, qd, m, 2), 1, 0)
        call = _median_ms(lambda: osa_device(dv.mat, dv.lens, q, m, 2, dv.order), reps=20)
        bound, by = k3_bound_ms(lens_all, m, 2)
        rows.append({"word": word, "m": m, "plain": [plain], "bound_ms": bound,
                     "bound_by": by, "err": err, "call_ms": call})
    runs = []
    for word in words:
        def call(word=word):
            osa_distances_device(store, mat_np, lens_np, word)
        runs += [(call, 10, True), (call, 10, False)]
    traced = launch_ms(K3_KERNEL, runs, dv.device)
    for k, row in enumerate(rows):
        row["cold"], row["warm"] = traced[2 * k], traced[2 * k + 1]
        row["ms"], row["warm_ms"] = statistics.median(row["cold"]), statistics.median(row["warm"])
        q, m = query_tensor(row["word"])
        qd = q.to(dv.device)
        row["plain"].append(_median_ms(lambda: osa_device_torch(dv.mat, dv.lens, qd, m, 2), 1, 0))
        row["plain_ms"] = statistics.median(row["plain"])
        say(f"timing K3 n={dv.n} max_dist=2 m={row['m']} ({row['word']!r}) on {card}:"
            f" per launch cold {row['ms']:.4f} ms (of {len(row['cold'])},"
            f" {min(row['cold']):.4f}-{max(row['cold']):.4f}), warm {row['warm_ms']:.4f} ms;"
            f" wrapper per call {row['call_ms']:.4f} ms; osa_device_torch"
            f" {row['plain_ms']:.4f} ms (runs {row['plain']}); bound {row['bound_ms']:.4f} ms"
            f" ({row['bound_by']}); byte-exact")
    by_word = {row["word"]: row for row in rows}
    for target in (5, 10):
        word = min(words, key=lambda w: (abs(len(w) - target), w))
        parts: dict = {k: [] for k in ("whole", "table", "launch", "readback", "numpy")}
        for _ in range(10):
            t0 = time.perf_counter()
            osa_distances_device(store, mat_np, lens_np, word)
            t1 = time.perf_counter()
            q, m = query_tensor(word)
            params = query_params(q[:m].tolist(), 2)
            t2 = time.perf_counter()
            full, prefix = launch(dv.mat, dv.lens, dv.order, params)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            full, prefix = full[: dv.n_real].cpu(), prefix[: dv.n_real].cpu()
            t4 = time.perf_counter()
            full.numpy().astype(np.int32), prefix.numpy().astype(np.int32)
            t5 = time.perf_counter()
            for key, dt in (("whole", t1 - t0), ("table", t2 - t1), ("launch", t3 - t2),
                            ("readback", t4 - t3), ("numpy", t5 - t4)):
                parts[key].append(dt * 1e3)
        med = {k: statistics.median(v) for k, v in parts.items()}
        K = min(MAX_LEN, len(word) + 2)  # the host pass's column trim
        host = []
        for _ in range(1):  # two runs until phase 25 came
            t0 = time.perf_counter()
            osa_distances(word, mat_np[:, :K], np.minimum(lens_np, K))
            host.append((time.perf_counter() - t0) * 1e3)
        say(f"timing typo pass m={len(word)} ({word!r}), {dv.n_real} words on {card},"
            f" medians of 10: osa_distances_device with readback {med['whole']:.3f} ms"
            f" (host clock); its parts: query table {med['table']:.3f} ms, launch to"
            f" sync {med['launch']:.3f} ms (host clock; the kernel alone"
            f" {by_word[word]['ms']:.4f} ms cold, {by_word[word]['warm_ms']:.4f} ms warm,"
            f" on the device clock), readback {med['readback']:.3f} ms,"
            f" numpy {med['numpy']:.3f} ms; host pass (levenshtein.osa_distances,"
            f" {K} columns) {statistics.median(host):.3f} ms (runs {host})")
    mean = {k: statistics.fmean(r[k] for r in rows)
            for k in ("ms", "warm_ms", "plain_ms", "bound_ms", "call_ms")}
    # the limiter of the larger part of the summed bound
    ops_part = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    by = "operations" if 2 * ops_part >= sum(r["bound_ms"] for r in rows) else "bytes"
    say(f"K3 over the typo pass's {len(rows)} words (m {min(r['m'] for r in rows)}"
        f"-{max(r['m'] for r in rows)}), mean per launch: kernel cold {mean['ms']:.4f} ms"
        f" ({mean['ms'] / mean['bound_ms']:.2f}x the bound), warm {mean['warm_ms']:.4f} ms"
        f" ({mean['warm_ms'] / mean['bound_ms']:.2f}x), wrapper per call"
        f" {mean['call_ms']:.4f} ms, plain {mean['plain_ms']:.4f} ms, bound"
        f" {mean['bound_ms']:.4f} ms ({by})")
    return {"ms": mean["ms"], "plain_ms": mean["plain_ms"], "bound_ms": mean["bound_ms"],
            "bound_by": by, "max_abs_err": max(r["err"] for r in rows)}


def dp_inputs(T: int, N: int, seed: int, device, width: int | None = None):
    """K6's inputs: `example_inputs` with INF addends where a class is
    absent, every 13th column matched by no term, every 11th invalid and
    docids above 2^23 from column N // 2 on (clipped in key_lo2: full-key
    ties); and an int32 exactness addend for the cost mode. Laid out
    `width` columns wide (default N) as the port's callers lay out the
    bulk path's stride: pad columns match no term, at INF costs, not
    valid. On `device`."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    cm, pc, fc, pos, em, docids, valid = (x.clone() for x in ds.example_inputs(T=T, N=N, seed=seed))
    gen = torch.Generator().manual_seed(seed)
    absent = ~cm & (torch.rand(cm.shape, generator=gen) < 0.5)
    fc[absent] = ds.INF
    pos[absent] = ds.INF
    cm[:, :, ::13] = False
    valid[::11] = False
    docids[N // 2 :] = (1 << 23) + torch.arange(N - N // 2, dtype=torch.int32)
    exact_cost = torch.randint(0, 3, (T, N), generator=gen, dtype=torch.int32)
    tensors = (cm, pc, fc, pos, em, docids, valid, exact_cost)
    if width is not None and width > N:
        fills = (False, 0, ds.INF, ds.INF, False, 0, False, 0)
        tensors = tuple(
            torch.cat([x, torch.full(x.shape[:-1] + (width - N,), fill, dtype=x.dtype)], dim=-1)
            for x, fill in zip(tensors, fills)
        )
    tensors = tuple(x.contiguous().to(device) for x in tensors)
    return tensors[:7], tensors[7]


def chain_dp_kernel_phase(device) -> int:
    """K6 in its three modes against its plain versions on the card, bit
    for bit, for every T of K6_TERMS at each of K6_WIDTHS and K6_BROAD_N,
    in the unpadded layout (the direct path where N is not a multiple of
    16) and in the callers' padded one (the bulk path): the cost matrix,
    the three keys, and `chain_query_topk`'s docids and keys at k = 1,
    10 and 32 (the top-k mode and the merge of its survivors), 33, tile
    - 1, tile, tile + 1 and N (the keys mode and the sort of all N),
    against `chain_query_topk_torch` (at k = N: its first k are its answer
    at k). Returns the max abs error (0; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    worst = 0
    for N in K6_WIDTHS + (K6_BROAD_N,):
        for T in K6_TERMS:
            seed = 600 + T
            keys, exact_cost = dp_inputs(T, N, seed, device)
            want = [ds.chain_cost_matrix_torch(*keys[:4], exact_cost),
                    *ds.chain_query_keys_torch(*keys)]
            # every candidate in order: the plain top-k at any k is its head
            ranked = ds.chain_query_topk_torch(*keys, k=N)
            tile = ds.tile_width(T)
            ks = sorted({1, 10, 32, 33, tile - 1, tile, tile + 1, N})
            for width in sorted({N, ds.aligned_width(N)}):
                args, cost_in = ((keys, exact_cost) if width == N
                                 else dp_inputs(T, N, seed, device, width))
                got = [ds.chain_cost_matrix(*args[:4], cost_in, n=N)]
                path = ds.LAST_PATH["path"]
                got += ds.chain_query_keys(*args, n=N)
                top = {k: ds.chain_query_topk(*args, k=k, n=N) for k in ks}
                torch.cuda.synchronize()
                err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                same_top = all(torch.equal(g, w[:k]) for k in ks for g, w in zip(top[k], ranked))
                expected = "bulk" if width % ds.ALIGN_COLUMNS == 0 else "direct"
                say(f"K6 N={N} T={T} width={width} ({path} path): cost and keys"
                    f" bit-exact={same} max_abs_err={err}, top-k docids and keys equal at"
                    f" k={ks}: {same_top}; ranked {int((got[1] < ds.INVALID_HI).sum())} of {N}")
                if not (same and same_top) or path != expected:
                    raise AssertionError(f"K6 disagrees with its plain version at N={N} T={T}"
                                         f" width={width} ({path} path, {expected} expected)")
                worst = max(worst, err)
    return worst


def k6_bound_ms(T: int, N: int, mode: str, k: int = K6_TOPK) -> tuple[float, str]:
    """The least time K6 could take on a (T, 3, N) query: the larger of
    the bytes it must move over the HBM rate and its int32 operations
    (K6_OPS_*) over the int32 rate. Read once: masks, pair costs, fid and
    position addends, exactness (int32 in the cost mode, bool else), and
    docids and valid in the keys and top-k modes. Written once: the (6,
    N) costs, the three (N,) keys, or the top-k mode's min(k, N) results
    (docid and three keys). The top-k mode counts the keys mode's
    operations: the survivors and their sort are the implementation's
    work, not the function's."""
    reads = N * (3 * T + 9 * (T - 1) + 24 * T + (4 * T if mode == "cost" else T + 5))
    writes = {"cost": 24 * N, "keys": 12 * N, "topk": 16 * min(k, N)}[mode]
    ops = N * (K6_OPS_FIRST + K6_OPS_TERM * (T - 1) + K6_OPS_FINAL
               + (0 if mode == "cost" else K6_OPS_PACK))
    t_bytes, t_ops = (reads + writes) / HBM_BYTES_S, ops / INT32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def chain_scorer_phase(device, card: str, keyword: dict) -> dict:
    """Phase 8: the chain scorer (K6) and the scatter-gather (K7) on the
    card. (b) `entry()` once, against the plain version; (c)
    `dryrun_multichip(1)` in a one-rank NCCL group at DRYRUN_DOCS; (d)
    the executor path: with MEILI_TPU_DEVICE=1, `perform_search` over
    CHAIN_QUERIES and QUERIES on the keyword phase's store (bound to the
    card), each response equal to the same store's answer with
    MEILI_TPU_DEVICE=0, K6 launched; (e) K6 per launch cold and warm in
    each mode at T = 4 and the N of the broadest query's candidates, its
    bound and plain version, the 3-key sort, and the whole run_device
    call against the host run_raw on the host clock. Returns the kernels
    line's numbers."""
    import torch
    import torch.distributed as dist

    from meilisearch_tpu_torch.entry import dryrun_multichip, entry
    from meilisearch_tpu_torch.ops import device_scorer as ds
    from meilisearch_tpu_torch.search import scorer as scorer_mod
    from meilisearch_tpu_torch.search.perform import perform_search

    t_phase = time.perf_counter()
    if not dist.is_nccl_available():
        raise AssertionError("torch.distributed has no NCCL on this machine")
    # (b) the flagship step
    ds.SELECT_LAUNCHES.reset()
    fn, args = entry()
    got = fn(*args)
    want = ds.chain_query_topk_torch(*args, k=10)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("entry() differs from the plain version")
    say(f"entry(): chain_query_topk T=4 N=8192 k=10 on {got[0].device}: docs"
        f" {got[0].tolist()} equal to the plain version (docs and keys)")
    # (c) the dry run in a one-rank NCCL group, its collectives recorded
    t0 = time.perf_counter()
    before = ds.LAUNCHES.value
    with _recorded_collectives() as moved:
        dryrun_multichip(1, device="cuda", n_docs=DRYRUN_DOCS)
    say(f"dryrun_multichip(1, cuda, {DRYRUN_DOCS} docs): passed in"
        f" {time.perf_counter() - t0:.3f} s, K6 launches {ds.LAUNCHES.value - before}"
        " (one NCCL rank: no collective across cards is measured)")
    select_launches = ds.SELECT_LAUNCHES.value
    if select_launches <= 0:
        raise AssertionError("the survivors' merge was not launched by entry() and the dry run")
    collective_timing(device, card, moved)

    # (d) the executor path
    store, expected = keyword["store"], keyword["expected"]
    queries = CHAIN_QUERIES + QUERIES
    run_device = scorer_mod.FusedScorer.run_device
    calls, answers, taken = [], [], []  # taken: (candidates, query) of K6's calls
    scorer_mod.FusedScorer.run_device = _timed(run_device, calls)
    try:
        with _device_dp("0"):
            t0 = time.perf_counter()
            expected = [_strip(perform_search(store, dict(q))) for q in CHAIN_QUERIES] + expected
            say(f"host answers of the chain queries: {time.perf_counter() - t0:.3f} s")
        with _device_dp("1"):
            ds.LAUNCHES.reset()
            t0 = time.perf_counter()
            for q in queries:
                start = len(calls)
                answers.append(_strip(perform_search(store, dict(q))))
                taken += [(c[0], q) for c in calls[start:] if c[1]]
            wall = time.perf_counter() - t0
            launches = ds.LAUNCHES.value
    finally:
        scorer_mod.FusedScorer.run_device = run_device
    bad = [q for q, a, w in zip(queries, answers, expected) if a != w]
    say(f"executor path (MEILI_TPU_DEVICE=1, store on {store.device}):"
        f" {len(queries) - len(bad)}/{len(queries)} responses equal to MEILI_TPU_DEVICE=0;"
        f" run_device took {len(taken)} of {len(calls)} scorer calls; K6 launches"
        f" {launches}; {wall:.3f} s")
    if bad:
        raise AssertionError(f"the device DP's responses differ: {bad[:3]}")
    if launches <= 0:
        raise AssertionError("K6 was not launched on the executor path")

    # (e) timing at the broadest query's candidates
    n_broad, broad = max(taken, key=lambda c: c[0])
    chain, select = chain_dp_timing(device, card, n_broad)
    chain["launches"] = launches
    select["launches"] = select_launches
    run_device_timing(store, card, broad, n_broad)
    say(f"phase 8 wall: {time.perf_counter() - t_phase:.3f} s")
    return {"chain_dp": chain, "select": select}


@contextlib.contextmanager
def _recorded_collectives():
    """The (op, shape, dtype) of each collective K7 makes inside the
    block: `sharded._all_gather` and `torch.distributed.all_reduce`."""
    import torch.distributed as dist

    from meilisearch_tpu_torch.parallel import sharded

    moved = []
    gather, reduce = sharded._all_gather, dist.all_reduce

    def gathered(shards, x):
        moved.append(("all_gather_into_tensor", tuple(x.shape), x.dtype))
        return gather(shards, x)

    def reduced(x, *args, **kwargs):
        moved.append(("all_reduce", tuple(x.shape), x.dtype))
        return reduce(x, *args, **kwargs)

    sharded._all_gather, dist.all_reduce = gathered, reduced
    try:
        yield moved
    finally:
        sharded._all_gather, dist.all_reduce = gather, reduce


def collective_timing(device, card: str, moved: list) -> None:
    """K7's library calls alone: each distinct collective the dry run made
    (`moved`), by CUDA events (median of 50 after 5 warm-ups) in a
    one-rank NCCL group of its own, beside its bound on one rank: the
    bytes it reads and writes (input once, output once) over the HBM
    rate. One rank moves nothing between cards: NVLink is not measured."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "rdv"), 1),
                                rank=0, world_size=1)
        try:
            for op, shape, dtype in sorted(set(moved), key=str):
                x = torch.ones(shape, dtype=dtype, device=device)
                if op == "all_reduce":
                    def call(x=x):
                        dist.all_reduce(x, op=dist.ReduceOp.SUM)
                else:
                    out = torch.empty_like(x)

                    def call(x=x, out=out):
                        dist.all_gather_into_tensor(out, x)
                ms = _median_ms(call, reps=50, warmup=5)
                size = x.numel() * x.element_size()
                bound = 2 * size / HBM_BYTES_S * 1e3
                say(f"timing K7 {op} of {shape} {dtype} ({size} bytes), one NCCL rank, on"
                    f" {card}: {ms:.4f} ms by CUDA events (median of 50), made"
                    f" {moved.count((op, shape, dtype))} times in the dry run; bound"
                    f" {bound:.7f} ms (bytes, {2 * size} at the HBM rate)")
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def _device_dp(flag: str):
    """MEILI_TPU_DEVICE set to `flag` inside the block, put back after."""
    import os

    prior = os.environ.get("MEILI_TPU_DEVICE")
    os.environ["MEILI_TPU_DEVICE"] = flag
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop("MEILI_TPU_DEVICE", None)
        else:
            os.environ["MEILI_TPU_DEVICE"] = prior


def chain_dp_timing(device, card: str, n: int) -> dict:
    """K6 at T = 4 and N = n (seeded inputs), in each mode on the
    callers' padded layout (the bulk path), and the cost mode also
    unpadded (the direct path at an odd n): equal to its plain version,
    then plain, kernel (traced per launch, cold and warm, REPEATS
    repeats), plain; each mode's bound. Then the whole chain_query_topk
    at k = K6_TOPK by CUDA events (the top-k mode and the merge of its
    survivors, enqueued by one C call) beside the keys mode and the stable 3-key sort over all n
    that it replaces. Returns the kernels line's numbers: the cost mode's
    (the executor's) and the top-k mode's."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    flat, flat_cost = dp_inputs(4, n, 700, device)
    keys, exact_cost = dp_inputs(4, n, 700, device, ds.aligned_width(n))
    k = K6_TOPK
    modes = {
        "cost": (lambda: ds.chain_cost_matrix(*keys[:4], exact_cost, n=n),
                 lambda: ds.chain_cost_matrix_torch(*flat[:4], flat_cost)),
        "keys": (lambda: ds.chain_query_keys(*keys, n=n),
                 lambda: ds.chain_query_keys_torch(*flat)),
        "topk": (lambda: ds.chain_query_topk(*keys, k=k, n=n),
                 lambda: ds.chain_query_topk_torch(*flat, k=k)),
        "cost, unpadded": (lambda: ds.chain_cost_matrix(*flat[:4], flat_cost),
                           lambda: ds.chain_cost_matrix_torch(*flat[:4], flat_cost)),
    }
    lines = {}
    for mode, (call, plain_call) in modes.items():
        got = call()
        path = ds.LAST_PATH["path"]
        torch.cuda.synchronize()
        want = plain_call()
        got, want = (list(x) if isinstance(x, tuple) else [x] for x in (got, want))
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K6 {mode} differs from its plain version at N={n}")
        plain = [_median_ms(plain_call, reps=5)]
        k6 = repeated_launch_ms(K6_KERNEL, call, device)
        plain.append(_median_ms(plain_call, reps=5))
        bound, by = k6_bound_ms(4, n, mode.split(",")[0], k)
        say(f"timing K6 {mode} T=4 N={n} ({path} path) on {card}: per launch (trace, median"
            f" of {REPEATS} repeats of 10) cold {k6['cold_ms']:.4f} ms (repeats"
            f" {_spread(k6['cold'])}), warm {k6['warm_ms']:.4f} ms (repeats"
            f" {_spread(k6['warm'])}); plain version {statistics.median(plain):.4f} ms"
            f" (runs {plain}); bound {bound:.4f} ms ({by}); cold {bound / k6['cold_ms']:.2f},"
            f" warm {bound / k6['warm_ms']:.2f} of the bound; equal")
        lines[mode] = {"ms": k6["cold_ms"], "warm_ms": k6["warm_ms"],
                       "plain_ms": statistics.median(plain), "bound_ms": bound,
                       "bound_by": by, "max_abs_err": err, "path": path}

    def keys_then_sort():
        return ds.sort3(*ds.chain_query_keys(*keys, n=n), keys[5], k)

    calls = {"top-k mode + merge of the survivors": lambda: ds.chain_query_topk(*keys, k=k, n=n),
             "keys mode + sort of all N": keys_then_sort}
    whole = {label: _median_ms(call, reps=50) for label, call in calls.items()}
    say(f"timing chain_query_topk T=4 N={n} k={k} on {card} (CUDA events, median of 50):"
        + "; ".join(f" {label} {ms:.4f} ms" for label, ms in whole.items()))
    cost, topk = lines["cost"], lines["topk"]
    chain = {**cost, "topk_ms": topk["ms"], "topk_bound_ms": topk["bound_ms"],
             "topk_call_ms": whole["top-k mode + merge of the survivors"]}
    return chain, select_timing(device, card, keys, n)


def select_timing(device, card: str, keys, n: int) -> dict:
    """The survivors' merge (select_kernel) as chain_query_topk launches it
    at T = 4, N = n, k = K6_TOPK: the top-k mode's survivors (`_launch`)
    equal, slot for slot, to the plain per-tile select of the plain keys;
    the call's answer equal to the merge walked in plain torch over those
    survivors (`merge_survivors`); then the merge's launches, traced in
    the trace of the whole call and summed a call, cold and warm (REPEATS
    repeats), its plain walk, and its bound: per pass the entries read
    once and the slots written once (16 bytes each) over the HBM rate, or
    one 4-word compare an entry read over the int32 rate. Returns the
    kernels line's numbers."""
    import torch

    from meilisearch_tpu_torch.ops import device_scorer as ds

    k, tile = K6_TOPK, ds.tile_width(4)
    docids = keys[5]
    kept = torch.empty((4, -(-n // tile) * k), dtype=torch.int32, device=device)
    ds._launch(ds.MODE_TOPK, keys, kept.unbind(0), 4, n, docids.shape[0], k)
    plain_keys = ds.chain_query_keys_torch(*(x[..., :n] for x in keys))
    cols = torch.arange(n, dtype=torch.int32, device=device)
    want_kept = ds.select_torch(torch.stack([*plain_keys, cols]), k, width=tile)
    merges = ds.SELECT_LAUNCHES.value
    got = ds.chain_query_topk(*keys, k=k, n=n)
    torch.cuda.synchronize()
    passes = ds.SELECT_LAUNCHES.value - merges
    walked = ds.merge_survivors(kept, k, docids)
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip((*kept, *got), (*want_kept, walked[3], *walked[:3])))
    if err or not torch.equal(kept, want_kept):
        raise AssertionError("the top-k mode's survivors differ from the plain per-tile select")
    if not all(torch.equal(g, w) for g, w in zip(got, (walked[3], *walked[:3]))):
        raise AssertionError("chain_query_topk differs from the plain merge of its survivors")
    timed = repeated_launch_ms("select_kernel", lambda: ds.chain_query_topk(*keys, k=k, n=n),
                               device, per_call=passes)
    plain = _median_ms(lambda: ds.merge_survivors(kept, k, docids), reps=5)
    bound, t_bytes, t_ops, m = 0.0, 0.0, 0.0, kept.shape[1]
    for p in range(passes):
        out = k if p == passes - 1 else -(-m // ds.SELECT_WIDTH) * k
        b, o = 16 * (m + out) / HBM_BYTES_S, 4 * m / INT32_OPS_S
        bound, t_bytes, t_ops, m = bound + max(b, o), t_bytes + b, t_ops + o, out
    by = "bytes" if t_bytes > t_ops else "operations"
    say(f"timing the survivors' merge in chain_query_topk T=4 N={n} k={k} on {card}:"
        f" {passes} passes from {kept.shape[1]} survivors, per call (trace, summed over the"
        f" passes, median of {REPEATS} repeats of 10) cold {timed['cold_ms']:.4f} ms (repeats"
        f" {_spread(timed['cold'])}), warm {timed['warm_ms']:.4f} ms; plain walk {plain:.4f}"
        f" ms; bound {bound * 1e3:.6f} ms ({by}); survivors and answer equal")
    return {"ms": timed["cold_ms"], "warm_ms": timed["warm_ms"], "plain_ms": plain,
            "bound_ms": bound * 1e3, "bound_by": by, "passes": passes, "max_abs_err": err}


def run_device_timing(store, card: str, query: dict, n: int) -> None:
    """The whole FusedScorer.run_device call (chain tensors on the host,
    upload, K6, readback) against the host pass's run_raw, each on the
    host clock inside `perform_search` of `query` (its scorer call over
    n candidates), median of 5."""
    from meilisearch_tpu_torch.search import scorer as scorer_mod
    from meilisearch_tpu_torch.search.perform import perform_search

    times = {}
    for method, flag in (("run_device", "1"), ("run_raw", "0")):
        orig = getattr(scorer_mod.FusedScorer, method)
        seen = []
        setattr(scorer_mod.FusedScorer, method, _timed(orig, seen))
        try:
            with _device_dp(flag):
                for _ in range(5):
                    perform_search(store, dict(query))
        finally:
            setattr(scorer_mod.FusedScorer, method, orig)
        times[method] = statistics.median(c[2] for c in seen if c[0] == n)
    say(f"timing {query} (N={n} candidates) on {card}, host clock, medians of 5:"
        f" run_device (chain tensors, upload, K6, readback) {times['run_device']:.3f} ms;"
        f" the host pass's run_raw {times['run_raw']:.3f} ms")


def _timed(method, seen: list):
    """`method` wrapped to append (scorer.n, returned a result, ms)."""

    def wrapped(self, *args):
        t = time.perf_counter()
        out = method(self, *args)
        seen.append((self.n, out is not None, (time.perf_counter() - t) * 1e3))
        return out

    return wrapped


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the keyword path's depth: 500,000 documents (D = 2^19) keep the whole
    # run, vector path included, near half of its 1200 s limit
    parser.add_argument("--docs", type=int, default=500_000)
    # the encoder path's depth (documents embedded at indexing)
    parser.add_argument("--enc-docs", type=int, default=ENC_DOCS)
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from meilisearch_tpu_torch._hooks import block_jax
    except ImportError:
        print("chip_smoke: run it from the root of the repository", file=sys.stderr)
        return 2
    block_jax()  # the port runs without jax, even where jax is installed
    device = torch.device("cuda", 0)

    card = card_line()
    say(card)
    t_start = time.perf_counter()
    walls = {}

    def run(name, fn, *args):
        """fn(*args), its wall printed and kept under `name`."""
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t, 3)
        say(f"phase {name} ended after {walls[name]:.3f} s")
        return out

    run("1", build_phase)
    k1_err, k3_err, k4_err, k6_err = run("2", lambda: (
        kernel_phase(device), osa_kernel_phase(device), hamming_kernel_phase(device),
        chain_dp_kernel_phase(device)))
    keyword = run("3", main_path_phase, device, opts.docs)
    # phase 8 runs on the keyword phase's store, which goes before phase 4
    chain = run("8", chain_scorer_phase, device, card, keyword)
    select = chain["select"]
    chain = chain["chain_dp"]
    k6_err = max(k6_err, chain.pop("max_abs_err"))
    del keyword["store"]
    typo = run("4", typo_path_phase, device, TYPO_VOCAB_WORDS)
    vector = run("5", vector_path_phase, device)
    timing = run("6", timing_phase, device, card, typo, vector)
    launches = {"osa": typo["launches"], "hamming": vector["launches"]}
    del typo, vector  # the earlier paths' stores go before the encoder path's
    run("7", encoder_path_phase, device, card, opts.enc_docs)
    run("9", xlmr_path_phase, device, card, E5_DOCS)
    run("10", workloads_phase, device)
    for name, fn, n_docs in (
            ("11", bpe_distilbert_phase, P11_DOCS), ("12", mpnet_phase, P12_DOCS),
            ("13", modernbert_phase, P13_DOCS), ("14", families_phase, P14_DOCS),
            ("15", qwen3_embedding_phase, P15_DOCS), ("16", embeddinggemma_phase, P16_DOCS),
            ("17", llama32_phase, P17_DOCS), ("18", bert_families_phase, P18_DOCS),
            ("19", more_families_phase, P19_DOCS), ("20", moses_families_phase, P20_DOCS),
            ("21", bge_gemma2_phase, P21_DOCS), ("22", longformer_phase, P22_DOCS),
            ("23", bigbird_sparse_phase, P23_DOCS), ("24", sgpt_phase, P24_DOCS),
            ("25", moe_phase, P25_DOCS), ("26", bmretriever_phase, P26_DOCS)):
        run(name, fn, device, card, n_docs)
    say(f"phase walls (s): {json.dumps(walls)}; the script from the first phase:"
        f" {time.perf_counter() - t_start:.3f} s")
    k3_err = max(k3_err, timing["osa"].pop("max_abs_err"))
    k4_err = max(k4_err, timing["hamming"].pop("max_abs_err"))
    leaked = [
        m for m, mod in sys.modules.items()
        if mod is not None
        and m.split(".")[0] in ("jax", "jaxlib", "flax", "meilisearch_tpu")
    ]
    if leaked:
        raise AssertionError(f"jax or the JAX package was imported: {leaked[:5]}")
    print(json.dumps({"kernels": [
        {"name": "chain_keys", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": keyword["launches"],
         "max_abs_err": k1_err, **timing["chain_keys"], "library_ms": None},
        {"name": "osa", "route": "cuda", "source": K3_SOURCE,
         "replaces": K3_REPLACES, "launches": launches["osa"],
         "max_abs_err": k3_err, **timing["osa"], "library_ms": None},
        {"name": "hamming", "route": "cuda", "source": K4H_SOURCE,
         "replaces": K4H_REPLACES, "launches": launches["hamming"],
         "max_abs_err": k4_err, **timing["hamming"], "library_ms": None},
        {"name": "chain_dp", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_REPLACES, "max_abs_err": k6_err, **chain, "library_ms": None},
        {"name": "chain_select", "route": "cuda", "source": K6_SOURCE,
         "replaces": K6_SELECT_REPLACES, **select, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
