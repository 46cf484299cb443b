"""Operations and bytes of each kernel call and of a whole decode step,
computed from shapes, and the H100's peaks they are held against.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; the work is what the live requests need: a frozen
slot's rows, which the batched steps still compute, are not counted.
Blocks: Q4_0 packed, 16 bytes of codes a 32-value block, and its scale (2
bytes in bfloat16, as the decode steps and LM heads keep them; 4 in
float32). Caches: 2 bytes a value (bfloat16, the card's default).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense, NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
CACHE_BYTES = 2          # bf16 K / V caches
F32 = 4

# kernel names in the device trace (namespace, template arguments and
# return type dropped) of each kernel family
KERNELS = {
    "k1": ("qmm_kernel", "stage_x_kernel"),
    "k4": ("attn_page_kernel",),
    "k5": ("gemv_kernel",),
    "k10": ("dia_flat_kernel",),
    "k11": ("llama_gemv_kernel",),
}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the work could take: the larger of its operations
    over the bf16 peak and its bytes over the HBM rate."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def block_bytes(n: int, k: int, qtype: str = "Q4_0", packed: bool = True,
                scale_bytes: int = 2) -> float:
    """Bytes of an (n, k) block-quantized matrix."""
    codes = {"Q4_0": 16 if packed else 32, "Q5_0": 20, "Q8_0": 32}[qtype]
    return n * k / 32 * (codes + scale_bytes)


QTYPES = {2: "Q4_0", 6: "Q5_0", 8: "Q8_0"}   # ggml type ids


def k1_call(m: int, n: int, k: int, qtype: int, scale: str,
            packed: bool) -> tuple[float, float]:
    """K1, x (m, k) f32 @ W^T (n, k) -> (m, n) f32."""
    w = block_bytes(n, k, QTYPES[qtype], packed, 2 if scale == "bf16" else 4)
    return 2.0 * m * n * k, w + F32 * (m * k + m * n)


def gemv_step(mats: list, rows: int) -> tuple[float, float]:
    """A step's GEMVs: every (n, k) Q4_0 matrix read once, `rows` live rows
    in (k) and out (n) in float32."""
    fl = by = 0.0
    for n, k in mats:
        fl += 2.0 * rows * n * k
        by += block_bytes(n, k) + F32 * rows * (n + k)
    return fl, by


def attention(q_rows: int, heads: int, kv_heads: int, d: int, kv_rows: int,
              kv_bytes: int = CACHE_BYTES) -> tuple[float, float]:
    """One sequence's decode attention: q_rows query rows of `heads` heads
    over kv_rows K / V rows of kv_heads heads; q and out in float32."""
    fl = 4.0 * q_rows * heads * d * kv_rows
    by = 2 * kv_heads * kv_rows * d * kv_bytes + 2 * F32 * q_rows * heads * d
    return fl, by


# ---------------------------------------------------------------------------
# Parler-TTS (K5 GEMVs and K4 attention; the LM heads are K1's)
# ---------------------------------------------------------------------------

def parler_mats(cfg: dict) -> list:
    """A layer's projections in K5's GEMVs: q, k, v, o, cross q, cross o,
    fc1, fc2."""
    H, F = cfg["hidden_size"], cfg["ffn_dim"]
    return [(H, H)] * 6 + [(F, H), (H, F)]


def parler_k5_step(cfg: dict, live: int) -> tuple[float, float]:
    fl, by = gemv_step(parler_mats(cfg), live)
    L = cfg["num_hidden_layers"]
    return fl * L, by * L


def parler_k4_step(cfg: dict, positions: list) -> tuple[float, float]:
    """K4 over a step's live slots at `positions` (cache rows pos + 1):
    self-attention on the bf16 cache, and cross-attention over the
    description's float32 K / V, shared by the slots and read once."""
    H, nh, L = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_hidden_layers"]
    d, tc = H // nh, cfg["description_rows"]
    fl = by = 0.0
    for p in positions:
        f, b = attention(1, nh, nh, d, p + 1)
        fc, bc = attention(1, nh, nh, d, tc, F32)
        fl += f + fc
        by += b + 2 * F32 * nh * d            # the cross part's q and out
    by += 2 * nh * tc * d * F32               # the shared cross K / V
    return fl * L, by * L


def parler_heads(cfg: dict, rows: int) -> tuple[float, float]:
    n = cfg["num_codebooks"] * cfg["vocab_size"]
    return k1_call(rows, n, cfg["hidden_size"], 2, "bf16", True)


# ---------------------------------------------------------------------------
# Dia (K11 GEMVs and K4 / cross-attention; K10 the whole layer stack)
# ---------------------------------------------------------------------------

def dia_mats(cfg: dict) -> list:
    """A decoder layer's projections: self q, k, v, o, cross q, cross o,
    gate, up, wo (the cross K / V are the encoder's, once a request)."""
    H, F = cfg["decoder_n_embd"], cfg["decoder_n_hidden"]
    Q = cfg["gqa_query_heads"] * cfg["gqa_head_dim"]
    KV = cfg["kv_heads"] * cfg["gqa_head_dim"]
    C = cfg["cross_query_heads"] * cfg["cross_head_dim"]
    return [(Q, H), (KV, H), (KV, H), (H, Q), (C, H), (H, C),
            (F, H), (F, H), (H, F)]


def dia_k11_step(cfg: dict, live: int) -> tuple[float, float]:
    """The GEMVs of one step of `live` CFG pairs (2 rows each)."""
    fl, by = gemv_step(dia_mats(cfg), 2 * live)
    L = cfg["decoder_n_layer"]
    return fl * L, by * L


def dia_attn_step(cfg: dict, positions: list, cross_rows: list) -> \
        tuple[float, float]:
    """Self-attention (bf16 cache, rows pos + 1, both guidance rows) and
    cross-attention (bf16 bucket of `cross_rows` rows, the tail folded in as
    one float32 row of V sums) of a step's live pairs."""
    nh, nkv, d = cfg["gqa_query_heads"], cfg["kv_heads"], cfg["gqa_head_dim"]
    ch = cfg["cross_query_heads"]
    fl = by = 0.0
    for p, sb in zip(positions, cross_rows):
        f, b = attention(1, nh, nkv, d, p + 1)
        fc, bc = attention(1, ch, ch, d, sb)
        fl += 2 * (f + fc)
        by += 2 * (b + bc + F32 * ch * d)
    L = cfg["decoder_n_layer"]
    return fl * L, by * L


def dia_heads(cfg: dict, pairs: int) -> tuple[float, float]:
    n = cfg["channels"] * cfg["output_vocab_size"]
    return k1_call(2 * pairs, n, cfg["decoder_n_embd"], 2, "bf16", True)


def dia_k10_step(cfg: dict, pos: int, cross_rows: int) -> tuple[float, float]:
    """K10, one request's whole layer stack in one launch."""
    g = dia_k11_step(cfg, 1)
    a = dia_attn_step(cfg, [pos], [cross_rows])
    return g[0] + a[0], g[1] + a[1]


def cross_bucket(n_bytes: int, buckets=(128, 256, 512, 1024)) -> int:
    """The cross rows the single-stream route keeps: the smallest bucket
    that holds the prompt's bytes."""
    return next(b for b in buckets if n_bytes <= b)
