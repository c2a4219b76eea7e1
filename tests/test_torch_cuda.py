"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where there is no GPU (decided inside the
fixture, never at import). On a machine with an H100 and nvcc, from the root
of a checkout (the test conftest needs jax, which that machine may lack):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: max abs error 1e-4 in float32 (summation order only) and 2e-2
in bf16 (the bf16 tolerance of tests/test_flash_attention.py:184). bf16 K2,
K3 and K4 at D = 128 run the Hopper body of csrc/flash_attention.cu (wgmma
on operands brought by TMA), at D 64 and 256 its mma.sync body, float32 the
FMA body; the flash cases cover all three at ragged query, key and window
edges (the Hopper body's through TMA's zero fill, each case counted on its
per-body launch counter), starts off the tile grid, windows from an
offset key, scales views off 16 bytes, groups 1 to 8 and D 64 to 256.
bf16 K1 and K1q at D 64, 128 and 256 run the tensor-core body of
csrc/paged_attention.cu (over a bf16 pool, and over int8 codes
dequantized in shared memory), every other K1 and K1q shape the FMA body,
each case checked on the wrapper's per-body launch counter; the paged
cases cover bundles of 1 to 56 rows (one m-tile, two m-tiles held by one
CTA at D <= 128 and by two at D = 256, and two CTAs of two), block sizes
8 to 128, a 4096-key slot beside slots at positions 0 to 5, every slot at
0, 1 to 64 slots, tables whose unused entries are the null block, GQA
groups 1 to 8, all-null tables, slots with fewer live tiles than splits
and, for K1q, key rows with scales spread over decades; both also at the
speculative verify's width (W = 7, a 28-row bundle held by one CTA). The
sampling cases hold ``_pick`` and
``spec_accept_from_noise`` on the card to the CPU on shared noise. The
overload cases, on a 2-layer bf16 model written here: the brownout
headroom signal makes no ``mem_get_info`` call over a served chat's
owner-loop passes; an engine whose owner loop crashed gives its memory
back at the restart (within 1%) and serves the same greedy text; the
profile subject's capture names ``paged_decode_mma_kernel``. The
efficiency cases: the card's name finds its row of the H100 peak table;
the HBM ledger over ``torch.cuda.memory_stats`` stays quiet over freed
allocations and fires once on held ones; with an engine serving, adverts
make no CUDA call, the registry's ledger prices the engine and stays
quiet, and each program's flops are the analytic count of its shapes.
Swap-don't-shed: an int8-KV slot suspended to host memory and resumed
into fresh blocks decodes the tokens it decodes on an ample pool.
"""

import math

import pytest
import torch

from nats_llm_studio_tpu_torch.ops import flash_attention as fa
from nats_llm_studio_tpu_torch.ops import kvcache as kv
from nats_llm_studio_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(1)


def _rn(gen, *shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)


def _kvq(gen, *shape):
    """An int8 KVQ tensor quantized from standard normal f32 draws (the
    draws of the bf16 cases above, so outputs stay where one bf16 ulp is
    below the 2e-2 tolerance)."""
    return kv.quantize_rows(torch.randn(shape, generator=gen, device="cuda"))


def _table(b, nbt, w, t):
    """Block tables of b slots over blocks 1.., the last slot all null
    blocks, and positions from short to nearly full."""
    tbl = torch.arange(1, 1 + b * nbt, dtype=torch.int32, device="cuda").reshape(b, nbt)
    tbl[-1] = 0
    pos = torch.tensor([min(nbt * t - w, 5 + 37 * i + (nbt * t * 3) // 4 * (i % 2))
                        for i in range(b)], dtype=torch.int32, device="cuda")
    return tbl, pos


def _check(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,w,hq,hkv,d,t,layers,nbt,layer", [
    (3, 1, 4, 2, 64, 16, 2, 8, 1),
    (3, 3, 8, 2, 128, 16, 3, 8, 2),
    (2, 1, 32, 8, 128, 32, 2, 4, 0),
    (2, 2, 4, 4, 256, 8, 1, 6, 0),
    (1, 3, 32, 8, 128, 16, 2, 256, 1),   # one slot: many splits
    (8, 1, 32, 8, 128, 16, 2, 64, 1),
    (2, 4, 8, 2, 128, 64, 2, 20, 1),     # one block per tile
    (5, 2, 4, 1, 64, 8, 2, 40, 1),       # eight blocks per tile
])
def test_paged_decode_kernel_matches_plain(gen, dtype, b, w, hq, hkv, d, t, layers, nbt, layer):
    nb = 1 + b * nbt
    kp = _rn(gen, nb, layers, hkv, t, d, dtype=dtype)
    vp = _rn(gen, nb, layers, hkv, t, d, dtype=dtype)
    tbl = torch.arange(1, nb, dtype=torch.int32, device="cuda").reshape(b, nbt)
    tbl[-1] = 0  # a slot whose table is all null blocks
    pos = torch.tensor([min(nbt * t - w, 5 + 37 * i + (nbt * t * 3) // 4 * (i % 2))
                        for i in range(b)], dtype=torch.int32, device="cuda")
    q = _rn(gen, b, w, hq, d, dtype=dtype)
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos, layer, d ** -0.5)
    assert pa.paged_decode_attention.launches == before + 1
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos, layer, d ** -0.5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,hq,hkv,d", [
    (1, 37, 4, 2, 64), (2, 130, 8, 2, 128), (1, 64, 4, 4, 256), (1, 1000, 32, 8, 128),
    (2, 77, 8, 1, 64),      # T not a multiple of 16, group 8
    (1, 17, 32, 4, 128),    # one partial query tile, group 8
    (1, 200, 8, 8, 256),    # group 1, D=256
    (2, 300, 16, 2, 256),   # B=2, D=256, group 8
    (1, 4096, 32, 8, 128),  # the max_seq bucket
])
def test_flash_kernel_matches_plain(gen, dtype, b, t, hq, hkv, d):
    q = _rn(gen, b, t, hq, d, dtype=dtype)
    k, v = _rn(gen, b, t, hkv, d, dtype=dtype), _rn(gen, b, t, hkv, d, dtype=dtype)
    _check(fa.flash_attention(q, k, v, d ** -0.5), fa.flash_attention_plain(q, k, v, d ** -0.5),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,hq,hkv,d,kw,s,start", [
    (2, 16, 4, 2, 64, 70, 96, 24),        # ragged window edge
    (1, 256, 32, 8, 128, 1000, 1024, 700),
    (2, 100, 8, 8, 128, 512, 512, 300),
    (1, 64, 4, 2, 256, 200, 256, 0),
    (2, 33, 8, 1, 128, 130, 160, 97),     # start off the tile grid, group 8, ragged KW
    (2, 7, 4, 4, 64, 45, 64, 38),         # C=7, group 1, KW = start + C
    (2, 50, 16, 2, 256, 300, 320, 250),   # D=256, the diagonal straddles a tile
    (1, 256, 32, 8, 128, 4096, 4096, 3840),  # the last chunk of a 4096-token prompt
])
def test_flash_chunk_kernel_matches_plain(gen, dtype, b, c, hq, hkv, d, kw, s, start):
    kc, vc = _rn(gen, b, 3, hkv, s, d, dtype=dtype), _rn(gen, b, 3, hkv, s, d, dtype=dtype)
    q = _rn(gen, b, c, hq, d, dtype=dtype)
    ks, vs = kc[:, 1, :, :kw], vc[:, 1, :, :kw]  # strided views of a row cache
    _check(fa.flash_attention_chunk(q, ks, vs, d ** -0.5, start),
           fa.flash_attention_chunk_plain(q, ks, vs, d ** -0.5, start), dtype)


@pytest.mark.parametrize("b,w,hq,hkv,d,t,nbt,pos,null", [
    (3, 1, 2, 2, 64, 8, 24, [5, 100, 191], False),        # 1 row, T=8: 8 blocks a tile
    (3, 1, 8, 2, 128, 16, 20, [319, 64, 0], False),       # 4 rows (Llama-3's bundle)
    (2, 3, 8, 2, 128, 64, 6, [200, 381], True),           # 12 rows, one block a tile
    (2, 2, 16, 2, 256, 128, 4, [509, 130], True),         # 16 rows, T=128, D=256
    (2, 5, 8, 2, 64, 16, 10, [77, 150], True),            # 20 rows: two m-tiles
    (2, 4, 32, 4, 128, 32, 8, [100, 252], True),          # 32 rows, group 8
    (1, 1, 32, 8, 128, 16, 256, [4095], False),           # one slot of 4096 keys, 16 splits
    (8, 1, 32, 8, 128, 16, 256, [4095, 3001, 2048, 1500, 777, 300, 64, 5], True),  # serve
    (2, 1, 32, 8, 256, 16, 128, [2047, 0], False),        # D=256, a slot of one live key
])
def test_paged_decode_mma_body_matches_plain(gen, b, w, hq, hkv, d, t, nbt, pos, null):
    """The bf16 tensor-core body of K1. Slot tables run over distinct
    blocks 1..; with ``null`` the last slot's table is all null blocks. In
    the 4096-key tables most splits of the short slots hold no live tile."""
    nb = 1 + b * nbt
    kp = _rn(gen, nb, 2, hkv, t, d, dtype=torch.bfloat16)
    vp = _rn(gen, nb, 2, hkv, t, d, dtype=torch.bfloat16)
    tbl = torch.arange(1, nb, dtype=torch.int32, device="cuda").reshape(b, nbt)
    if null:
        tbl[-1] = 0
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = _rn(gen, b, w, hq, d, dtype=torch.bfloat16)
    assert pa._plan(q, kp, tbl)[0] == 1
    counter = pa.paged_decode_attention
    before = (counter.launches, counter.bf16_body_launches["mma"])
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos_t, 1, d ** -0.5)
    assert (counter.launches, counter.bf16_body_launches["mma"]) == (before[0] + 1,
                                                                      before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos_t, 1, d ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("d", [72, 40])
def test_paged_decode_other_bf16_head_dims_take_the_fma_body(gen, d):
    """bf16 head dims outside {64, 128, 256} stay on the FMA body."""
    b, w, hq, hkv, t, nbt = 3, 2, 8, 2, 16, 12
    nb = 1 + b * nbt
    kp = _rn(gen, nb, 2, hkv, t, d, dtype=torch.bfloat16)
    vp = _rn(gen, nb, 2, hkv, t, d, dtype=torch.bfloat16)
    tbl, pos = _table(b, nbt, w, t)
    q = _rn(gen, b, w, hq, d, dtype=torch.bfloat16)
    assert pa._plan(q, kp, tbl)[0] == 0
    counter = pa.paged_decode_attention
    before = (counter.launches, counter.bf16_body_launches["fma"])
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos, 0, d ** -0.5)
    assert (counter.launches, counter.bf16_body_launches["fma"]) == (before[0] + 1,
                                                                      before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos, 0, d ** -0.5),
           torch.bfloat16)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rn(gen, 1, 8, 2, 96, dtype=torch.bfloat16)  # head_dim 96: not built
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, 0.1)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.float(), q, 0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,w,hq,hkv,d,t,layers,nbt,layer", [
    (3, 1, 4, 2, 64, 16, 2, 8, 1),
    (3, 3, 8, 2, 128, 16, 3, 8, 2),
    (2, 2, 32, 8, 128, 32, 2, 4, 0),
    (1, 4, 32, 8, 128, 16, 2, 256, 1),   # one slot: many splits
    (8, 1, 32, 8, 128, 16, 2, 64, 1),
    (2, 4, 8, 2, 64, 32, 2, 20, 1),
])
def test_paged_decode_kvq_kernel_matches_plain(gen, dtype, b, w, hq, hkv, d, t, layers, nbt,
                                               layer):
    """K1q over an int8 pool whose null block holds codes 0 and scales 1."""
    nb = 1 + b * nbt
    kp, vp = _kvq(gen, nb, layers, hkv, t, d), _kvq(gen, nb, layers, hkv, t, d)
    for p in (kp, vp):
        p.q[0], p.s[0] = 0, 1.0
    tbl, pos = _table(b, nbt, w, t)
    q = _rn(gen, b, w, hq, d, dtype=dtype)
    before = (pa.paged_decode_attention.launches, pa.paged_decode_attention_kvq.launches)
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos, layer, d ** -0.5)
    assert (pa.paged_decode_attention.launches,
            pa.paged_decode_attention_kvq.launches) == (before[0], before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos, layer, d ** -0.5), dtype)


# the shapes of test_paged_decode_mma_body_matches_plain, then one whose
# rows were drawn at scales spread over decades
KVQ_MMA_CASES = [
    (3, 1, 2, 2, 64, 8, 24, [5, 100, 191], False, False),     # 1 row, T=8
    (3, 1, 8, 2, 128, 16, 20, [319, 64, 0], False, False),    # 4 rows (Llama-3's bundle)
    (2, 3, 8, 2, 128, 64, 6, [200, 381], True, False),        # 12 rows, one block a tile
    (2, 2, 16, 2, 256, 128, 4, [509, 130], True, False),      # 16 rows, T=128, D=256
    (2, 5, 8, 2, 64, 16, 10, [77, 150], True, False),         # 20 rows: two m-tiles
    (2, 4, 32, 4, 128, 32, 8, [100, 252], True, False),       # 32 rows, group 8
    (1, 1, 32, 8, 128, 16, 256, [4095], False, False),        # one slot of 4096 keys
    (8, 1, 32, 8, 128, 16, 256, [4095, 3001, 2048, 1500, 777, 300, 64, 5], True,
     False),                                                  # serve
    (2, 1, 32, 8, 256, 16, 128, [2047, 0], False, False),     # D=256, one live key
    (4, 1, 32, 8, 128, 16, 64, [1023, 700, 77, 3], True, True),  # per-row scales spread
]


@pytest.mark.parametrize("b,w,hq,hkv,d,t,nbt,pos,null,spread", KVQ_MMA_CASES)
def test_paged_decode_kvq_mma_body_matches_plain(gen, b, w, hq, hkv, d, t, nbt, pos, null,
                                                 spread):
    """K1q's tensor-core body (bf16 q over an int8 pool whose null block
    holds codes 0 and scales 1). With ``spread`` each K row is drawn at a
    scale log-uniform over 1e-3..30 and each V row over 1e-3..1 before it
    is quantized, so every key row has its own scale (a scale taken from
    the wrong row or block moves the output); V stays below 1 so one bf16
    ulp of the output is below the 2e-2 tolerance."""
    nb = 1 + b * nbt
    shape = (nb, 2, hkv, t, d)
    if spread:
        def draw(hi):
            lo = torch.rand(shape[:-1] + (1,), generator=gen, device="cuda")
            return (torch.randn(shape, generator=gen, device="cuda")
                    * 10 ** (-3 + lo * (3 + math.log10(hi))))
        kp, vp = kv.quantize_rows(draw(30.0)), kv.quantize_rows(draw(1.0))
    else:
        kp, vp = _kvq(gen, *shape), _kvq(gen, *shape)
    for p in (kp, vp):
        p.q[0], p.s[0] = 0, 1.0
    tbl = torch.arange(1, nb, dtype=torch.int32, device="cuda").reshape(b, nbt)
    if null:
        tbl[-1] = 0
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = _rn(gen, b, w, hq, d, dtype=torch.bfloat16)
    assert pa._plan(q, kp.q, tbl)[0] == 2
    counter = pa.paged_decode_attention_kvq
    before = (counter.launches, counter.bf16_body_launches["mma"])
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos_t, 1, d ** -0.5)
    assert (counter.launches, counter.bf16_body_launches["mma"]) == (before[0] + 1,
                                                                      before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos_t, 1, d ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 96)])
def test_paged_decode_kvq_other_shapes_take_the_fma_body(gen, dtype, d):
    """f32 q over an int8 pool, and bf16 q at a head dim outside {64, 128,
    256}, stay on the FMA body."""
    b, w, hq, hkv, t, nbt = 3, 2, 8, 2, 16, 12
    nb = 1 + b * nbt
    kp, vp = _kvq(gen, nb, 2, hkv, t, d), _kvq(gen, nb, 2, hkv, t, d)
    tbl, pos = _table(b, nbt, w, t)
    q = _rn(gen, b, w, hq, d, dtype=dtype)
    assert pa._plan(q, kp.q, tbl)[0] == 0
    counter = pa.paged_decode_attention_kvq
    before = (counter.launches, counter.body_launches["fma"])
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos, 1, d ** -0.5)
    assert (counter.launches, counter.body_launches["fma"]) == (before[0] + 1, before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos, 1, d ** -0.5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,hq,hkv,d,kw,s,start", [
    (2, 16, 4, 2, 64, 70, 96, 24),        # ragged window edge
    (1, 256, 32, 8, 128, 1000, 1024, 700),
    (2, 100, 8, 8, 128, 512, 512, 300),
    (1, 64, 4, 2, 64, 200, 256, 0),
])
def test_flash_chunk_kvq_kernel_matches_plain(gen, dtype, b, c, hq, hkv, d, kw, s, start):
    """K4 over strided views [:, 1, :, :kw] of an int8 row cache."""
    kc, vc = _kvq(gen, b, 3, hkv, s, d), _kvq(gen, b, 3, hkv, s, d)
    q = _rn(gen, b, c, hq, d, dtype=dtype)
    args = (q, kc.q[:, 1, :, :kw], kc.s[:, 1, :, :kw], vc.q[:, 1, :, :kw], vc.s[:, 1, :, :kw],
            d ** -0.5, start)
    before = fa.flash_attention_chunk_kvq.launches
    got = fa.flash_attention_chunk_kvq(*args)
    assert fa.flash_attention_chunk_kvq.launches == before + 1
    _check(got, fa.flash_attention_chunk_kvq_plain(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,c,hq,hkv,d,kw,s,start,off", [
    (2, 33, 8, 1, 128, 130, 160, 97, 0),      # start off the tile grid, ragged KW, group 8
    (2, 7, 4, 4, 64, 45, 64, 38, 0),          # C=7, group 1, KW = start + C
    (2, 50, 8, 8, 256, 300, 320, 250, 0),     # group 1, D=256, the diagonal straddles a tile
    (2, 50, 16, 2, 256, 300, 320, 250, 0),    # group 8, D=256
    (1, 256, 32, 8, 128, 4096, 4096, 3840, 0),  # the last chunk of a 4096-token prompt
    (2, 40, 8, 2, 128, 200, 256, 150, 1),     # views from key 1: scales 4 bytes off 16
    (1, 64, 4, 2, 64, 97, 128, 33, 3),        # scales 12 bytes off 16, ragged KW
])
def test_flash_chunk_kvq_edges_match_plain(gen, dtype, b, c, hq, hkv, d, kw, s, start, off):
    """K4 at the tensor-core body's edges (bf16; f32 runs the FMA body):
    strided views [:, 1, :, off:off + kw] of an int8 row cache."""
    kc, vc = _kvq(gen, b, 3, hkv, s + off, d), _kvq(gen, b, 3, hkv, s + off, d)
    q = _rn(gen, b, c, hq, d, dtype=dtype)
    win = slice(off, off + kw)
    args = (q, kc.q[:, 1, :, win], kc.s[:, 1, :, win], vc.q[:, 1, :, win],
            vc.s[:, 1, :, win], d ** -0.5, start)
    assert (args[2].data_ptr() % 16 != 0) == (off % 4 != 0)
    before = fa.flash_attention_chunk_kvq.launches
    got = fa.flash_attention_chunk_kvq(*args)
    assert fa.flash_attention_chunk_kvq.launches == before + 1
    _check(got, fa.flash_attention_chunk_kvq_plain(*args), dtype)


def test_kvq_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _rn(gen, 1, 1, 4, 64, dtype=torch.bfloat16)
    pool = _kvq(gen, 3, 1, 2, 16, 64)
    tbl = torch.ones((1, 2), dtype=torch.int32, device="cuda")
    pos = torch.zeros((1,), dtype=torch.int32, device="cuda")
    bad = kv.KVQ(pool.q, pool.s[..., :8].contiguous())  # scales of the wrong shape
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, bad, pool, tbl, pos, 0, 0.1)
    q40, pool40 = _rn(gen, 1, 1, 4, 40, dtype=torch.bfloat16), _kvq(gen, 3, 1, 2, 16, 40)
    with pytest.raises(ValueError):  # D % 16 != 0: no 16-byte loads of codes
        pa.paged_decode_attention(q40, pool40, pool40, tbl, pos, 0, 0.1)
    qc = _rn(gen, 1, 8, 4, 64, dtype=torch.bfloat16)
    slab = _kvq(gen, 1, 2, 32, 64)
    with pytest.raises(ValueError):
        fa.flash_attention_chunk_kvq(qc, slab.q, slab.s[..., :31], slab.q, slab.s, 0.1, 8)
    qc40, slab40 = _rn(gen, 1, 8, 4, 40, dtype=torch.bfloat16), _kvq(gen, 1, 2, 32, 40)
    with pytest.raises(ValueError):
        fa.flash_attention_chunk_kvq(qc40, slab40.q, slab40.s, slab40.q, slab40.s, 0.1, 8)


@pytest.mark.parametrize("b,v", [(16, 300), (8, 128256)])
def test_pick_orders_tied_candidates_on_the_card(gen, b, v):
    """_pick on the card keeps jax.lax.top_k's tie order (lower index first
    among equals): on bf16-valued logits with ties at the top-k cut and at
    the top-p crossing it draws what the CPU _pick draws on the same noise
    (tests/test_torch_ops.py holds the CPU _pick to the JAX one). CUDA's
    topk orders ties its own way, so this is the card's own check."""
    from nats_llm_studio_tpu_torch.engine import sampling

    temp = 0.8
    logits = (torch.randn((b, v), generator=gen, device="cuda") * 8).round() / 4
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    rows = torch.arange(b, device="cuda")[:, None]
    half = b // 2
    logits[rows[:half], order[:half, 3:8]] = logits[rows[:half, 0], order[:half, 3]][:, None]
    logits[rows[half:], order[half:, 1:7]] = logits[rows[half:, 0], order[half:, 1]][:, None]
    top_k = torch.tensor([5] * half + [0] * (b - half), device="cuda")
    z = torch.sort(logits, dim=-1, descending=True).values.double() / temp
    cum = torch.softmax(z, dim=-1).cumsum(dim=-1)
    top_p = torch.where(top_k > 0, 1.0, ((cum[:, 2] + cum[:, 3]) / 2).float())
    temps = torch.full((b,), temp, device="cuda")
    for _ in range(4):
        gumbel = -torch.log(-torch.log(
            torch.rand((b, v), generator=gen, device="cuda").clamp_min(1e-30)))
        got = sampling._pick(logits, gumbel, temps, top_k, top_p)
        want = sampling._pick(logits.cpu(), gumbel.cpu(), temps.cpu(), top_k.cpu(),
                              top_p.cpu())
        assert torch.equal(got.cpu(), want)


# -- the prefix cache's pool copies and the batched admits' shapes ------------------


@pytest.mark.parametrize("quant", [False, True])
def test_pool_copy_and_read_blocks_exact_on_the_card(gen, quant):
    """kv_pool_copy_block (copy-on-write) and kv_pool_read_blocks (a partial
    hit's fill) move bytes: on the card they equal the CPU's bit for bit,
    for a bf16 pool and a KVQ pair."""
    shape = (9, 2, 8, 16, 128)
    pool = _kvq(gen, *shape) if quant else _rn(gen, *shape, dtype=torch.bfloat16)
    leaves = (lambda p: [p.q, p.s]) if quant else (lambda p: [p])
    host = (kv.KVQ(pool.q.cpu(), pool.s.cpu()) if quant else pool.cpu())
    bids = torch.tensor([7, 2, 5, 1], dtype=torch.int32)
    for g, w in zip(leaves(kv.kv_pool_read_blocks(pool, bids)),
                    leaves(kv.kv_pool_read_blocks(host, bids))):
        assert g.is_cuda and torch.equal(g.cpu(), w)
    kv.kv_pool_copy_block(pool, 3, 6)
    kv.kv_pool_copy_block(host, 3, 6)
    for g, w in zip(leaves(pool), leaves(host)):
        assert torch.equal(g.cpu(), w)


def test_flash_kernel_batch4_chunk256(gen):
    """K2 at a batched short admit's shape: q[4, 256, 32, 128]."""
    q = _rn(gen, 4, 256, 32, 128, dtype=torch.bfloat16)
    k, v = (_rn(gen, 4, 256, 8, 128, dtype=torch.bfloat16) for _ in range(2))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, 128 ** -0.5)
    assert fa.flash_attention.launches == before + 1
    _check(got, fa.flash_attention_plain(q, k, v, 128 ** -0.5), torch.bfloat16)


@pytest.mark.parametrize("quant", [False, True])
def test_flash_chunk_kernels_batch4_chunk256(gen, quant):
    """K3 (bf16) and K4 (int8) at a batched chunked admit's shape: q[4, 256,
    32, 128] at start 256 over the slab [4, 8, 512, 128] of a row cache."""
    q = _rn(gen, 4, 256, 32, 128, dtype=torch.bfloat16)
    if quant:
        kc, vc = _kvq(gen, 4, 2, 8, 1024, 128), _kvq(gen, 4, 2, 8, 1024, 128)
        args = (q, kc.q[:, 1, :, :512], kc.s[:, 1, :, :512], vc.q[:, 1, :, :512],
                vc.s[:, 1, :, :512], 128 ** -0.5, 256)
        kern, plain = fa.flash_attention_chunk_kvq, fa.flash_attention_chunk_kvq_plain
    else:
        kc, vc = (_rn(gen, 4, 2, 8, 1024, 128, dtype=torch.bfloat16) for _ in range(2))
        args = (q, kc[:, 1, :, :512], vc[:, 1, :, :512], 128 ** -0.5, 256)
        kern, plain = fa.flash_attention_chunk, fa.flash_attention_chunk_plain
    before = kern.launches
    got = kern(*args)
    assert kern.launches == before + 1
    _check(got, plain(*args), torch.bfloat16)


def _ran_wgmma(kern, before):
    """The wrapper launched once more, and by the Hopper body."""
    return (kern.launches == before[0] + 1
            and kern.body_launches["wgmma"] == before[1] + 1)


@pytest.mark.parametrize("b,t,hq,hkv", [
    (1, 200, 8, 8),      # group 1, T off the 128-row tile
    (2, 300, 16, 4),     # group 4, a partial last q tile and kv tile
    (1, 129, 32, 4),     # one row past a tile: a q tile of one row
    (4, 256, 32, 8),     # the group admit: B = 4, T = 256
    (1, 77, 16, 2),      # group 8, one partial tile
    (2, 1000, 32, 8),    # many tiles, both ring stages reused
])
def test_flash_wgmma_body_matches_plain(gen, b, t, hq, hkv):
    """K2 on the Hopper body (bf16, D = 128): ragged q and kv edges arrive
    as TMA zero fill, and the mask still drops them."""
    q = _rn(gen, b, t, hq, 128, dtype=torch.bfloat16)
    k, v = (_rn(gen, b, t, hkv, 128, dtype=torch.bfloat16) for _ in range(2))
    before = (fa.flash_attention.launches, fa.flash_attention.body_launches["wgmma"])
    got = fa.flash_attention(q, k, v, 128 ** -0.5)
    assert _ran_wgmma(fa.flash_attention, before)
    _check(got, fa.flash_attention_plain(q, k, v, 128 ** -0.5), torch.bfloat16)


# b, c, hq, hkv, kw, s (the row cache's length), start, off (the window's
# first key in the cache)
WGMMA_CHUNK_CASES = [
    (1, 100, 8, 8, 300, 320, 200, 0),       # group 1, C and KW off the tile grid
    (2, 33, 16, 4, 161, 200, 128, 0),       # group 4, KW = start + C
    (1, 256, 32, 8, 700, 768, 444, 0),      # group 8, start off the grid
    (4, 256, 32, 8, 512, 1024, 256, 0),     # the group admit's second chunk
    (1, 256, 32, 8, 4096, 4096, 3840, 0),   # the last chunk of a 4096-token prompt
    (2, 50, 8, 2, 181, 260, 131, 3),        # a window from key 3
]


@pytest.mark.parametrize("b,c,hq,hkv,kw,s,start,off", WGMMA_CHUNK_CASES)
def test_flash_chunk_wgmma_body_matches_plain(gen, b, c, hq, hkv, kw, s, start, off):
    """K3 on the Hopper body (bf16, D = 128) over strided views
    [:, 1, :, off:off + kw] of a row cache."""
    kc, vc = (_rn(gen, b, 3, hkv, s + off, 128, dtype=torch.bfloat16) for _ in range(2))
    q = _rn(gen, b, c, hq, 128, dtype=torch.bfloat16)
    win = slice(off, off + kw)
    args = (q, kc[:, 1, :, win], vc[:, 1, :, win], 128 ** -0.5, start)
    before = (fa.flash_attention_chunk.launches, fa.flash_attention_chunk.body_launches["wgmma"])
    got = fa.flash_attention_chunk(*args)
    assert _ran_wgmma(fa.flash_attention_chunk, before)
    _check(got, fa.flash_attention_chunk_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("b,c,hq,hkv,kw,s,start,off", WGMMA_CHUNK_CASES + [
    (1, 64, 8, 1, 130, 130, 66, 0),         # layer 1's scales 8 bytes off 16 (S = 130, Hkv = 1)
    (2, 40, 12, 3, 97, 98, 57, 1),          # S = 99 with the window from key 1: 8 bytes off
])
def test_flash_chunk_kvq_wgmma_body_matches_plain(gen, b, c, hq, hkv, kw, s, start, off):
    """K4 on the Hopper body (bf16 q, D = 128): codes by TMA, scales by
    4-byte copies from views [:, 1, :, off:off + kw] of an int8 row cache
    [B, 3, Hkv, S(+off), 128], whose layer and window offsets can leave the
    scales' base off 16 bytes."""
    kc, vc = _kvq(gen, b, 3, hkv, s + off, 128), _kvq(gen, b, 3, hkv, s + off, 128)
    q = _rn(gen, b, c, hq, 128, dtype=torch.bfloat16)
    win = slice(off, off + kw)
    args = (q, kc.q[:, 1, :, win], kc.s[:, 1, :, win], vc.q[:, 1, :, win], vc.s[:, 1, :, win],
            128 ** -0.5, start)
    assert (args[2].data_ptr() % 16 != 0) == ((hkv * (s + off) + off) % 4 != 0)
    before = (fa.flash_attention_chunk_kvq.launches,
              fa.flash_attention_chunk_kvq.body_launches["wgmma"])
    got = fa.flash_attention_chunk_kvq(*args)
    assert _ran_wgmma(fa.flash_attention_chunk_kvq, before)
    _check(got, fa.flash_attention_chunk_kvq_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_prefill_chunk_group_matches_single_admits(gen, kv_quant):
    """The prompt-end logits of each row of a 4-row chunked group prefill
    (K2, then K3 or K4 over [4, C] chunks) against the same prompts
    prefilled alone in [1, C] chunks, on a 2-layer model with Llama-3-8B's
    head shape, by the model gate of chip_smoke.py: relative L2 <= 2e-2 in
    float32 on the plain path, and in bf16 the kernel path's group no
    further from the float32 plain path's single admits than 1.25 x the
    bf16 plain path's single admits are."""
    from nats_llm_studio_tpu_torch.models import llama
    from nats_llm_studio_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(vocab_size=1024, d_model=512, n_layers=2, n_heads=32, n_kv_heads=8,
                      head_dim=128, d_ff=1024, max_seq_len=1024, dtype="bfloat16",
                      kv_quant=kv_quant)
    params = {"embed": _rn(gen, 1024, 512, dtype=torch.float32) * 0.02,
              "out_norm": torch.ones(512, device="cuda"),
              "blocks": {"attn_norm": torch.ones(2, 512, device="cuda"),
                         "ffn_norm": torch.ones(2, 512, device="cuda"),
                         **{k: _rn(gen, 2, *s, dtype=torch.float32) * 0.02 for k, s in (
                             ("wq", (512, 4096)), ("wk", (512, 1024)), ("wv", (512, 1024)),
                             ("wo", (4096, 512)), ("w_gate", (512, 1024)),
                             ("w_up", (512, 1024)), ("w_down", (1024, 512)))}}}
    C, ns = 256, [700, 513, 650, 300]
    prompts = [torch.randint(0, 1024, (n,), generator=gen, device="cuda", dtype=torch.int32)
               for n in ns]

    def run(dtype, attn, rows):
        p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()} if isinstance(v, dict)
                 else v.to(dtype)) for k, v in params.items()}
        c = cfg.with_(dtype="float32" if dtype == torch.float32 else "bfloat16")
        km, vm = llama.make_cache(c, len(rows), 1024, device="cuda")
        out = [None] * len(rows)
        for start in range(0, max(ns[i] for i in rows), C):
            toks = torch.zeros((len(rows), C), dtype=torch.int32, device="cuda")
            for r, i in enumerate(rows):
                seg = prompts[i][start:start + C]
                toks[r, :len(seg)] = seg
            last = [min(max(ns[i] - 1 - start, 0), C - 1) for i in rows]
            lg, km, vm = llama.forward(p, c, toks, km, vm,
                                       torch.full((len(rows),), start, dtype=torch.int32),
                                       attn_window=min(1 << (start + C - 1).bit_length(), 1024),
                                       logit_positions=torch.tensor(last), uniform_start=True,
                                       attn=attn)
            for r, i in enumerate(rows):
                if (ns[i] - 1) // C == start // C:
                    out[r] = lg[r, 0].float()
        return out

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    alone32 = [run(torch.float32, llama.PLAIN, [i])[0] for i in range(4)]
    group32 = run(torch.float32, llama.PLAIN, [0, 1, 2, 3])
    alone_bf = [run(torch.bfloat16, llama.PLAIN, [i])[0] for i in range(4)]
    before = fa.flash_attention_chunk_kvq.launches + fa.flash_attention_chunk.launches
    group_bf = run(torch.bfloat16, llama.KERNELS, [0, 1, 2, 3])
    assert fa.flash_attention_chunk_kvq.launches + fa.flash_attention_chunk.launches > before
    for i in range(4):
        assert torch.isfinite(group_bf[i]).all()
        assert rel(group32[i], alone32[i]) <= 2e-2
        assert rel(group_bf[i], alone32[i]) <= 1.25 * rel(alone_bf[i], alone32[i])


# -- speculative verify: K1 and K1q at W = k + 1 and the acceptance rule ------------


@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
def test_paged_decode_verify_width7_one_cta_over_the_bundle(gen, quant):
    """The verify shape: W = 7 query rows a slot (k = 6 drafts) with
    Llama-3's GQA group of 4, a 28-row bundle (two m16 tiles) that one CTA
    of the tensor-core body holds whole, over slots whose 7 fresh rows
    cross a block edge; the tensor-core body (plan body 1, or 2 over an
    int8 pool) and one launch."""
    b, w, hq, hkv, d, t, nbt = 4, 7, 32, 8, 128, 16, 64
    pos = [1017 - w, 250, 13, 700]
    nb = 1 + b * nbt
    shape = (nb, 2, hkv, t, d)
    if quant:
        kp, vp = _kvq(gen, *shape), _kvq(gen, *shape)
        codes, counter = kp.q, pa.paged_decode_attention_kvq
    else:
        kp, vp = _rn(gen, *shape, dtype=torch.bfloat16), _rn(gen, *shape, dtype=torch.bfloat16)
        codes, counter = kp, pa.paged_decode_attention
    tbl = torch.arange(1, nb, dtype=torch.int32, device="cuda").reshape(b, nbt)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = _rn(gen, b, w, hq, d, dtype=torch.bfloat16)
    assert pa._plan(q, codes, tbl)[0] == (2 if quant else 1)
    before = (counter.launches, counter.bf16_body_launches["mma"])
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos_t, 1, d ** -0.5)
    assert (counter.launches, counter.bf16_body_launches["mma"]) == (before[0] + 1,
                                                                      before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos_t, 1, d ** -0.5),
           torch.bfloat16)


def _bundle_pools(gen, quant, nb, hkv, t, d=128, layers=2):
    """A bf16 pool or an int8 one (its null block 0 holding codes 0 and
    scales 1) of ``nb`` blocks."""
    shape = (nb, layers, hkv, t, d)
    if not quant:
        return _rn(gen, *shape, dtype=torch.bfloat16), _rn(gen, *shape, dtype=torch.bfloat16)
    kp, vp = _kvq(gen, *shape), _kvq(gen, *shape)
    for p in (kp, vp):
        p.q[0], p.s[0] = 0, 1.0
    return kp, vp


def _live_tables(b, nbt, w, t, pos, null):
    """Each slot's live blocks on distinct ids 1..; every entry past them is
    the null block 0 (with ``null`` the last slot's whole table too).
    Returns (tbl, the pool's block count)."""
    tbl = torch.zeros((b, nbt), dtype=torch.int32)
    nxt = 1
    for i, p in enumerate(pos):
        live = (p + w - 1) // t + 1
        if not (null and i == b - 1):
            tbl[i, :live] = torch.arange(nxt, nxt + live, dtype=torch.int32)
            nxt += live
    return tbl.cuda(), nxt


BUNDLE_CASES = [
    # b, w, hq, hkv, t, nbt, pos, null
    (8, 1, 32, 8, 16, 256, [4095, 0, 1, 2, 3, 4, 5, 5], False),  # one long slot, seven at 0-5
    (8, 1, 32, 8, 16, 64, [0] * 8, False),                       # every slot at position 0
    (1, 1, 32, 8, 16, 256, [4095], False),                       # B = 1
    (64, 1, 32, 8, 16, 16, [(37 * i) % 250 for i in range(64)], True),  # B = 64
    (4, 2, 8, 8, 8, 64, [500, 3, 257, 130], True),               # group 1, W = 2, T = 8
    (4, 7, 32, 8, 32, 32, [1017 - 7, 250, 13, 700], False),      # group 4, W = 7, T = 32
    (3, 7, 64, 8, 64, 16, [1000, 63, 5], True),                  # group 8, W = 7: two CTAs of two
    (3, 1, 64, 8, 16, 64, [1023, 512, 9], False),                # group 8, W = 1
    (2, 4, 16, 2, 128, 8, [1000, 129], True),                    # T = 128: a block holds two tiles
]


@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
@pytest.mark.parametrize("b,w,hq,hkv,t,nbt,pos,null", BUNDLE_CASES)
def test_paged_decode_d128_bundles_match_plain(gen, quant, b, w, hq, hkv, t, nbt, pos, null):
    """The tensor-core body at D = 128 where its split, its two-tile CTA or
    its row-split merge could go wrong: one long slot beside slots of one
    tile, slots at position 0, 1 to 64 slots, tables whose dead entries are
    the null block, groups 1 to 8 (56 rows: two CTAs of two m-tiles a kv
    head), W = 1, 2 and 7, blocks of 8 to 128 tokens; one launch, on the
    tensor-core body."""
    tbl, nb = _live_tables(b, nbt, w, t, pos, null)
    kp, vp = _bundle_pools(gen, quant, nb, hkv, t)
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    q = _rn(gen, b, w, hq, 128, dtype=torch.bfloat16)
    counter = pa.paged_decode_attention_kvq if quant else pa.paged_decode_attention
    assert pa._plan(q, kp.q if quant else kp, tbl)[0] == (2 if quant else 1)
    before = (counter.launches, counter.bf16_body_launches["mma"])
    got = pa.paged_decode_attention(q, kp, vp, tbl, pos_t, 1, 128 ** -0.5)
    assert (counter.launches, counter.bf16_body_launches["mma"]) == (before[0] + 1,
                                                                      before[1] + 1)
    _check(got, pa.paged_decode_attention_plain(q, kp, vp, tbl, pos_t, 1, 128 ** -0.5),
           torch.bfloat16)


@pytest.mark.parametrize("v", [300, 128256])
def test_spec_accept_from_noise_on_the_card_equals_cpu(gen, v):
    """spec_accept_from_noise on the card takes what the CPU takes on the
    same noise (tests/test_torch_spec.py holds the CPU to the JAX rule):
    greedy, sampled, top-k and top-p rows, on bf16-valued logits with ties
    at the top-k cut, drafts near each position's argmax."""
    from nats_llm_studio_tpu_torch.engine import sampling

    b, k = 8, 6
    logits = (torch.randn((b, k + 1, v), generator=gen, device="cuda") * 8).round() / 4
    order = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    tie = logits.gather(2, order[..., 3:4])
    logits.scatter_(2, order[..., 3:8], tie.expand(-1, -1, 5))  # ranks 3..7 tied
    temp = torch.tensor([0.0, 0.0, 0.8, 1.0, 0.7, 1.2, 0.9, 0.6], device="cuda")
    top_k = torch.tensor([0, 0, 0, 5, 0, 5, 40, 0], device="cuda")
    top_p = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.9, 0.8, 0.95, 1.0], device="cuda")
    dlen = torch.tensor([6, 3, 6, 6, 4, 2, 6, 0], dtype=torch.int32, device="cuda")
    for _ in range(3):
        pick = torch.randint(0, 3, (b, k), generator=gen, device="cuda")
        drafts = order[:, :k].gather(2, pick[..., None])[..., 0].int()
        u = torch.rand((b, k + 1), generator=gen, device="cuda")
        gumbel = -torch.log(-torch.log(
            torch.rand((b, k + 1, v), generator=gen, device="cuda").clamp_min(1e-30)))
        got = sampling.spec_accept_from_noise(logits, drafts, dlen, u, gumbel, temp, top_k,
                                              top_p)
        want = sampling.spec_accept_from_noise(*(x.cpu() for x in (
            logits, drafts, dlen, u, gumbel, temp, top_k, top_p)))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


# -- overload and supervision on the card ------------------------------------

# a small bf16 model at head_dim 128 (so decode takes K1's tensor-core body)
_SMALL = dict(vocab=512, d_model=256, n_heads=2, n_kv_heads=1, head_dim=128, d_ff=512,
              rope_theta=10000.0, rms_eps=1e-5, context=1024, n_layers=2)
_SMALL_MID = "small/bf16"


def _small_registry(tmp_path, **kw):
    """A TorchRegistry on the card over a 2-layer bf16 GGUF written here
    (chip_smoke.write_gguf, random weights from seed 3)."""
    import chip_smoke
    from nats_llm_studio_tpu_torch.serve.registry import TorchRegistry
    from nats_llm_studio_tpu_torch.store import ModelStore

    d = tmp_path / "models" / _SMALL_MID
    d.mkdir(parents=True)
    chip_smoke.write_gguf(torch, d / "m.gguf", _SMALL["n_layers"], 3, widths=_SMALL)
    return TorchRegistry(ModelStore(tmp_path / "models"), device="cuda", max_seq_len=1024,
                         max_batch_slots=4, prefix_cache_blocks=0, spec_decode_k=0, **kw)


async def _chat(eng, n=24, **extra):
    return await eng.chat({"model": _SMALL_MID, "temperature": 0, "max_tokens": n,
                           "messages": [{"role": "user", "content": "count the waves"}],
                           **extra})


def test_headroom_signal_makes_no_cuda_call_per_tick(gen, tmp_path, monkeypatch):
    """The brownout signal comes from the admission ledger: over a served
    chat's owner-loop passes (and a thousand direct reads) no
    ``torch.cuda.mem_get_info`` call is made; the card's budget was read
    once, when the registry was built."""
    import asyncio

    registry = _small_registry(tmp_path, obs_recorder_interval_ms=1.0)
    calls = []
    real = torch.cuda.mem_get_info
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: calls.append(a) or real(*a))

    async def run():
        eng = await registry.get_engine(_SMALL_MID)
        await _chat(eng, n=64)
        frac = [registry._hbm_headroom_frac() for _ in range(1000)]
        ticks = eng.batcher.recorder.frames_sampled
        await registry.close()
        return frac, ticks

    frac, ticks = asyncio.run(run())
    assert calls == [] and ticks > 0
    assert 0.0 < frac[0] < 1.0 and len(set(frac)) == 1


def test_crashed_batcher_memory_is_returned_on_the_card(gen, tmp_path):
    """A crash that escapes the owner loop, then the restart: the unload
    frees the crashed batcher's params and pool (its frames were dropped,
    so nothing pins them), and the allocated bytes after the restart are
    within 1% of those before the crash; the same greedy text follows."""
    import asyncio

    class Crash(BaseException):
        pass

    registry = _small_registry(tmp_path, restart_backoff_s=0.01)

    async def run():
        eng = await registry.get_engine(_SMALL_MID)
        first = await _chat(eng)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        b = eng.batcher
        prog = b._decode_pos_pallas

        def faulty(*a):
            b._decode_pos_pallas = prog
            raise Crash("injected")

        b._decode_pos_pallas = faulty
        with pytest.raises(Exception, match="engine crashed"):
            await _chat(eng)
        assert await registry.restart_engine(_SMALL_MID, "crashed") == "restarted"
        del eng, b, prog, faulty
        import gc

        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        again = await _chat(await registry.get_engine(_SMALL_MID))
        await registry.close()
        return first, again, before, after

    first, again, before, after = asyncio.run(run())
    assert abs(after - before) <= 0.01 * before, (before, after)
    assert again["choices"][0]["message"] == first["choices"][0]["message"]


def test_kvq_slot_suspend_and_resume_on_the_card(gen, tmp_path):
    """Slot suspend under int8 KV on the card: B's admit finds a 30-block
    pool short and suspends A (its codes and scales read back to host
    memory together); A resumes into fresh blocks once B ends and decodes
    through K1q the same greedy tokens as beside B on an ample pool.
    Nothing is shed and the pool is free after."""
    import asyncio

    from nats_llm_studio_tpu_torch.engine.generator import SamplingParams
    from nats_llm_studio_tpu_torch.serve.batcher import ContinuousBatcher

    registry = _small_registry(tmp_path, kv_quant="int8")
    p_a = [(i * 7 + 3) % 509 for i in range(300)]
    p_b = [(i * 11 + 5) % 509 for i in range(300)]

    async def pressure(b):
        started = asyncio.get_running_loop().create_future()

        async def run_a():
            out = []
            async for t in b.submit(p_a, SamplingParams(temperature=0.0, max_tokens=24)):
                out.append(t)
                if len(out) == 2 and not started.done():
                    started.set_result(None)
            return out

        ta = asyncio.ensure_future(run_a())
        await started
        got_b = [t async for t in b.submit(p_b, SamplingParams(temperature=0.0, max_tokens=8))]
        return await ta, got_b

    async def run():
        eng = await registry.get_engine(_SMALL_MID)
        params, cfg = eng.batcher.params, eng.batcher.cfg
        out = []
        for blocks in (0, 30):
            b = ContinuousBatcher(params, cfg, max_slots=2, max_seq_len=1024, decode_burst=1,
                                  admit_coalesce_ms=0.0, kv_pool_blocks=blocks)
            try:
                launches = pa.paged_decode_attention_kvq.launches
                toks = await pressure(b)
                while not b.idle:
                    await asyncio.sleep(0.01)
                out.append((toks, dict(b._suspend_stats), b.stats.shed_cause_counts(),
                            b.pool_stats(), pa.paged_decode_attention_kvq.launches - launches))
            finally:
                b.stop()
        await registry.close()
        return out

    (want, _, _, _, _), (got, sus, sheds, pool, launches) = asyncio.run(run())
    assert got == want, "the resumed int8 slot departed from its ample-pool tokens"
    assert sus["suspended_total"] >= 1 and sus["resumed_total"] == sus["suspended_total"]
    assert sheds.get("kv_pool", 0) == 0
    assert pool["blocks_free"] == pool["blocks_total"] and pool["kv_quant"] == "int8"
    assert launches > 0  # K1q decoded the resumed slot


def test_profile_trace_names_the_paged_decode_kernel(gen, tmp_path):
    """The worker's profile subject (torch.profiler initialized once on the
    event loop's thread, the capture in a worker thread while the owner
    thread launches) exports a Chrome trace that names K1's tensor-core
    kernel."""
    import asyncio
    import json

    from nats_llm_studio_tpu_torch.config import WorkerConfig
    from nats_llm_studio_tpu_torch.serve.worker import Worker

    class Msg:  # what on_profile reads of a NATS message, and its reply
        subject, reply, headers = "lmstudio.profile", "inbox", {}
        payload = b'{"seconds": 1.5}'

        async def respond(self, payload, headers=None):
            self.answer = json.loads(payload)

    registry = _small_registry(tmp_path)
    worker = Worker(WorkerConfig(), registry)

    async def run():
        eng = await registry.get_engine(_SMALL_MID)
        await _chat(eng, n=8)  # warm: kernels loaded, first launches done
        answers = []
        for _ in range(2):  # the first capture in the process, and a later one
            msg = Msg()
            cap = asyncio.ensure_future(worker.on_profile(msg))
            await asyncio.sleep(0.3)
            await _chat(eng, n=400)
            await cap
            answers.append(msg.answer)
        await registry.close()
        return answers

    for answer in asyncio.run(run()):
        assert answer["ok"], answer
        assert "paged_decode_mma_kernel" in open(answer["data"]["trace_file"]).read()


# -- the efficiency plane and cluster membership on the card ---------------------


def test_chip_peaks_of_the_card_in_use(gen, monkeypatch):
    """The card's name finds its row of the H100 table (the SXM part on the
    H100 80GB HBM3), and ``chip_peaks`` of the device reads that row."""
    from nats_llm_studio_tpu_torch.obs import roofline

    monkeypatch.delenv("TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TPU_HBM_GBPS", raising=False)
    name = torch.cuda.get_device_name(0)
    peaks = roofline.resolve_chip_peaks(name)
    assert peaks != roofline._CPU_PEAKS, name
    if "H100 80GB HBM3" in name:
        assert peaks == (989e12, 3.35e12)
    assert roofline.chip_peaks(torch.device("cuda", 0)) == peaks


def test_hbm_ledger_over_memory_stats_during_a_burst(gen):
    """Allocations freed within a tick leave the ledger quiet; tensors that
    stay and grow for three ticks fire one ``hbm_drift``, after which the
    footprint holds and the ledger is quiet again."""
    from nats_llm_studio_tpu_torch.obs import roofline

    dev = torch.device("cuda", 0)
    events = []
    led = roofline.HbmLedger(
        {"base": lambda: 0}, bytes_in_use_fn=lambda: roofline._default_bytes_in_use(dev),
        drift_threshold_bytes=32 << 20, sustain_ticks=3,
        emit_fn=lambda kind, **f: events.append(kind))
    for _ in range(8):
        x = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        del x
        led.tick()
    assert events == [] and led.last_sample()["bytes_in_use"] > 0
    held = []
    for i in range(6):
        if i < 3:
            held.append(torch.empty(48 << 20, dtype=torch.uint8, device=dev))
        led.tick()
    assert events == ["hbm_drift"] and led.drift_events == 1


def test_advert_and_ledger_make_no_cuda_call_per_read(gen, tmp_path, monkeypatch):
    """With an engine loaded and a chat served: a thousand adverts read the
    headroom from the admission ledger and make no CUDA call; the registry's
    HBM ledger, ticked by the recorder over the chat, priced the engine and
    stayed quiet; each program's analytic flops are the count of the shapes
    it dispatched on the card."""
    import asyncio

    from nats_llm_studio_tpu_torch.config import WorkerConfig
    from nats_llm_studio_tpu_torch.obs import roofline
    from nats_llm_studio_tpu_torch.serve.worker import Worker

    registry = _small_registry(tmp_path, obs_recorder_interval_ms=1.0)
    worker = Worker(WorkerConfig(), registry)

    async def run():
        eng = await registry.get_engine(_SMALL_MID)
        b = eng.batcher
        shapes = []
        for name in ("_admit_fused_paged", "_decode_pos_pallas"):
            inner = getattr(b, name)

            def spy(*a, _inner=inner, _name=name, **kw):
                sh = b._shape
                shapes.append((_name[1:], (*sh[:2], tuple(sh[2]), *sh[3:])))
                return _inner(*a, **kw)

            setattr(b, name, spy)
        await _chat(eng, n=32)
        flops, _ = b.stats.cost_counters()
        calls = []
        for fn in ("mem_get_info", "memory_stats", "memory_allocated", "memory_reserved",
                   "synchronize", "get_device_name"):
            real = getattr(torch.cuda, fn)
            monkeypatch.setattr(torch.cuda, fn,
                                lambda *a, _r=real, _n=fn, **k: calls.append(_n) or _r(*a, **k))
        adverts = [worker.build_advert() for _ in range(1000)]
        monkeypatch.undo()
        sample = registry.hbm_ledger.last_sample()
        await registry.close()
        return adverts, calls, sample, flops, shapes, eng.cfg

    adverts, calls, sample, flops, shapes, cfg = asyncio.run(run())
    assert calls == []
    assert 0.0 < adverts[0]["hbm_headroom"] <= 1.0 and adverts[0]["slots"] == 4
    assert adverts[0]["models"] == [_SMALL_MID]
    assert sample["bytes_in_use"] > 0 and sample["components"]["engines"] > 0
    assert registry.hbm_ledger.drift_events == 0
    fc, want = roofline.ForwardCost(cfg), {}
    for name, sh in shapes:
        want[name] = want.get(name, 0.0) + fc(*sh)[0]
    assert {k: flops[k] for k in want} == pytest.approx(want, rel=1e-12)
