"""repro_torch's int8 quantize / dequantize and top-k kernels against the
reference's.

The port's plain versions (``quantize_torch``, ``dequantize_torch``,
``topk_compress_torch``) compute what the reference computes under ``jit``
on XLA:CPU, rounding for rounding, so on the same numpy-made inputs they
must equal ``quantize_ref`` / ``dequantize_ref`` / ``topk_compress_ref``
(jitted) and the Pallas kernels in interpret mode BITWISE: q, scale,
values and indices.  XLA:CPU computes the scale as
``fma(max|x|, fl(1/127), 1e-12)`` and the compressor's residual as
``fma(-q, scale, x)``; the inputs span twelve decades of magnitude, so the
unfused forms would differ on some rows.  Top-k keeps ``lax.top_k``'s
order: |x| descending, ties to the lower index.  The ``cuda``-marked tests
at the end hold the CUDA kernels against the plain versions on the card,
bitwise, at the training path's shapes; they need no JAX
(``python -m pytest -q -m cuda tests/test_torch_quantize_topk.py``).
"""
import fractions
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cases  # noqa: E402,F401  (caps torch's CPU threads)

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.quantize import (  # noqa: E402
    dequantize,
    dequantize_blocks,
    dequantize_torch,
    fma32,
    quantize,
    quantize_blocks,
    quantize_torch,
)
from repro_torch.kernels.topk_compress import (  # noqa: E402
    topk_compress,
    topk_compress_blocks,
    topk_compress_torch,
)
from repro_torch.kernels.topk_compress import kernel as tkernel  # noqa: E402


@pytest.fixture(scope="module")
def ref():
    """The reference's kernels, refs and wrappers (JAX); the card machine
    has no JAX, so only the comparisons with the reference need it."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import quantize as rq
    from repro.kernels import topk_compress as rt
    from repro.kernels.quantize.kernel import (dequantize_kernel,
                                               quantize_kernel)
    from repro.kernels.topk_compress.kernel import topk_compress_kernel
    return types.SimpleNamespace(
        jax=jax, jnp=jnp,
        quantize_ref=jax.jit(rq.quantize_ref),
        dequantize_ref=jax.jit(rq.dequantize_ref),
        topk_ref=jax.jit(rt.topk_compress_ref, static_argnums=1),
        quantize_kernel=quantize_kernel, dequantize_kernel=dequantize_kernel,
        topk_kernel=topk_compress_kernel, quantize=rq.quantize,
        dequantize=rq.dequantize, topk_compress=rt.topk_compress)


def rows(seed, nb, block, *, ties=False, zero_rows=0):
    """float32 rows whose magnitudes span 1e-12 to 1e2 (one per row), with
    optional repeated magnitudes (ties, both signs) and all-zero rows."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-12, 2, size=(nb, 1))
    x = rng.standard_normal((nb, block)) * mag
    if ties:
        x = np.round(x / mag * 2) / 2 * mag          # few distinct values
        x[:, ::7] = -x[:, ::7]
        x[:, ::5] = 0.0
    x[:zero_rows] = 0.0
    return x.astype(np.float32)


def as_bf16(x):
    """(numpy float32 of bf16-representable values, torch bf16)."""
    t = torch.as_tensor(x).to(torch.bfloat16)
    return t.float().numpy(), t


def bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16 if a.dtype.itemsize == 2 else
                  {1: np.uint8, 4: np.uint32}[a.dtype.itemsize])


def assert_bitwise(got, want):
    got = got.float() if got.dtype == torch.bfloat16 else got
    got = got.numpy()
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    bad = bits(got) != bits(want)
    assert not bad.any(), f"{int(bad.sum())} of {bad.size} differ"


QUANT_CASES = [(64, 1536, False, 0), (37, 256, True, 3), (5, 8960, False, 1),
               (3, 1000, True, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantize_plain_equals_jitted_ref(ref, case, dtype):
    nb, block, ties, zeros = case
    x = rows(1, nb, block, ties=ties, zero_rows=zeros)
    if dtype == "bfloat16":
        x, xt = as_bf16(x)
        xj = ref.jnp.asarray(x).astype(ref.jnp.bfloat16)
    else:
        xt, xj = torch.as_tensor(x), x
    q, scale = quantize_torch(xt)
    wq, ws = ref.quantize_ref(xj)
    assert_bitwise(q, wq)
    assert_bitwise(scale, ws)


def test_quantize_scale_is_the_fused_form():
    """The scale is fma(max, fl(1/127), 1e-12): on rows of tiny magnitude
    the unfused ``max * fl(1/127) + 1e-12`` differs (so the test above
    tells the two forms apart)."""
    x = torch.as_tensor(rows(2, 4000, 64))
    _, scale = quantize_torch(x)
    m = x.abs().amax(-1, keepdim=True)
    unfused = m * (torch.tensor(1.0) / 127.0) + 1e-12
    assert (unfused != scale).any()


@pytest.mark.parametrize("case", QUANT_CASES[:2])
def test_quantize_plain_equals_pallas_interpret(ref, case):
    nb, block, ties, zeros = case
    x = rows(3, nb, block, ties=ties, zero_rows=zeros)
    q, scale = quantize_torch(torch.as_tensor(x))
    wq, ws = ref.quantize_kernel(x, interpret=True)
    assert_bitwise(q, wq)
    assert_bitwise(scale, ws)
    got = dequantize_torch(q, scale)
    assert_bitwise(got, ref.dequantize_kernel(np.asarray(wq), np.asarray(ws),
                                              interpret=True))
    assert_bitwise(got, ref.dequantize_ref(np.asarray(wq), np.asarray(ws)))


@pytest.mark.parametrize("n", [5000, 1024, 7])
def test_flat_wrappers_pad_the_ragged_final_block(ref, n):
    x = rows(4, 1, n, ties=True)[0]
    q, scale, size = quantize(torch.as_tensor(x), block=1024)
    wq, ws, wsize = ref.quantize(x, block=1024, interpret=True)
    assert size == wsize == n
    assert_bitwise(q, wq)
    assert_bitwise(scale, ws)
    assert_bitwise(dequantize(q, scale, size, (n,)),
                   ref.dequantize(wq, ws, wsize, (n,), interpret=True))
    v, i, nb = topk_compress(torch.as_tensor(x), ratio=0.01, block=1024)
    wv, wi, wnb = ref.topk_compress(x, ratio=0.01, block=1024,
                                    interpret=True)
    assert nb == wnb
    assert_bitwise(v, wv)
    assert_bitwise(i, wi)


def test_residual_and_pod_sum_equal_the_jitted_compressor(ref):
    """quantize's residual is the jitted Int8Compressor's (row-wise and
    blockwise), and dequantize with accumulate gives its decode_sum over
    three pods (an fma chain, pod by pod)."""
    from repro.optim.compression import Int8Compressor
    comp = Int8Compressor()
    x = rows(5, 3 * 40, 512).reshape(3, 40, 512)
    payload, res = ref.jax.jit(ref.jax.vmap(comp.encode))(x)
    total = ref.jax.jit(lambda p: comp.decode_sum(p, (40, 512),
                                                  ref.jnp.float32))(payload)
    acc = torch.zeros(40, 512)
    for p in range(3):
        q, scale, r = quantize_torch(torch.as_tensor(x[p]), residual=True)
        assert_bitwise(q, payload["q"][p])
        assert_bitwise(r, res[p])
        dequantize_blocks(q, scale, out=acc)
    assert_bitwise(acc, total)
    flat = rows(6, 1, 3000)[0]
    _, res1 = ref.jax.jit(comp.encode)(flat)
    padded = torch.nn.functional.pad(torch.as_tensor(flat), (0, 72))
    _, _, r1 = quantize_torch(padded.reshape(3, 1024), residual=True)
    assert_bitwise(r1.reshape(-1)[:3000], res1)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, on random operands and on
    operands whose float64 sum lands exactly on a float32 midpoint (where
    rounding twice would err)."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (rng.standard_normal(2000) * 10.0 ** rng.integers(-9, 3, 2000)
         ).astype(np.float32)
    # a * b = 1 + 2^-24 (a float32 midpoint) and c = +-2^-60: the float64
    # sum rounds back onto the midpoint, the exact sum lies off it
    a[:4] = np.float32(1 + 2 ** -12)
    b[:4] = np.float32(1 - 2 ** -12 + 2 ** -23)
    c[:4] = np.float32([2 ** -60, -2 ** -60, 2 ** -80, -2 ** -80])
    got = fma32(*(torch.as_tensor(v) for v in (a, b, c))).numpy()
    for i in range(len(a)):
        exact = (fractions.Fraction(float(a[i])) * fractions.Fraction(
            float(b[i])) + fractions.Fraction(float(c[i])))
        lo = np.float32(float(exact))       # within one float32 ulp
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(fractions.Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        nearest = [v for v, e in zip(cands, errs) if e == best]
        want = (nearest[0] if len(nearest) == 1 else
                next(v for v in nearest if not bits(v) & 1))
        assert bits(got[i]) == bits(want), (i, a[i], b[i], c[i])


TOPK_CASES = [(8, 1024, 10, False), (6, 1536, 15, True), (3, 256, 2, True),
              (2, 4096, 300, True), (4, 100, 100, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_plain_equals_jitted_ref(ref, case, dtype):
    nb, block, k, ties = case
    x = rows(8, nb, block, ties=ties, zero_rows=1)
    if dtype == "bfloat16":
        x, xt = as_bf16(x)
        xj = ref.jnp.asarray(x).astype(ref.jnp.bfloat16)
    else:
        xt, xj = torch.as_tensor(x), x
    v, i = topk_compress_torch(xt, k)
    wv, wi = ref.topk_ref(xj, k)
    assert_bitwise(i, wi)
    assert_bitwise(v, wv)


def test_topk_plain_equals_pallas_interpret(ref):
    x = rows(9, 4, 1024, ties=True)
    v, i = topk_compress_torch(torch.as_tensor(x), 10)
    wv, wi = ref.topk_kernel(x, k=10, interpret=True)
    assert_bitwise(i, wi)
    assert_bitwise(v, wv)


def test_topk_ties_go_to_the_lower_index():
    x = torch.tensor([[1.0, -3.0, 3.0, 2.0, -3.0, 0.0, 3.0, -1.0]])
    v, i = topk_compress_torch(x, 5)
    assert i.tolist() == [[1, 2, 4, 6, 3]]
    assert v.tolist() == [[-3.0, 3.0, -3.0, 3.0, 2.0]]


def test_cpu_tensors_take_the_plain_versions():
    kbuild.reset_launches()
    x = torch.as_tensor(rows(10, 4, 512, ties=True))
    q, s = quantize_blocks(x)
    dequantize_blocks(q, s)
    topk_compress_blocks(x, 5)
    assert sum(kbuild.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        quantize_blocks(x.to("meta"))


# ---------------------------------------------------------------------------
# The CUDA kernel's two routes, emulated in torch on the CPU
# ---------------------------------------------------------------------------
def composite_keys(x):
    """(c, b): each entry's composite key ``(bits(|x|) << b) | (n - 1 -
    i)`` as int64, unique within its row, and the index width b."""
    n = x.shape[-1]
    b = tkernel.index_bits(n)
    keys = (x.contiguous().view(torch.int32) & 0x7FFFFFFF).long()
    return (keys << b) | (n - 1 - torch.arange(n)), b


def find_digit(hist, need):
    """The digit whose bucket holds the need-th largest entry, counting
    from the top: (digit, entries above it, its bucket's size)."""
    from_top = hist.flip(0).cumsum(0)
    pos = int(torch.nonzero(from_top >= need)[0])
    d = hist.numel() - 1 - pos
    return d, int(from_top[pos] - hist[d]), int(hist[d])


def split_route_emulation(x, k, *, chunk, cap, seed=0):
    """The split route's arithmetic, level by level: histograms per chunk
    of the source summed per row, the digit search, the filter (winners,
    candidates in a buffer of ``cap``, or x read again when the bucket is
    larger), winners in an arbitrary arrival order, then the LSD radix
    sort of the split keys (composite key, then x's sign bit), 8 bits a
    pass, each pass stable, and the values rebuilt from the keys."""
    nb, n = x.shape
    c_all, b = composite_keys(x)
    sign = (x.contiguous().view(torch.int32) < 0).long()
    c_all = (c_all << 1) | sign
    gen = torch.Generator().manual_seed(seed)
    vals, idx, modes = [], [], []
    for row in range(nb):
        cr, wins = c_all[row], []
        src, mode, prefix, need = cr, "x", 0, k
        for shift, width in tkernel.select_digits(n):
            modes.append(mode)
            hi, bins = shift + width, 1 << width
            hist = torch.zeros(bins, dtype=torch.int64)
            for start in range(0, src.numel(), chunk):
                part = src[start:start + chunk]
                part = part[(part >> hi) == prefix]
                hist += torch.bincount((part >> shift) & (bins - 1),
                                       minlength=bins)
            d, above, bucket = find_digit(hist, need)
            left = need - above
            pre = (prefix << width) | d
            inb = src[(src >> hi) == prefix]
            top = inb >> shift
            wins.append(inb[top > pre])
            prefix, need = pre, left
            if left == bucket:                # the whole bucket is wanted
                wins.append(inb[top == pre])
                break
            if bucket <= cap:
                cand = inb[top == pre]
                src = cand[torch.randperm(cand.numel(), generator=gen)]
                mode = "cand"
            else:
                src = cr                      # read x again
        w = torch.cat(wins)
        assert w.numel() == k
        w = w[torch.randperm(k, generator=gen)]   # atomics: any order
        for sh in tkernel.sort_shifts(n):
            digit = ((~w) >> sh) & 255
            w = w[torch.sort(digit, stable=True).indices]
        idx.append(n - 1 - ((w >> 1) & ((1 << b) - 1)))
        bits = ((w >> (b + 1)) & 0x7FFFFFFF) | ((w & 1) << 31)
        vals.append(bits.to(torch.uint32).view(torch.float32))
    return torch.stack(vals), torch.stack(idx).to(torch.int32), modes


def row_route_emulation(x, k):
    """The row route's arithmetic: a radix select over the composite key,
    8 bits a pass from the top, stopping when a digit's whole bucket is
    wanted; every key at or above the threshold survives; a descending
    sort of the survivors."""
    nb, n = x.shape
    c_all, b = composite_keys(x)
    vals, idx = [], []
    for row in range(nb):
        cr, prefix, need, shift = c_all[row], 0, k, 31 + b
        while shift > 0:
            width = min(8, shift)
            shift -= width
            inb = cr[(cr >> (shift + width)) == prefix]
            hist = torch.bincount((inb >> shift) & ((1 << width) - 1),
                                  minlength=256)
            d, above, bucket = find_digit(hist, need)
            prefix, need = (prefix << width) | d, need - above
            if need == bucket:
                break
        surv = cr[cr >= (prefix << shift)]
        assert surv.numel() == k
        surv = torch.sort(surv, descending=True).values
        i = n - 1 - (surv & ((1 << b) - 1))
        idx.append(i)
        vals.append(x[row, i])
    return torch.stack(vals), torch.stack(idx).to(torch.int32)


def signed_zero_rows(seed, nb, block):
    """Rows of +0.0 and -0.0 with a few nonzero entries."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((nb, block)) < 0.5, -0.0, 0.0)
    hot = rng.random((nb, block)) < 0.02
    x[hot] = rng.standard_normal(int(hot.sum()))
    return x.astype(np.float32)


#: (label, x, k, chunk, cap): many chunks a row; ties straddling chunk
#: borders; all-zero rows; +0.0 and -0.0 mixed; k = 1 and k = block; a
#: bucket over the candidate capacity (x read again); candidates refined
#: over the index bits
SPLIT_CASES = [
    ("chunks", lambda: rows(20, 3, 5000), 50, 256, 128),
    ("ties-across-chunks", lambda: rows(21, 3, 4099, ties=True), 41, 100,
     2048),
    ("zero-rows", lambda: rows(22, 4, 3000, zero_rows=2), 30, 512, 64),
    ("signed-zeros", lambda: signed_zero_rows(23, 2, 6000), 300, 1000, 512),
    ("k=1", lambda: rows(24, 2, 7000, ties=True), 1, 333, 64),
    ("k=block", lambda: rows(25, 2, 5000, ties=True), 5000, 700, 5000),
    ("over-capacity", lambda: rows(26, 2, 9000, ties=True), 90, 1024, 16),
    ("all-ties-over-capacity",
     lambda: np.full((2, 4500), -2.5, np.float32), 45, 512, 8),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_topk_routes_emulated_equal_plain_and_ref(case, ref):
    label, make, k, chunk, cap = case
    x = make()
    xt = torch.as_tensor(x)
    want_v, want_i = topk_compress_torch(xt, k)
    got_v, got_i, modes = split_route_emulation(xt, k, chunk=chunk, cap=cap)
    assert_bitwise(got_i, want_i.numpy())
    assert_bitwise(got_v, want_v.numpy())
    if label.endswith("over-capacity"):
        assert modes.count("x") > x.shape[0], modes   # x read again
    row_v, row_i = row_route_emulation(xt, k)
    assert_bitwise(row_i, want_i.numpy())
    assert_bitwise(row_v, want_v.numpy())
    wv, wi = ref.topk_ref(x, k)
    assert_bitwise(got_i, wi)
    assert_bitwise(got_v, wv)


def test_topk_route_arithmetic():
    """The launcher's plan: the select's digits cover the composite key's
    31 + b bits from the top (bits 30..20 of |x| first), the sort's
    passes cover them from the bottom, and the route and capacity follow
    the row's length."""
    for block in (1, 2, 1536, 4096, 4097, 70001, 2359296, 13762560,
                  2 ** 31 - 1):
        b = tkernel.index_bits(block)
        assert 2 ** b >= block > 2 ** (b - 1) if b else block == 1
        digits = tkernel.select_digits(block)
        assert digits[0] == (21 + b, 11)    # bits 30..20 of |x|
        assert sum(w for _, w in digits) == 31 + b
        assert [s for s, _ in digits] == sorted((s for s, _ in digits),
                                                reverse=True)
        assert digits[-1][0] == 1           # just above the sign bit
        assert tkernel.split_key_bits(block) == 32 + b
        assert tkernel.sort_shifts(block)[-1] + 8 >= 32 + b
        assert tkernel.route(block) == ("row" if block <= 4096 else "split")
    assert tkernel.capacity(13762560, 137625) == 137625
    assert tkernel.capacity(2359296, 23592) == 32768
    assert tkernel.capacity(5000, 4000) == 5000
    assert len(tkernel.select_digits(13762560)) == 5
    assert len(tkernel.sort_shifts(13762560)) == 7


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against the plain versions, bitwise
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def card_rows(seed, nb, block, dev, ties=False):
    """Seeded rows made on the card (the long ones would be slow to make
    with numpy), magnitudes spanning 1e-12 to 1e2 by row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mag = 10.0 ** (torch.rand((nb, 1), generator=gen, device=dev) * 14 - 12)
    x = torch.randn((nb, block), generator=gen, device=dev) * mag
    if ties:
        x = torch.round(x / mag * 2) / 2 * mag
        x[:, ::7] = -x[:, ::7]
        x[:, ::5] = 0.0
    return x


def card_bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        bad = int((g != w).sum())
        assert bad == 0, f"{bad} of {g.numel()} differ"


#: (nb, block): the int8 encode's row shapes on the qwen2-1.5b path (cut
#: in rows, not in width), and a ragged one
QUANT_CARD = [(4096, 8960), (4096, 1536), (28, 256), (2, 1024), (7, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QUANT_CARD)
def test_quantize_kernels_equal_plain_on_card(shape, cuda_device):
    x = card_rows(11, *shape, cuda_device, ties=shape[0] == 7)
    kbuild.reset_launches()
    got = quantize_blocks(x, residual=True)
    assert kbuild.LAUNCHES["quantize"] == 1
    card_bitwise(got, quantize_torch(x, residual=True))
    q, scale = got[0], got[1]
    card_bitwise([dequantize_blocks(q, scale)], [dequantize_torch(q, scale)])
    acc = card_rows(12, *shape, cuda_device)
    want = dequantize_torch(q, scale, out=acc.clone())
    card_bitwise([dequantize_blocks(q, scale, out=acc)], [want])
    assert kbuild.LAUNCHES["dequantize"] == 2


#: (nb, block, k, ties): the top-k rows of the qwen2-1.5b path (a stacked
#: MLP row of 13,762,560 with k = 137,625; wq's; embed's rows of 1536; the
#: biases' of 256) and ragged / all-ties rows; then a single long row, a
#: row whose first bucket overflows the candidate capacity (ties at
#: 2,359,296) and k = block on the split route
TOPK_CARD = [(2, 13762560, 137625, False), (3, 2359296, 23592, False),
             (4096, 1536, 15, False), (28, 256, 2, False),
             (5, 1000, 1000, True), (3, 70000, 5000, True),
             (1, 13762560, 137625, False), (2, 2359296, 23592, True),
             (2, 70000, 70000, False)]


def first_bucket(x, k):
    """Per row, the size of the split route's first bucket: the entries
    whose bits 30..20 of |x| equal those of the k-th largest."""
    top = ((x.view(torch.int32) & 0x7FFFFFFF) >> 20).long()
    sizes = []
    for r in top:
        hist = torch.bincount(r, minlength=2048).cpu()
        sizes.append(find_digit(hist, k)[2])
    return sizes


@pytest.mark.cuda
@pytest.mark.parametrize("case", TOPK_CARD)
def test_topk_kernel_equals_plain_on_card(case, cuda_device):
    nb, block, k, ties = case
    x = card_rows(13, nb, block, cuda_device, ties=ties)
    kbuild.reset_launches()
    got = topk_compress_blocks(x, k)
    assert kbuild.LAUNCHES["topk_compress"] == 1
    which = tkernel.route(block)
    assert kbuild.ROUTES == {f"topk_compress/{which}": 1}
    card_bitwise(got, topk_compress_torch(x, k))
    card_bitwise(topk_compress_blocks(x, k), got)     # deterministic
    if ties and block == 2359296:     # x is read again
        assert max(first_bucket(x, k)) > tkernel.capacity(block, k)
