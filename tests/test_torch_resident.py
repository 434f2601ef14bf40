"""What the two persistent kernels keep on the chip, planned from the card.

The plans are pure Python (``eigen_value_tpu_torch.device``): the resident
rows and the L2-kept rows of the stripes kernel, the resident tiles, the
work-item split and the L2-kept tiles of the triangle kernel.  They are held
here against values computed by hand for an H100's limits (132 SMs, 232,448
bytes of shared memory a block, 50 MB of L2) and for a smaller card, by
patching ``cuda_limits``; nothing launches.  The kernels themselves are
tested on the card by tests/test_torch_cuda.py.
"""

import pytest

torch = pytest.importorskip("torch")

from eigen_value_tpu_torch import device  # noqa: E402
from eigen_value_tpu_torch.ops.cuda import kernels as tk  # noqa: E402

H100 = device.CudaLimits(sms=132, smem_per_block_optin=232448, l2_bytes=52428800)
# a card with 99 KB of shared memory a block, 46 SMs and 6 MB of L2
SMALL = device.CudaLimits(sms=46, smem_per_block_optin=101376, l2_bytes=6291456)
CARDS = {"h100": H100, "small": SMALL}
STATIC = 1024  # the kernels' static shared memory, rounded up


@pytest.fixture(params=sorted(CARDS))
def card(request, monkeypatch):
    """A CUDA device with a card's limits patched in; nothing may launch."""
    lim = CARDS[request.param]
    monkeypatch.setattr(device, "cuda_limits", lambda dev: lim)
    return torch.device("cuda", 0), lim


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(device, "cuda_limits", lambda dev: H100)
    return torch.device("cuda", 0)


# --- the stripes kernel: resident rows, the grid, the L2 band ----------------


@pytest.mark.parametrize("n, want", [
    # 198656 bytes beside ev hold six 32 KiB rows; 19660800 bytes of L2 over
    # 132 blocks of 32 KiB rows keep four more
    (8192, (132, 6, 4, 0)),
    # 13 of a block's 32 rows; the other 2380 rows (39.0 MB) are under 3/4 of
    # the L2, so 5/8 of it (32768000 bytes) keep 15 more a block
    (4096, (132, 13, 15, 0)),
    (2048, (76, 27, 0, 0)),  # 27 rows fit: 76 blocks hold all 2048
    (1024, (32, 32, 0, 0)),  # a row a warp, every row resident
    (128, (4, 32, 0, 0)),
    (3, (1, 3, 0, 0)),
    (28928, (132, 1, 1, 0)),  # the last n with a row beside ev
    (28932, (132, 0, 1, 0)),
    (57856, (132, 0, 0, 0)),  # ev alone fills the block
    # (an f32 A streams through registers: device.STRIPES_RING[4] == 0)
])
def test_multiround_plan_on_an_h100(h100, n, want):
    assert tuple(device.multiround_plan(n, h100)) == want


def test_multiround_plan_on_a_smaller_card(monkeypatch):
    monkeypatch.setattr(device, "cuda_limits", lambda dev: SMALL)
    dev = torch.device("cuda", 0)
    # 101376 - 1024 - 32768 = 67584 bytes: two rows; 2359296 bytes of L2
    # over 46 blocks of 32 KiB rows keep one more
    assert tuple(device.multiround_plan(8192, dev)) == (46, 2, 1, 0)
    assert tuple(device.multiround_plan(2048, dev)) == (46, 11, 6, 0)
    assert device.multiround_plan(25088, dev).resident == 0
    assert not device.multiround_fits(25092, dev) and device.multiround_fits(25088, dev)


@pytest.mark.parametrize("n", [1, 3, 96, 1000, 1001, 2048, 4096, 5000, 8192, 12288, 16384,
                               28928, 28932, 40000, 57856])
def test_multiround_plan_respects_the_card(card, n):
    dev, lim = card
    if not device.multiround_fits(n, dev):  # ev alone does not fit this card
        assert 4 * n + STATIC > lim.smem_per_block_optin
        return
    plan = device.multiround_plan(n, dev)
    per_block = -(-n // plan.grid)
    assert 1 <= plan.grid <= lim.sms
    assert plan.grid * per_block >= n  # every row has a block
    assert 0 <= plan.resident <= per_block
    assert 0 <= plan.l2_rows <= per_block - plan.resident
    assert device.multiround_smem_bytes(n, plan.resident) + STATIC <= lim.smem_per_block_optin
    # one more row would not fit, unless every row of the block is resident
    if plan.resident < per_block:
        assert device.multiround_smem_bytes(n, plan.resident + 1) + STATIC > (
            lim.smem_per_block_optin)
    rest = (n - min(n, plan.grid * plan.resident)) * 4 * n
    assert plan.l2_rows * plan.grid * 4 * n <= device.l2_resident_bytes(dev, rest)
    assert device.l2_resident_bytes(dev, rest) <= lim.l2_bytes * 5 // 8
    # every warp has a row where there are enough rows
    assert plan.grid * 32 >= min(n, lim.sms * 32)


def test_multiround_smem_bytes_mirrors_the_kernel():
    assert device.multiround_smem_bytes(8192) == 32768
    assert device.multiround_smem_bytes(8192, 6) == 229376
    assert device.multiround_smem_bytes(3, 3) == 48


def test_l2_resident_bytes_follows_what_streams_by(h100):
    # 3/8 of the L2 while more than 3/4 of it streams by, 5/8 from there down
    assert device.l2_resident_bytes(h100, 8192 * 8192 * 4) == 19660800
    assert device.l2_resident_bytes(h100, 39321601) == 19660800
    assert device.l2_resident_bytes(h100, 39321600) == 32768000
    assert device.l2_resident_bytes(h100, 0) == 32768000


# --- the triangle kernel: resident tiles, the split, the L2 tiles ------------


def test_sym_smem_bytes_mirrors_the_kernel():
    # ev and the tiles, nothing else: 4 * 8192 + 3 * 65536 = 229376
    assert device.sym_smem_bytes(8192, 128) == 32768
    assert device.sym_smem_bytes(8192, 128, 3) == 229376
    assert device.sym_smem_bytes(8192, 128, 3) + STATIC <= H100.smem_per_block_optin
    assert device.sym_smem_bytes(8192, 128, 4) + STATIC > H100.smem_per_block_optin


@pytest.mark.parametrize("n, bt, sym, want", [
    # (an f32 A streams through registers: device.SYM_RING[4] == 0)
    (8192, 128, True, 396),  # three tiles a block
    (8192, 128, False, 396),
    (4096, 128, True, 396),  # of 496 off-diagonal tiles
    (2048, 128, True, 120),  # g(g-1)/2: every off-diagonal tile
    (2048, 128, False, 255),  # g^2 - 1: one tile must stream
    (16384, 128, True, 264),  # 165888 bytes beside ev: two tiles
    (32768, 128, True, 132),
    (41472, 128, True, 132),  # 232448 - 1024 - 165888 = 65536: exactly one tile
    (41600, 128, True, 0),  # 65024 bytes beside ev
    (57856, 128, True, 0),
    (8192, 256, True, 0),  # a 256 KiB tile
])
def test_sym_auto_cache_tiles_on_an_h100(h100, n, bt, sym, want):
    assert device.sym_auto_cache_tiles(n, bt, h100, sym=sym) == want


@pytest.mark.parametrize("n", range(128, 57856 + 1, 128 * 19))
@pytest.mark.parametrize("sym", [True, False])
def test_sym_auto_cache_fits_and_is_cacheable(card, n, sym):
    dev, lim = card
    if not device.multiround_sym_fits(n, 128, dev):
        assert device.sym_auto_cache_tiles(n, 128, dev, sym=sym) <= 0
        return
    tiles = device.sym_auto_cache_tiles(n, 128, dev, sym=sym)
    g = n // 128
    assert 0 <= tiles <= (g * (g - 1) // 2 if sym else g * g - 1)
    slots = -(-tiles // lim.sms)
    assert device.multiround_sym_fits(n, 128, dev, slots)
    assert device.sym_smem_bytes(n, 128, slots) + STATIC <= lim.smem_per_block_optin
    streamed, cached = tk._tile_split(n, 128, tiles, sym)
    assert len(cached) == tiles and len(streamed) + tiles == (g * (g + 1) // 2 if sym else g * g)


def test_sym_auto_cache_is_zero_off_the_card(h100):
    assert device.sym_auto_cache_tiles(8192, 128, torch.device("cpu")) == 0


@pytest.mark.parametrize("n, sym, want", [
    # 12 tiles a block on 132 SMs: 1584
    (2048, True, 4), (4096, True, 4), (6144, True, 4),  # 136, 528, 1176 tiles
    (8192, True, 1),  # 2080
    (4096, False, 4),  # 1024
    (6144, False, 1), (8192, False, 1),  # 2304, 4096
])
def test_sym_split_on_an_h100(h100, n, sym, want):
    assert device.sym_split(n, 128, h100, sym=sym) == want


def test_sym_split_follows_the_tile_edge_and_the_card(monkeypatch):
    monkeypatch.setattr(device, "cuda_limits", lambda dev: SMALL)
    dev = torch.device("cuda", 0)
    assert device.sym_split(2048, 256, dev) == 8  # 36 tiles of 256 rows: 8 groups
    assert device.sym_split(4096, 128, dev) == 4  # 528 < 12 * 46
    assert device.sym_split(8192, 128, dev) == 1


def test_sym_l2_tiles(h100):
    assert device.sym_l2_tiles(128, h100, 1684) == 300  # 19660800 / 65536
    assert device.sym_l2_tiles(128, h100, 601) == 300  # 39.4 MB stream by
    assert device.sym_l2_tiles(128, h100, 600) == 500  # 32768000 / 65536
    assert device.sym_l2_tiles(128, h100, 528) == 500  # 4096², nothing resident
    assert device.sym_l2_tiles(128, h100, 132) == 132  # never more than stream
    assert device.sym_l2_tiles(128, h100, 0) == 0
    assert device.sym_l2_tiles(256, h100, 1000) == 75


def test_the_resident_and_l2_sets_leave_the_rest_to_stream(h100):
    """The bytes a round of each kernel must fetch from device memory at
    8192² on an H100, from the plans."""
    n, bt = 8192, 128
    plan = device.multiround_plan(n, h100)
    streamed_rows = n - plan.grid * plan.resident
    assert streamed_rows == 7400  # 792 rows, 9.7% of A, stay in shared memory
    assert streamed_rows - plan.grid * plan.l2_rows == 6872
    cache = device.sym_auto_cache_tiles(n, bt, h100)
    streamed, cached = tk.sym_cache_split(n, bt, cache)
    assert (len(streamed), len(cached)) == (1684, 396)
    assert len(streamed) - device.sym_l2_tiles(bt, h100, len(streamed)) == 1384


# --- the bulk-copy rings: what they cost in shared memory --------------------


def test_the_ring_bytes_mirror_the_kernels():
    # stripes: 32 warps x (512 elements + an 8-byte mbarrier) a stage
    assert device.stripes_ring_bytes(2, 2) == 2 * 32 * (1024 + 8) == 66048
    assert device.stripes_ring_bytes(1, 4) == 32 * (2048 + 8)
    assert device.multiround_smem_bytes(8192, 8, 2, 2) == 32768 + 8 * 16384 + 66048
    # triangle: 16 warps x (8 rows x 128 columns + an 8-byte mbarrier) a
    # stage, and 128 bytes to align the stages for the tensor copies
    assert device.sym_ring_bytes(1, 2) == 128 + 16 * (2048 + 8) == 33024
    assert device.sym_ring_bytes(2, 4) == 128 + 2 * 16 * (4096 + 8)
    assert device.sym_smem_bytes(8192, 128, 5, 2, 1) == 32768 + 5 * 32768 + 33024
    assert device.stripes_ring_bytes(0, 2) == device.sym_ring_bytes(0, 2) == 0


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_the_plans_fit_the_card_with_their_rings(card, n, itemsize):
    """ev, the resident rows or tiles, the ring's stages and the static
    shared memory fit one block, for both kernels, on both cards; the
    stripes kernel has a ring only where rows stream, of the depth its
    table gives; the triangle's auto cache leaves the ring its room."""
    dev, lim = card
    plan = device.multiround_plan(n, dev, itemsize)
    assert plan.ring in (0, device.STRIPES_RING[itemsize])
    assert device.multiround_smem_bytes(n, plan.resident, itemsize, plan.ring) + STATIC <= (
        lim.smem_per_block_optin)
    if plan.ring:  # rows stream from device memory
        assert plan.grid * (plan.resident + plan.l2_rows) < n
    else:  # every row on the chip, or the table's depth is 0, or it does not fit
        assert (plan.grid * (plan.resident + plan.l2_rows) >= n
                or device.stripes_ring(n, dev, itemsize) == 0)
    ring = device.sym_ring(n, 128, dev, itemsize)
    assert ring in (0, device.SYM_RING[itemsize])
    for sym in (True, False):
        tiles = device.sym_auto_cache_tiles(n, 128, dev, sym=sym, itemsize=itemsize)
        slots = -(-tiles // lim.sms)
        assert device.sym_smem_bytes(n, 128, slots, itemsize, ring) + STATIC <= (
            lim.smem_per_block_optin)
        assert device.multiround_sym_fits(n, 128, dev, slots, itemsize, ring)


def _row_dot_order(n4):
    """Per lane, (chunk, accumulator) in the order csrc/rowdot.cuh row_dot
    adds them for a 2-byte row of n4 chunks: eight a trip, then four, then
    at most three."""
    order = {lane: [] for lane in range(32)}
    for lane in range(32):
        k = lane
        while k + 224 < n4:
            order[lane] += [(k + 32 * u, u % 4) for u in range(8)]
            k += 256
        while k + 96 < n4:
            order[lane] += [(k + 32 * u, u) for u in range(4)]
            k += 128
        order[lane] += [(k + 32 * u, u) for u in range(3) if k + 32 * u < n4]
    return order


def _seg_dot_order(n4, seg=128):
    """The same for a row read a ring stage at a time (seg_dot)."""
    order = {lane: [] for lane in range(32)}
    for base in range(0, n4, seg):
        cnt = min(seg, n4 - base)
        for lane in range(32):
            order[lane] += [(base + lane + 32 * u, u) for u in range(4) if lane + 32 * u < cnt]
    return order


@pytest.mark.parametrize("n4", [1, 31, 32, 97, 128, 200, 255, 256, 257, 500, 512, 1024, 2047,
                                2048, 14464])
def test_a_row_read_by_stages_adds_its_chunks_as_row_dot_does(n4):
    """Every accumulator of every lane gets the same chunks in the same
    order, whether the row comes whole (row_dot) or in 128-chunk ring stages
    (seg_dot): the f32 sums, and so the bits, are the same."""
    a, b = _row_dot_order(n4), _seg_dot_order(n4)
    for lane in range(32):
        for acc in range(4):
            assert [c for c, u in a[lane] if u == acc] == [c for c, u in b[lane] if u == acc]
    assert sorted(c for lane in range(32) for c, _ in b[lane]) == list(range(n4))


# --- reading the kernels' phase stamps (kernel_phases.py) --------------------


def test_phase_split_reads_the_stamps():
    """Two blocks, three full rounds of the stripes kernel's four stamps:
    the split is the mean over blocks and over rounds 1.., in microseconds,
    and ``stream_slowest`` spans the first start and the last end."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "kernel_phases.py"
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)

    grid = 2
    t = torch.zeros(kp.STAMP_ROUNDS, kp.STAMP_PHASES, grid, dtype=torch.int64)
    for r in range(3):
        for b in range(grid):
            start = 1_000_000 + 100_000 * r + 1_000 * b  # block 1 starts 1 us late
            t[r, :4, b] = torch.tensor([start, start + 4_000, start + 84_000, start + 90_000])
    got = kp.split(t.reshape(-1), grid, ("prologue", "stream", "barrier"))
    assert got["rounds_read"] == 2  # round 0 is left out, round 3 was never stamped
    assert got["prologue"] == pytest.approx(4.0) and got["stream"] == pytest.approx(80.0)
    assert got["barrier"] == pytest.approx(6.0) and got["round"] == pytest.approx(90.0)
    assert got["stream_slowest"] == pytest.approx(81.0)
    assert kp.split(torch.zeros_like(t).reshape(-1), grid, ("prologue", "stream", "barrier")) == {}


def test_phase_split_names_the_slowest_blocks():
    """Each block's own stream phase, a mean over rounds 1..: the least and
    the most of them, and the blocks ordered slowest first."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "kernel_phases.py"
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)

    grid, stream_us = 3, (70, 90, 80)
    t = torch.zeros(kp.STAMP_ROUNDS, kp.STAMP_PHASES, grid, dtype=torch.int64)
    for r in range(3):
        for b in range(grid):
            start = 1_000_000 + 200_000 * r
            end = start + 4_000 + 1_000 * stream_us[b] + 10 * r  # rounds 1, 2 add 10 and 20 ns
            t[r, :4, b] = torch.tensor([start, start + 4_000, end, start + 100_000])
    got = kp.split(t.reshape(-1), grid, ("prologue", "stream", "barrier"))
    assert got["stream_block_range"] == pytest.approx([70.015, 90.015])
    assert got["slowest_blocks"] == [1, 2, 0]


def test_ptxas_report_names_every_persistent_instance():
    """kernel_phases.py reads the compiler's resource report: each
    persistent-kernel instance with its element type, formulation, fill,
    registers and spills; other kernels are skipped."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "kernel_phases.py"
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)

    head = "ptxas info    : "
    report = "\n".join([
        head + "Compiling entry function '_ZN12_GLOBAL__N_113matvec_kernelIfEEvPKT_' for 'sm_90a'",
        head + "Used 40 registers, used 0 barriers",
        head + "Compiling entry function '_ZN12_GLOBAL__N_121multiround_sym_kernelIfLb0ELb1ELb0E"
               "Lb1EEEvPKT_PK4int2' for 'sm_90a'",
        head + "Function properties for _ZN12_GLOBAL__N_121multiround_sym_kernelIfLb0ELb1ELb0ELb1E",
        "    84 bytes stack frame, 84 bytes spill stores, 228 bytes spill loads",
        head + "Used 128 registers, used 1 barriers, 84 bytes cumulative stack size",
        head + "Compiling entry function '_ZN12_GLOBAL__N_117multiround_kernelI13__nv_bfloat16Lb1E"
               "Lb0EEEvPKT_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        head + "Used 64 registers, used 1 barriers",
        head + "Compiling entry function '_ZN12_GLOBAL__N_121multiround_sym_kernelI6__halfLb0ELb0E"
               "Lb1ELb0EEEvPKT_' for 'sm_90a'",
        head + "Used 128 registers, used 1 barriers",
    ])
    got = kp.ptxas_instances(report)
    assert got == [
        {"kernel": "multiround_sym_kernel", "elem": "f32", "instance": "dot +pipelined",
         "registers": 128, "spill_stores": 84, "spill_loads": 228},
        {"kernel": "multiround_kernel", "elem": "bf16", "instance": "vpu, ring",
         "registers": 64, "spill_stores": 0, "spill_loads": 0},
        {"kernel": "multiround_sym_kernel", "elem": "f16", "instance": "mixed",
         "registers": 128, "spill_stores": 0, "spill_loads": 0},
    ]


def test_phase_tool_matrices():
    """kernel_phases.py --matrix: the Hilbert matrix, or the Hilbert matrix
    times 1 + 0.25 U(0, 1) from a fixed seed (not symmetric), the same on
    every call."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "kernel_phases.py"
    spec = importlib.util.spec_from_file_location("kernel_phases", path)
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)

    from eigen_value_tpu_torch import fixtures

    cpu = torch.device("cpu")
    H = fixtures.hilbert_matrix(64)
    assert torch.equal(kp.matrix(64, "hilbert", cpu), H)
    S = kp.matrix(64, "scaled", cpu)
    assert torch.equal(S, kp.matrix(64, "scaled", cpu))
    ratio = S / H
    assert float(ratio.min()) >= 1.0 and float(ratio.max()) <= 1.25
    assert not torch.equal(S, S.T)
