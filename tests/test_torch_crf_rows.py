"""The CRF step's resident_smem route on the CPU: the row table that
stages a command stream's MRAM rows in shared memory, the operand
descriptors that address them and the staged image that carries each
slot's static timing (repro_torch.kernels.crf_step.crf_step.row_table,
segments, writes_top, layout, descriptors, staged_image).  A
bank's shared memory built as the kernel builds it (the GRF, the SRF,
the staged rows, MRAM's last word), read through each operand's
descriptor as the kernel reads it, must give every lane the word the
plain step reads (hbmpim.make_cmd_step: the column clamped to M - 1, a
bank's inactive lanes 0); a destination written through its descriptor
and copied back must leave the MRAM and registers the plain step writes
(the columns past the end dropped); the staged image's open-row timing,
counts and class must be make_cmd_step's walk over the command's bank
accesses from any open row: on every case of kernels/crf_step/cases.py
and on GEMVS's full-width programs (workloads/gemv_stream.py).  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import compile_cache, hbmpim  # noqa: E402
from repro_torch.core.config import DPUConfig  # noqa: E402
from repro_torch.kernels.crf_step import cases  # noqa: E402
from repro_torch.kernels.crf_step import crf_step as k_crf  # noqa: E402
from repro_torch.kernels.crf_step import ops as crf_ops  # noqa: E402
from repro_torch.kernels.step_driver import H100  # noqa: E402
from repro_torch.workloads.linalg import GEMV_C  # noqa: E402


def _image(binary):
    """The (6, P) image the step driver hands the kernel (program bucket)."""
    P = compile_cache.program_bucket(binary.n_instrs, binary.opcode.shape[0])
    return np.stack([np.asarray(a[:P], np.int32) for a in binary.arrays])


def _gemvs_programs(cfg, scale=1.0):
    """GEMVS's all-bank command streams (workloads/gemv_stream.py
    ``_run_allbank``): one program a chunk of 8 columns, MACs of a matrix
    row into each group's accumulator row."""
    from repro_torch.workloads import gemv_stream
    W = cfg.hbm_lanes
    R = gemv_stream.GEMVS().n_elems(scale)
    G = R // W
    acc_base = GEMV_C * G
    gpl = max(1, (cfg.hbm_crf_slots - 1) // 8)
    out = []
    for c in range(GEMV_C // 8):
        for g0 in range(0, G, gpl):
            p = hbmpim.CrfProgram()
            for i in range(8):
                for g in range(g0, min(g0 + gpl, G)):
                    p.mac(hbmpim.bank(acc_base + g),
                          hbmpim.bank((c * 8 + i) * G + g), hbmpim.srf(i))
            p.exit_()
            out.append(p.binary(cfg.hbm_crf_slots))
    return out


def _smem(table, W, M, mram, grf, srf):
    """A bank's resident_smem shared memory as the kernel builds it at a
    launch's start (the image's words left 0): the GRF (16 rows of 32
    lanes), the SRF, the load copies of the staged rows, MRAM's last
    word."""
    P = table.slots.shape[1]
    lay = k_crf.layout(P, len(table.rows), W)
    words = np.zeros(lay["words"], np.int32)
    words[lay["grf"]:lay["grf"] + 16 * 32] = grf.reshape(-1)
    words[lay["srf"]:lay["srf"] + 8] = srf
    for s0, c0, n, _ in k_crf.segments(table.rows, W, M):
        words[lay["rows"] + s0:lay["rows"] + s0 + n] = mram[c0:c0 + n]
    words[lay["top"]] = mram[M - 1]
    return lay, words


def _read(desc, lay, words, W):
    """read_desc in crf_step.cu, for every lane."""
    lane = np.arange(32)
    base, cut = desc & 0xFFFF, ((desc >> k_crf.DESC_CUT) & 63) - 1
    mode = (desc >> k_crf.DESC_MODE) & 3
    at = np.where(mode == k_crf.MODE_BROADCAST, base,
                  np.where(lane < cut, base + lane, lay["top"]))
    v = words[at]
    bank = bool((desc >> k_crf.DESC_BANK) & 1)
    gone = (mode == k_crf.MODE_NONE) | (bank & (lane >= W))
    return np.where(gone, 0, v)


def _write(desc, lay, words, W, res):
    """write_desc in crf_step.cu, for every lane."""
    if not (desc >> k_crf.DESC_WRITE) & 1:
        return
    base, cut = desc & 0xFFFF, ((desc >> k_crf.DESC_CUT) & 63) - 1
    if ((desc >> k_crf.DESC_MODE) & 3) == k_crf.MODE_BROADCAST:
        words[base] = res[0]
        return
    for lane in range(32):
        if (desc >> k_crf.DESC_BANK) & 1 and lane >= W:
            continue
        if lane < cut:
            words[base + lane] = res[lane]
        elif lane == cut:
            words[lay["top"]] = res[lane]


def _plain_read(code, W, M, mram, grf, srf):
    """make_cmd_step's read of operand ``code`` for every lane (a bank's
    inactive lanes 0, as the kernels give them)."""
    kind, idx = code >> 24, code & k_crf.IDX_MASK
    lane = np.arange(32)
    if kind in (k_crf.K_GRF_A, k_crf.K_GRF_B):
        return grf[(kind - 1) * 8 + (idx & 7)]
    if kind == k_crf.K_SRF:
        return np.full(32, srf[idx & 7], np.int32)
    v = mram[np.minimum(idx * W + lane, M - 1) % M]
    return np.where(lane < W, v, 0)


def _plain_write(code, W, M, mram, grf, srf, res):
    kind, idx = code >> 24, code & k_crf.IDX_MASK
    if kind == k_crf.K_BANK:
        for lane in range(W):
            if idx * W + lane < M:
                mram[idx * W + lane] = res[lane]
    elif kind in (k_crf.K_GRF_A, k_crf.K_GRF_B):
        grf[(kind - 1) * 8 + (idx & 7)] = res
    elif kind == k_crf.K_SRF:
        srf[idx & 7] = res[0]


def _hold(img, W, M, seed):
    """Every operand a command uses reads, through its descriptor, the
    plain step's word in every lane; a destination written through its
    descriptor and copied back (the store copies, the top word, the
    registers) leaves the plain step's MRAM, GRF and SRF.  Returns the
    row table and the (slot, operand) pairs held."""
    rng = np.random.default_rng(seed)
    table = k_crf.row_table(img)
    desc = k_crf.descriptors(img, table, W, M)
    mram = rng.integers(-2**31, 2**31, M, dtype=np.int64).astype(np.int32)
    grf = rng.integers(-2**31, 2**31, (16, 32),
                       dtype=np.int64).astype(np.int32)
    srf = rng.integers(-1000, 1000, 8).astype(np.int32)
    lay, words = _smem(table, W, M, mram, grf, srf)
    op, dst, a, b = img[:4]
    held = set()
    for i, code in enumerate((a, b, dst)):
        for p in np.flatnonzero(desc[i] != 0):
            got = _read(int(desc[i, p]), lay, words, W)
            want = _plain_read(int(code[p]), W, M, mram, grf, srf)
            kind = int(code[p]) >> 24
            act = np.arange(32) < (32 if kind in (1, 2) else W)
            assert np.array_equal(got[act], want[act]), (p, i)
            held.add((int(p), i))
    for p in np.flatnonzero((desc[2] >> k_crf.DESC_WRITE) & 1):
        res = rng.integers(-2**31, 2**31, 32, dtype=np.int64).astype(np.int32)
        w = words.copy()
        _write(int(desc[2, p]), lay, w, W, res)
        got_m = mram.copy()
        for s0, c0, n, _ in k_crf.segments(table.rows, W, M, table.written):
            got_m[c0:c0 + n] = w[lay["rows"] + s0:lay["rows"] + s0 + n]
        if k_crf.writes_top(table.written, W, M):
            got_m[M - 1] = w[lay["top"]]
        want_m, want_g, want_s = mram.copy(), grf.copy(), srf.copy()
        _plain_write(int(dst[p]), W, M, want_m, want_g, want_s, res)
        assert np.array_equal(got_m, want_m), p
        assert np.array_equal(
            w[lay["grf"]:lay["grf"] + 512].reshape(16, 32), want_g), p
        assert np.array_equal(w[lay["srf"]:lay["srf"] + 8], want_s), p
    return table, held


def _plain_operands(img):
    """(slot, operand) of every operand the plain step uses: a of a
    computing command (MOV, FILL, ADD, MUL, MAC), b of ADD / MUL / MAC,
    the destination of a MAC (read) and of a computing command of a
    register or BANK kind (written)."""
    op, dst, a, b = img[:4]
    kinds = (k_crf.K_BANK, k_crf.K_GRF_A, k_crf.K_GRF_B, k_crf.K_SRF)
    out = set()
    for p in range(img.shape[1]):
        o = int(op[p])
        compute = o in (k_crf.MOV, k_crf.FILL, k_crf.ADD, k_crf.MUL,
                        k_crf.MAC)
        if compute:
            out.add((p, 0))
        if o in (k_crf.ADD, k_crf.MUL, k_crf.MAC):
            out.add((p, 1))
        if o == k_crf.MAC or (compute and (dst[p] >> 24) in kinds):
            out.add((p, 2))
    return out


def _walk(op, a, b, dst, open_row):
    """make_cmd_step's open-row walk of one command of a running bank:
    (bank accesses, hits, misses, reads, writes, the open row after, the
    class)."""
    o = int(op)
    compute = o in (k_crf.MOV, k_crf.FILL, k_crf.ADD, k_crf.MUL, k_crf.MAC)
    uses_b = o in (k_crf.ADD, k_crf.MUL, k_crf.MAC)
    n = hit = rd = wr = 0
    for s, (code, used) in enumerate(((a, compute), (b, uses_b),
                                      (dst, compute))):
        if used and (int(code) >> 24) == k_crf.K_BANK:
            row = int(code) & k_crf.IDX_MASK
            hit += row == open_row
            open_row = row
            n += 1
            rd, wr = rd + (s < 2), wr + (s == 2)
    cls = k_crf.CLS_DMA if n else k_crf.CLS_ALU if compute else k_crf.CLS_CTRL
    return n, hit, n - hit, rd, wr, open_row, cls


def _staged_walk(word, open_row):
    """step_staged's timing from a staged slot (words 0, 6, 7)."""
    w0, first, last = (int(x) for x in (word[0], word[6], word[7]))
    n = (w0 >> k_crf.W_NBANK) & 3
    hit = ((first == open_row) + ((w0 >> k_crf.W_HITS) & 3)) if n else 0
    return (n, hit, n - hit, (w0 >> k_crf.W_NRD) & 3,
            (w0 >> k_crf.W_NWR) & 1, last if n else open_row,
            (w0 >> k_crf.W_CLS) & 7)


def _hold_timing(img, W, M):
    """Every slot's staged timing is the walk's from every open row that
    matters (each row the slot names, none, one it does not name); words
    1 and 2 are a and the target, 3-5 the descriptors."""
    table = k_crf.row_table(img)
    staged = k_crf.staged_image(img, table, W, M)
    assert np.array_equal(staged[:, 1], img[2])
    assert np.array_equal(staged[:, 2], img[4])
    assert np.array_equal(staged[:, 3:6].T,
                          k_crf.descriptors(img, table, W, M))
    op, dst, a, b = img[:4]
    for p in range(img.shape[1]):
        assert int(staged[p, 0]) & 255 == int(op[p]) & 255
        rows = {int(c) & k_crf.IDX_MASK for c in (a[p], b[p], dst[p])}
        for open_row in rows | {-1, 1 << 25}:
            assert _staged_walk(staged[p], open_row) == _walk(
                op[p], a[p], b[p], dst[p], open_row), (p, open_row)
        compute = (int(staged[p, 0]) >> k_crf.W_COMPUTE) & 1
        assert compute == (int(op[p]) in (k_crf.MOV, k_crf.FILL, k_crf.ADD,
                                          k_crf.MUL, k_crf.MAC))


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_row_table_covers_every_case(name):
    cfg, binary, _, _, _ = cases.launch(name)
    img = _image(binary)
    W, M = cfg.hbm_lanes, cfg.mram_words
    table, held = _hold(img, W, M, 19)
    assert held == _plain_operands(img) and held
    mram_ops = {(int(p), i) for i in range(3)
                for p in np.flatnonzero(table.slots[i] >= 0)}
    assert mram_ops <= held
    _hold_timing(img, W, M)
    assert crf_ops.pick_route(cfg.n_dpus, img.shape[1], len(table.rows),
                              cfg.hbm_lanes, H100) == "resident_smem"


def test_rows_past_the_end_fold_onto_the_last_word():
    """past_end: with 1,000 MRAM words and 16 lanes row 62 holds columns
    992-1007; its columns 999 and past read one staged word, MRAM's last,
    which a write to column 999 changes and the writes past it do not.  A
    row wholly past the end reads that word in every lane and writes
    nothing."""
    cfg, binary, _, _, _ = cases.launch("past_end")
    W, M = cfg.hbm_lanes, cfg.mram_words
    assert (W, M) == (16, 1000)
    table = k_crf.row_table(_image(binary))
    assert list(table.rows) == [61, 62] and list(table.written) == [61, 62]
    assert k_crf.writes_top(table.written, W, M)
    segs = k_crf.segments(table.rows, W, M)
    assert segs[:, 2].sum() == 2 * W - (992 + 16 - 999)   # below M - 1
    assert segs[:, 1].max() + segs[segs[:, 1].argmax(), 2] == M - 1
    far = np.zeros((6, 4), np.int32)
    far[0] = [k_crf.MOV, k_crf.MOV, 0, 0]
    far[1] = hbmpim.grf_a(0)
    far[2] = hbmpim.bank(100)         # columns 1,600-1,615: past the end
    far[1, 1] = hbmpim.bank(100)
    far[2, 1] = hbmpim.grf_a(0)
    table, held = _hold(far, W, M, 3)
    assert list(table.rows) == [100] and held == {(0, 0), (0, 2), (1, 0),
                                                  (1, 2)}
    assert not k_crf.writes_top(table.written, W, M)
    assert len(k_crf.segments(table.rows, W, M)) == 0


def test_gemvs_full_width_programs():
    """GEMVS at full width (64 banks, 2 MiB, 16 lanes, 2,048 CRF slots;
    2,016 rows: 126 output groups): 8 programs of 8 x 126 MACs and an
    EXIT (an image of 1,024 slots, the program bucket), each touching
    1,134 rows (1,008 matrix rows and the 126 accumulators, 72,576 bytes
    a bank) in at most two runs copied in bulk, writing the 126 accumulators;
    image, registers and rows take 107,440 bytes of shared memory, two
    blocks an SM, so the 64 banks take the resident_smem route."""
    cfg = DPUConfig(n_dpus=64, mram_bytes=1 << 21, backend="hbmpim_cmd")
    progs = _gemvs_programs(cfg)
    assert len(progs) == 8
    for c, binary in enumerate(progs):
        assert binary.n_instrs == 8 * 126 + 1
        img = _image(binary)
        assert img.shape[1] == 1024
        table, held = _hold(img, 16, cfg.mram_words, c)
        assert len(held) == 3 * 8 * 126 and len(table.rows) == 9 * 126
        _hold_timing(img, 16, cfg.mram_words)
        assert len(table.rows) * 16 * 4 == 72576
        assert len(table.written) == 126
        segs = k_crf.segments(table.rows, 16, cfg.mram_words)
        # the last chunk's matrix rows end where the accumulators begin
        assert len(segs) == (1 if c == 7 else 2) and segs[:, 3].all()
    assert k_crf.smem_bytes(1024, 1134, 16) == 107440
    assert H100.smem_sm // (107440 + H100.smem_extra) == 2
    assert crf_ops.smem_banks(1024, 1134, 16, H100) == 264
    assert crf_ops.pick_route(64, 1024, 1134, 16, H100) == "resident_smem"


@pytest.mark.parametrize("W,M", [(3, 1000), (16, 1002), (5, 77)])
def test_segments_split_at_alignment(W, M):
    """Rows of odd widths and an MRAM of a length that is no multiple of
    4: every staged word below M - 1 is copied exactly once, the bulk
    copies 16-byte aligned on both sides with a multiple of 4 words."""
    rows = np.asarray([0, 1, 2, 5, 6, 9, M // W - 1, M // W, M // W + 3])
    segs = k_crf.segments(rows, W, M)
    col = (rows[:, None] * W + np.arange(W)).reshape(-1)
    want = {(s, int(c)) for s, c in enumerate(col) if c < M - 1}
    got = set()
    for s0, c0, n, bulk in segs:
        if bulk:
            assert s0 % 4 == c0 % 4 == n % 4 == 0 and M % 4 == 0
        got |= {(s0 + k, c0 + k) for k in range(n)}
    assert got == want and sum(segs[:, 2]) == len(want)
