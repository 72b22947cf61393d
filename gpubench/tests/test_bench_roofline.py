"""The kernels' operations and bytes a launch shape (gpubench/roofline.py)
against the bound column of PERF.md's kernel tables (ms, four digits)."""

import pytest

from gpubench import roofline as rf

L16, L32, L8, L4 = (16,) * 4, (32,) * 4, (8,) * 4, (4,) * 4
BLOCK = (2, 2, 2, 2)
CASES = {
    "K1 16^4 batch 1": (rf.dslash("K1", L16, 1), 0.0150),
    "K1 16^4 batch 28": (rf.dslash("K1", L16, 28), 0.1164),
    "K1 16^4 batch 56": (rf.dslash("K1", L16, 56), 0.2216),
    "K1 16^4 f64": (rf.dslash("K1", L16, 1, "f64"), 0.0300),
    "K1 32^4": (rf.dslash("K1", L32, 1), 0.2404),
    "K1 32^4 f64": (rf.dslash("K1", L32, 1, "f64"), 0.4808),
    "K2 odd sites": (rf.dslash("K2", L16, 1, parity=True), 0.0085),
    "K2 all sites": (rf.dslash("K2", L16, 1), 0.0094),
    "K2 odd sites batch 28": (rf.dslash("K2", L16, 28, parity=True), 0.0845),
    "K2 face links batch 56": (rf.dslash("K2", L16, 56), 0.2160),
    "K2 odd sites 32^4": (rf.dslash("K2", L32, 1, parity=True), 0.1352),
    "K3 clover": (rf.dslash("K3", L16, 1), 0.0094),
    "K3 clover batch 28": (rf.dslash("K3", L16, 28), 0.1108),
    "K3 inverse odd compact": (rf.dslash("K3", L16, 1, parity=True), 0.0056),
    "K3 inverse odd compact batch 28": (rf.dslash("K3", L16, 28, parity=True), 0.0817),
    "K3 clover 32^4": (rf.dslash("K3", L32, 1), 0.1502),
    "K4 8^4 batch 1": (rf.coarse(L8, 56, 1), 0.2772),
    "K4 8^4 batch 28": (rf.coarse(L8, 56, 28), 0.3865),
    "K4 4^4 batch 1": (rf.coarse(L4, 56, 1), 0.0173),
    "K4 4^4 hop": (rf.coarse(L4, 56, 1, terms=(1, 9)), 0.0154),
    "K4 4^4 batch 256": (rf.coarse(L4, 56, 256), 0.2209),
    "K4 4^4 self inverse odd batch 256": (rf.coarse(L4, 56, 256, terms=(0, 1), parity=1), 0.0141),
    "K4 8^4 masked batch 56": (rf.coarse(L8, 56, 56, mask=BLOCK), 0.4294),
    "K4 16^4 d 56": (rf.coarse(L16, 56, 1), 4.4347),
    "K4 16^4 d 56 masked": (rf.coarse(L16, 56, 1, mask=BLOCK), 2.4715),
    "K4 16^4 d 56 masked batch 56": (rf.coarse(L16, 56, 56, mask=BLOCK), 6.8711),
    "K4-bf16 8^4": (rf.coarse(L8, 56, 1, blocks="bf16"), 0.1391),
    "K4-bf16 16^4 d 56": (rf.coarse(L16, 56, 1, blocks="bf16"), 2.2261),
    "K4-bf16 16^4 d 56 masked": (rf.coarse(L16, 56, 1, blocks="bf16", mask=BLOCK), 1.2445),
    "K5 slab (8,4,8,8) z faces": (rf.coarse((8, 4, 8, 8), 56, 1,
                                            face_bytes=2 * 8 * 8 * 8 * 56 * 8), 0.1387),
    "K6 coarsest Schur": (rf.dense(1, 7168, 1, 1), 0.0614),
    "K6 coarsest Schur batch 12": (rf.dense(1, 7168, 1, 12), 0.0618),
    "K6 all blocks": (rf.dense(256, 896, 256, 1), 0.2465),
    "K6 all blocks batch 12": (rf.dense(256, 896, 256, 12), 0.2585),
    "K6 red-black colour": (rf.dense(256, 896, 128, 1), 0.1235),
    "K6 red-black colour batch 12": (rf.dense(256, 896, 128, 12), 0.1326),
    "K6 one of sixteen": (rf.dense(256, 896, 16, 1), 0.0159),
    "K6 one of sixteen batch 12": (rf.dense(256, 896, 16, 12), 0.0223),
    "K7 fine j 1": (rf.gcr_step(16**4 * 12, 1, 1), 0.0188),
    "K7 fine j 10": (rf.gcr_step(16**4 * 12, 10, 1), 0.0526),
    "K7 fine j 49": (rf.gcr_step(16**4 * 12, 49, 1), 0.1991),
    "K7 fine j 49 batch 12": (rf.gcr_step(16**4 * 12, 49, 12), 2.3889),
    "K7 K-cycle j 4": (rf.gcr_step(8**4 * 56, 4, 1), 0.0088),
    "K7 coarsest j 99": (rf.gcr_step(4**4 * 56, 99, 1), 0.0071),
    "K7 fine complex128 j 10": (rf.gcr_step(16**4 * 12, 10, 1, "f64"), 0.1052),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bound_matches_perf_md(case):
    work, ms = CASES[case]
    assert round(1e3 * rf.bound_s(work), 4) == pytest.approx(ms, abs=1e-4)
