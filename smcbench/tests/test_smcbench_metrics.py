"""The metric arithmetic: the rate over the window, the trace's busy time
and gaps, and each reader's byte counts."""

import time

import pytest
import torch

from smcbench_helpers import find

from smcbench.lib import harness, spec
from smcbench.lib.device import PEAKS
from smcbench.lib.trace import Spans, parse_chrome_trace

BW = PEAKS["hbm_bytes_per_s"]
F32 = PEAKS["f32_flops_per_s"]


class SleepRun:
    """A stand-in for the program: each step sleeps; every tenth step
    sleeps long."""

    def __init__(self, fk, N, seed, params, device):
        self.t = 0
        self.rs_flag = True
        self.ms = params["step_ms"]

    def step(self):
        slow = self.ms * (10 if self.t % 10 == 9 else 1)
        time.sleep(slow / 1000.0)
        self.t += 1

    def read(self):
        return [0.0, 0.0]

    def finish(self):
        return torch.zeros(self.t), torch.zeros(())


def _setup(name, params):
    cell = find(name)
    mix = dict(cell.traffic["params"], **params)
    return cell.driver.setup(harness.Setup(
        cell=cell, params=mix, inputs=cell.model.make_inputs(
            cell.config, mix, 1), seed=1, device=torch.device("cpu"),
        spans=Spans(torch, False), engine=SleepRun))


def test_rate_is_the_work_over_the_window():
    state = _setup("lingauss.boot.n26", {"T": 25, "step_ms": 2.0,
                                         "N": 1000, "warm_steps": 1})
    rec = state_window("lingauss.boot.n26", state, 0.6)
    steps = rec.attempted
    # every step and every run's start are in the window
    assert rec.e2e["particle_steps_per_s"] == pytest.approx(
        steps * 1000 / rec.info["window_s"])
    assert rec.info["runs"] >= 2 and rec.info["window_s"] >= 0.6


def state_window(name, state, seconds):
    return find(name).driver.window(state, seconds, None)


def _event(name, ts, dur, cat="kernel", corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _trace():
    ev = [
        _event("smcbench.window", 0, 1000, "user_annotation"),
        _event("smcbench.step", 0, 400, "user_annotation"),
        _event("smcbench.loglik", 10, 50, "user_annotation"),
        _event("smcbench.step", 500, 400, "user_annotation"),
        _event("cudaLaunchKernel", 20, 5, "cuda_runtime", corr=1),
        _event("cudaLaunchKernel", 100, 5, "cuda_runtime", corr=2),
        _event("cudaLaunchKernel", 510, 5, "cuda_runtime", corr=3),
        _event("void (anonymous namespace)::k_fixed_point<(anonymous "
               "namespace)::ZOut>(float const*)", 100, 100, corr=1),
        _event("void (anonymous namespace)::k_merge_serve(int const*)",
               150, 150, corr=2),
        _event("Memcpy DtoD", 600, 100, "gpu_memcpy", corr=3),
        _event("aten::mul", 450, 40, "cpu_op"),
        _event("outside_window_kernel", 2000, 10),
    ]
    return parse_chrome_trace(ev)


def test_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    # [100, 300) and [600, 700): 300 us busy
    assert tr.busy_s == pytest.approx(300e-6)
    assert tr.device_s_under("loglik") == pytest.approx(100e-6)
    assert len(tr.kernels()) == 2
    br = tr.breakdown()
    assert br["device_ops"][0] == ["k_merge_serve", pytest.approx(150e-6)]
    gaps = dict(br["idle_gaps"])
    assert gaps["outside > aten::mul"] == pytest.approx(300e-6)
    assert gaps["step > python"] == pytest.approx(300e-6)
    assert gaps["loglik > python"] == pytest.approx(100e-6)


def _ctx(work):
    return harness.ReadContext(trace=_trace(), work=work, peaks=PEAKS)


def _reader(name):
    return spec.load_module(spec.BENCH_DIR / "metrics" / f"{name}.py",
                            "m_" + name.replace(".", "_"))


def test_roofline_byte_counts():
    N = 1 << 24
    work = {"kind": "filter", "N": N, "steps": 2, "rs_steps": 2}
    z = _reader("rs_z_roofline").read(_ctx(work))
    assert z == pytest.approx(100 * 2 * 8 * N / BW / 100e-6)
    serve = _reader("rs_serve_roofline").read(_ctx(work))
    assert serve == pytest.approx(100 * 2 * 12 * N / BW / 150e-6)
    M, P, d = 1 << 20, 10, 61
    work = {"kind": "sampler", "M": M, "P": P, "N0": M * P, "d": d,
            "n": 208, "steps": 2, "rs_steps": 2}
    assert _reader("rs_z_roofline").read(_ctx(work)) == pytest.approx(
        100 * 2 * 8 * M * P / BW / 100e-6)
    assert _reader("rs_serve_roofline").read(_ctx(work)) == pytest.approx(
        100 * 2 * (4 * M * P + 2 * M * (4 * d + 12)) / BW / 150e-6)


def test_step_mfu_and_counts():
    N = 1 << 24
    work = {"kind": "filter", "N": N, "steps": 4, "rs_steps": 4}
    ctx = _ctx(work)
    assert _reader("step_mfu").read(ctx) == pytest.approx(
        100 * (16 * N / BW) / (1e-3 / 4))
    assert _reader("kernels_per_step").read(ctx) == pytest.approx(0.5)
    assert _reader("device_idle_share").read(ctx) == pytest.approx(70.0)
    assert _reader("loglik_device_share").read(ctx) == pytest.approx(
        100 * 100 / 300)
    M, P, d, n = 1 << 20, 10, 61, 208
    work = {"kind": "sampler", "M": M, "P": P, "N0": M * P, "d": d, "n": n,
            "steps": 1, "rs_steps": 1}
    bound = max(2 * M * P * (4 * d + 12) / BW, 2 * (P - 1) * M * d * n / F32)
    assert _reader("step_mfu").read(_ctx(work)) == pytest.approx(
        100 * bound / 1e-3)
    assert _reader("step_mfu").read(_ctx({"kind": "other", "steps": 1})) \
        is None
