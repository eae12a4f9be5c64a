"""chip_smoke.py and bench.py: refusal off the GPU, and the smoke phases'
own functions at MICRO on the CPU."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke as cs
from oece_tpu.fhe import boot, devkeygen
from oece_tpu.fhe.params import MICRO, MICRO_A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.phase_device()
    assert "no GPU" in str(e.value)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_refuses_cpu_and_prints_no_result(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "{" not in r.stdout, r.stdout


def test_lowering_summary_counts():
    hlo = (
        '%a = s32[8,8]{1,0} custom-call(%x, %y), custom_call_target="__cublas$gemm"\n'
        "%b = s32[8,8]{1,0} dot(s8[8,8]{1,0} %x, s8[8,8]{1,0} %y)\n"
        "%c = s8[4]{0} gather(s8[8]{0} %x, s32[4,1]{1,0} %i)\n"
        '%d = s32[8,8]{1,0} fusion(%x), kind=kCustom, backend_config='
        '{"fusion_backend_config":{"kind":"__triton_gemm"}}\n'
    )
    s = cs.lowering_summary(hlo)
    assert s == {"custom_calls": {"__cublas$gemm": 1},
                 "custom_fusions": {"__triton_gemm": 1},
                 "dots": {"s32<-s8": 1}, "gathers": 1}


@pytest.mark.parametrize("params", [MICRO, MICRO_A], ids=lambda p: p.name)
def test_exact_phase_checks_at_micro(params):
    cs.check_rot_step(params)
    cs.check_bootstrap_batch(params, B=6)


def test_rot_step_check_detects_a_wrong_step(monkeypatch):
    """The exactness check fails when the device step is wrong."""
    real = boot.ginx_step
    monkeypatch.setattr(
        boot, "ginx_step", lambda acc, *a, **k: real(acc, *a, **k) ^ 1
    )
    with pytest.raises(AssertionError):
        cs.check_rot_step(MICRO)


def test_compile_and_chained_batches_at_micro():
    sk, _z, dkeys = devkeygen.device_keygen(MICRO, seed=0)
    compiled, dt = cs.compile_gate_batch(dkeys, 12)
    assert dt >= 0
    secs, n_ok = cs.run_chained(compiled, dkeys, sk, 12, 3)
    assert secs > 0 and n_ok == 36


def test_run_circuit_at_micro():
    from oece_tpu.harness import testlib

    adder = os.path.join(REPO, "examples", "old_bristol_ckts", "arith",
                         "adder_32bit.txt")
    res = cs.run_circuit("cpu", "adder", adder, testlib.test_adder,
                         set_name="MICRO")
    assert res["encrypted"] == "4/4" and res["repairs"] == {}
    assert json.dumps(res)


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    """On a GPU: the exactness phase at STD128_OPT widths."""
    cs.phase_exact()


def test_four_cards_phase_at_micro(eight_devices):
    """The --four-cards phase on 4 of the virtual CPU devices at MICRO:
    sharded batch bit-identical to one device, adder over the dp=4 mesh."""
    adder = os.path.join(REPO, "examples", "old_bristol_ckts", "arith",
                         "adder_32bit.txt")
    from oece_tpu.harness import testlib

    cs.phase_four_cards("cpu", set_name="MICRO", B=16, circuit=adder,
                        test_fn=testlib.test_adder)
