"""``repro_torch.launch.kernel_timing``: the SASS hot-loop count behind the
issue floors, and the timed ``run_experiment`` configurations, on the CPU.

The SASS is written in ``cuobjdump -sass``'s layout: a ``Function :``
line per kernel, then one instruction a line, ``/*address*/``, an
optional predicate, the mnemonic, its operands, ``;`` and the encoding.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.launch import kernel_timing as kt
from repro_torch.launch import kernel_variants as kv

SASS = """
Fatbin elf code:
================
arch = sm_90a

\tcode for sm_90a
\t\tFunction : _Z3twoPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   FMUL R2, R3, R4 ;                      /* 0x0000000403027220 */
        /*0020*/              @!P0 BRA 0x40 ;                             /* 0x0000000000048947 */
        /*0030*/                   FMUL R5, R5, R6 ;                      /* 0x0000000605057220 */
        /*0040*/                   FADD R7, R7, R8 ;                      /* 0x0000000807077221 */
        /*0050*/                   FMUL R7, R7, R8 ;                      /* 0x0000000807077220 */
        /*0060*/               @P1 BRA 0x10 ;                             /* 0xfffffffc00a81947 */
        /*0070*/                   FMUL R1, R1, R1 ;                      /* 0x0000000101017220 */
        /*0080*/                   FADD R1, R1, R1 ;                      /* 0x0000000101017221 */
        /*0090*/               @P2 BRA 0x70 ;                             /* 0xfffffffc00f42947 */
        /*00a0*/                   EXIT ;                                 /* 0x000000000000794d */
        /*00b0*/                   BRA 0xb0;                              /* 0xfffffffc00fc7947 */
\t\t..........

\t\tFunction : _Z6nestedPf
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   FADD R1, R1, R1 ;                      /* 0x0000000101017221 */
        /*0010*/                   FADD R2, R2, R2 ;                      /* 0x0000000202027221 */
        /*0020*/                   FADD R3, R3, R3 ;                      /* 0x0000000303037221 */
        /*0030*/         @!UP0 BRA.U 0x10 ;                               /* 0xfffffffc00f48947 */
        /*0040*/                   FADD R4, R4, R4 ;                      /* 0x0000000404047221 */
        /*0050*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00e80947 */
        /*0060*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_sass_functions_parses_each_kernel():
    funcs = kt.sass_functions(SASS)
    assert list(funcs) == ["_Z3twoPf", "_Z6nestedPf"]
    assert [a for a, _, _ in funcs["_Z3twoPf"]] == list(range(0, 0xc0, 0x10))
    assert funcs["_Z3twoPf"][2][1:] == ("BRA", " 0x40 ")


def test_loop_issues_takes_the_loop_with_the_most_ops_without_guarded_code():
    funcs = kt.sass_functions(SASS)
    # Loop 0x10-0x60: 6 instructions, 0x30 guarded by the branch at 0x20;
    # 2 FMUL and 1 FADD left.  Loop 0x70-0x90: 3 instructions, 1 FMUL and
    # 1 FADD (of equals, the shortest).  The self-branch at 0xb0 holds no
    # FMUL.
    assert kt.loop_issues(funcs["_Z3twoPf"], "FMUL") == (5, 2)
    assert kt.loop_issues(funcs["_Z3twoPf"], "FADD") == (3, 1)


def test_loop_issues_leaves_nested_loops_out_of_the_outer_count():
    funcs = kt.sass_functions(SASS)
    # 0x10-0x30 lies inside 0x00-0x50: the outer loop keeps 0x00, 0x40 and
    # 0x50 (2 FADD in 3), the inner one 2 FADD in 3.
    assert kt.loop_issues(funcs["_Z6nestedPf"], "FADD") == (3, 2)
    with pytest.raises(ValueError):
        kt.loop_issues(funcs["_Z6nestedPf"], "FMUL")


def test_find_function_wants_exactly_one_match():
    funcs = kt.sass_functions(SASS)
    assert kt.find_function(funcs, "two") == "_Z3twoPf"
    with pytest.raises(ValueError):
        kt.find_function(funcs, "_Z")
    with pytest.raises(ValueError):
        kt.find_function(funcs, "three")


@pytest.mark.parametrize("name", list(kt.RUNS))
def test_experiment_config_builds_each_timed_run(name):
    arch, config, algo, evals, norm, params, backend = kt.RUNS[name]
    cfg = kt.experiment_config(api, name)
    assert (cfg.arch, cfg.config, cfg.algorithms, cfg.budget.evals,
            cfg.norm_samples) == (arch, config, (algo,), evals, norm)
    p = cfg.params[algo]
    assert {k: getattr(p, k) for k in params} == params
    assert cfg.backend == (backend or api.ExperimentConfig(
        arch=arch, config=config).backend)
    assert api.ExperimentConfig.from_dict(cfg.to_dict()) == cfg


def test_kernel_timing_loads_by_path_without_the_package():
    """kernel_compare.py loads the module by path under another name, to
    time checkouts that lack it; it must not need the rest of the
    package."""
    path = Path(kt.__file__)
    src = path.read_text()
    assert "repro_torch" not in "".join(
        ln for ln in src.splitlines() if ln.startswith(("import", "from")))
    spec = importlib.util.spec_from_file_location("_kt_copy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.RUNS == kt.RUNS


SCAN_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_121selective_scan_kernelI13__nv_bfloat16fEEvPKT_
        /*0000*/                   LDS R1, [R2] ;                         /* 0x0000000002017984 */
        /*0010*/                   FMUL R3, R1, R4 ;                      /* 0x0000000401037220 */
        /*0020*/                   MUFU.EX2 R3, R3 ;                      /* 0x0000000300037308 */
        /*0030*/                   FFMA R5, R3, R5, R6 ;                  /* 0x0000000503057223 */
        /*0040*/                   MUFU.EX2 R7, R7 ;                      /* 0x0000000700077308 */
        /*0050*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00e80947 */
        /*0060*/                   EXIT ;                                 /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_117rglru_scan_kernelI13__nv_bfloat16EEvPKT_
        /*0000*/                   LDS R1, [R2] ;                         /* 0x0000000002017984 */
        /*0010*/                   LDS R3, [R4] ;                         /* 0x0000000004037984 */
        /*0020*/                   FFMA R5, R1, R5, R3 ;                  /* 0x0000000301057223 */
        /*0030*/                   STS [R4], R5 ;                         /* 0x0000000504007388 */
        /*0040*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00e80947 */
        /*0050*/                   LDS R6, [R2] ;                         /* 0x0000000002067984 */
        /*0060*/                   FFMA R7, R6, R6, -1 ;                  /* 0x0000000606077223 */
        /*0070*/                   MUFU.RSQ R8, R7 ;                      /* 0x0000000700087308 */
        /*0080*/                   FFMA R9, R8, R7, R6 ;                  /* 0x0000000708097223 */
        /*0090*/                   FFMA R9, R9, R7, R6 ;                  /* 0x0000000709097223 */
        /*00a0*/                   STS [R2], R9 ;                         /* 0x0000000902007388 */
        /*00b0*/               @P1 BRA 0x50 ;                             /* 0xfffffffc00e81947 */
        /*00c0*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_loop_issues_passes_over_loops_with_the_ops_left_out():
    funcs = kt.sass_functions(SCAN_SASS)
    rg = funcs["_ZN12_GLOBAL__N_117rglru_scan_kernelI13__nv_bfloat16EEvPKT_"]
    # The producer loop (0x50-0xb0) holds more FFMA than the walker's
    # (0x00-0x40); without MUFU only the walker's is left.
    assert kt.loop_issues(rg, "FFMA") == (7, 3)
    assert kt.loop_issues(rg, "FFMA", without=("MUFU",)) == (5, 1)
    assert kt.loop_issues(rg, "MUFU") == (7, 1)
    with pytest.raises(ValueError):
        kt.loop_issues(rg, "FFMA", without=("MUFU", "STS"))


def test_scan_issues_reads_each_scan_loop_of_the_serve_instances():
    funcs = kt.sass_functions(SCAN_SASS)
    assert kt.scan_issues(funcs) == {"selective_scan": (6, 2),
                                     "rglru_scan walker": (5, 1),
                                     "rglru_scan producers": (7, 1)}


def test_scan_floors_ms_from_the_issue_counts(monkeypatch):
    """The selective scan: 16 (step, state) lanes a (step, channel) at the
    card's issue rate; RG-LRU's producers a lane a (step, channel), its
    walker S steps at one instruction a clock."""
    monkeypatch.setattr(kt, "issue_rate", lambda dev: 1e12)
    monkeypatch.setattr(kt, "max_sm_clock_hz", lambda: 2e9)
    issues = {"selective_scan": (600, 64), "rglru_scan walker": (68, 16),
              "rglru_scan producers": (136, 8)}
    got = kt.scan_floors_ms(issues, 1, 2048, 8192, "selective_scan", None)
    assert got == {"selective_scan": pytest.approx(
        1e3 * 2048 * 8192 * 16 * 600 / 64 / 1e12)}
    got = kt.scan_floors_ms(issues, 2, 512, 4096, "rglru_scan", None)
    assert got == {"producers": pytest.approx(1e3 * 2 * 512 * 4096 * 17
                                              / 1e12),
                   "walker": pytest.approx(1e3 * 512 * 68 / 16 / 2e9)}


SSCAN_BWD_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_116sscan_bwd_kernelI13__nv_bfloat16fEEvPKT_
        /*0000*/                   LDS R1, [R2] ;                         /* 0x0000000002017984 */
        /*0010*/               @P1 BRA 0x30 ;                             /* 0x0000000000041947 */
        /*0020*/                   SYNCS.ARRIVE R3, [R4] ;                /* 0x0000000304007308 */
        /*0030*/                   MUFU.EX2 R3, R3 ;                      /* 0x0000000300037308 */
        /*0040*/                   FFMA R5, R3, R5, R6 ;                  /* 0x0000000503057223 */
        /*0050*/                   MUFU.EX2 R7, R7 ;                      /* 0x0000000700077308 */
        /*0060*/                   SHFL.BFLY R8, R7, 0x10, 0x1f ;         /* 0x0000000807087f89 */
        /*0070*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00e80947 */
        /*0080*/                   EXIT ;                                 /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_116sscan_bwd_kernelIffEEvPKT_
        /*0000*/                   MUFU.EX2 R3, R3 ;                      /* 0x0000000300037308 */
        /*0010*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00e80947 */
        /*0020*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_sscan_bwd_issues_and_floor_from_its_loop_over_chunks(monkeypatch):
    """The selective-scan backward's training instance (x bfloat16, dt
    float32): its loop over chunks without the guarded staging issue; the
    floor B * S * Di * 16 lanes at that count over SSCAN_BWD_TRIP each."""
    funcs = kt.sass_functions(SSCAN_BWD_SASS)
    assert kt.sscan_bwd_issues(funcs) == (7, 2)
    monkeypatch.setattr(kt, "issue_rate", lambda dev: 1e12)
    assert kt.sscan_bwd_floor_ms(2400, 2, 4096, 8192, None) == (
        pytest.approx(1e3 * 2 * 4096 * 8192 * 16 * 2400 / 64 / 1e12))


@pytest.mark.parametrize("set_name", sorted(kv.SETS))
def test_kernel_variants_apply_to_the_sources(set_name):
    """Every variant's constants and replaced lines occur once in the
    kernel sources as built, so a variant times what its name says."""
    for name, (src, consts, replace) in kv.SETS[set_name].items():
        s = kv.variant_source(src, consts, replace)
        for k, v in consts.items():
            assert f" {k} = {v};" in s, name
        for old, new in replace:
            assert new in s, name
    with pytest.raises(ValueError):
        kv.variant_source(kv.SS, {"kNoSuchConstant": 1}, [])
    with pytest.raises(ValueError):
        kv.variant_source(kv.RG, {}, [("no such line", "")])


@pytest.mark.parametrize("kernel", ["selective_scan", "rglru_scan"])
def test_scan_serve_operands_shapes_and_ranges(kernel):
    """The serve-shape operands chip_smoke.py, kernel_variants.py and the
    GPU tests share, drawn here on the CPU at a short S."""
    args = kt.scan_serve_operands(kernel, 8, "cpu")
    again = kt.scan_serve_operands(kernel, 8, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(args, again))
    assert args[0].dtype == torch.bfloat16
    if kernel == "selective_scan":
        x, dt, A, B, C, D, h0 = args
        assert x.shape == dt.shape == (1, 8, 8192) and A.shape == (8192, 16)
        assert B.shape == C.shape == (1, 8, 16) and h0.shape == (1, 8192, 16)
        assert 1e-3 <= dt.min() and dt.max() < 0.1
        assert torch.equal(A[0], -torch.arange(1.0, 17.0))
    else:
        x, a, h0 = args
        assert a.dtype == torch.bfloat16 and h0.shape == (1, 4096)
        assert 0.5 <= a.float().min() and a.float().max() <= 1.0
    assert not h0.any()
    assert kt.scan_serve_operands(kernel, 8, "cpu", seed=1,
                                  h0=True)[-1].any()


@pytest.mark.parametrize("kernel", ["selective_scan", "rglru_scan"])
def test_scan_train_operands_shapes_and_ranges(kernel, monkeypatch):
    """The training-shape operands of the backward timing, at the models'
    widths, drawn here on the CPU at a short S and few channels."""
    cfg = get_config("falcon-mamba-7b" if kernel == "selective_scan"
                     else "recurrentgemma-9b")
    full = kt.SCAN_TRAIN[kernel]
    assert full["S"] == 4096
    if kernel == "selective_scan":
        assert (full["Di"], full["N"]) == (cfg.d_inner, cfg.ssm_state)
    else:
        assert full["D"] == cfg.d_rnn_
    monkeypatch.setattr(kt, "SCAN_TRAIN", {
        "selective_scan": dict(B=2, S=8, Di=16, N=16),
        "rglru_scan": dict(B=1, S=8, D=16)})
    args, dy, dhf = kt.scan_train_operands(kernel, "cpu")
    again = kt.scan_train_operands(kernel, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        [*args, dy, dhf], [*again[0], *again[1:]]))
    assert args[0].dtype == dy.dtype == torch.bfloat16
    assert dy.shape == args[0].shape and dhf.dtype == torch.float32
    assert dhf.shape == args[-1].shape and not args[-1].any()
    if kernel == "rglru_scan":
        a = args[1]
        assert a.dtype == torch.bfloat16 and 0.5 <= a.float().min()
        assert a.float().max() < 1.0


MINPLUS_SASS = """
\t\tFunction : _ZN12_GLOBAL__N_114minplus_kernelINS_8GeometryILi96ELi96ELi6EEEEvPKf
        /*0000*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0010*/                   LDGSTS.E.BYPASS.LTC128B.128 [R2], desc[UR4][R4.64] ; /* 0x0000000004027fae */
        /*0018*/                   LDGSTS.E.BYPASS.LTC128B.128 [R2+0x10], desc[UR4][R6.64] ; /* 0x0000000006027fae */
        /*0020*/                   LDS.128 R8, [R3] ;                     /* 0x0000000003087984 */
        /*0030*/                   FADD R9, R8, R10 ;                     /* 0x0000000a08097221 */
        /*0040*/                   FMNMX.NAN R11, R11, R9, PT ;           /* 0x000000090b0b7209 */
        /*0050*/                   FADD R9, R8, R12 ;                     /* 0x0000000c08097221 */
        /*0060*/                   FMNMX.NAN R13, R13, R9, PT ;           /* 0x000000090d0d7209 */
        /*0070*/               @P0 BRA 0x0 ;                              /* 0xfffffffc00e80947 */
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000000000007b1d */
        /*0090*/              @!P1 BRA 0xb0 ;                             /* 0x0000000000048947 */
        /*00a0*/                   LDGSTS.E.LTC128B [R2], desc[UR4][R4.64] ; /* 0x0000000004027fae */
        /*00b0*/                   LDS.128 R8, [R3] ;                     /* 0x0000000003087984 */
        /*00c0*/                   FADD R9, R8, R10 ;                     /* 0x0000000a08097221 */
        /*00d0*/                   FMNMX.NAN R11, R11, R9, PT ;           /* 0x000000090b0b7209 */
        /*00e0*/                   FADD R9, R8, R12 ;                     /* 0x0000000c08097221 */
        /*00f0*/                   FMNMX.NAN R13, R13, R9, PT ;           /* 0x000000090d0d7209 */
        /*0100*/               @P2 BRA 0x80 ;                             /* 0xfffffffc00e82947 */
        /*0110*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_minplus_issues_count_the_steady_loop_with_its_staging():
    """The steady-state loop stages by cp.async (LDGSTS) every trip; the
    edge loop's copy is guarded (skipped by a forward branch), so its count
    is shorter, and without ``needs`` the shortest of equals would win."""
    instrs = kt.sass_functions(MINPLUS_SASS)[
        "_ZN12_GLOBAL__N_114minplus_kernelINS_8GeometryILi96ELi96ELi6EEEEvPKf"]
    assert kt.loop_issues(instrs, "FADD") == (8, 2)
    assert kt.loop_issues(instrs, "FADD", needs=("LDGSTS",)) == (9, 2)
    assert kt.minplus_issues(instrs) == (9, 2)
    assert kt.MINPLUS_LOOP_NEEDS == ("LDGSTS",)
    # A kernel that stages without cp.async (the first port's) falls back.
    plain = [x for x in instrs if x[1] != "LDGSTS"]
    assert kt.minplus_issues(plain) == kt.loop_issues(plain, "FADD")


def test_minplus_bound_is_the_instruction_bound():
    """2 M N K instructions (an FADD and an FMNMX an update) at 128 lanes a
    clock on each SM: 0.21665 ms at 1536^3 on 132 SMs at 1 980 MHz, twice
    the 67 TFLOP/s figure, which counts an FFMA as two operations."""
    ms = kt.minplus_bound_ms(1536, 1536, 1536, 132, 1.98e9)
    assert ms == pytest.approx(0.21665, abs=1e-5)
    assert ms == pytest.approx(1e3 * 2 * 1536 ** 3 / (132 * 128 * 1.98e9))
    assert ms > 1.9 * 1e3 * 2 * 1536 ** 3 / 67e12
    assert kt.minplus_bound_ms(702, 702, 702, 132, 1.98e9) == pytest.approx(
        0.020684, abs=1e-5)
    # The APSP of the smoke: 11 squarings at V = 1536.
    assert 11 * ms == pytest.approx(2.384, abs=1e-3)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi64EEEvNS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi64EEEvNS_7BwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 640 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126flash_attention_mma_kernelILi64E13__nv_bfloat16EEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_126flash_attention_mma_kernelILi64E13__nv_bfloat16EEvNS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers, 600 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_bwd_dkdv_mma_kernelILi256EEEvNS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125flash_bwd_dkdv_mma_kernelILi256EEEvNS_7BwdArgsE
    24 bytes stack frame, 24 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 640 bytes cmem[0]
"""


def test_ptxas_usage_reads_the_backward_instances():
    """``kernel_compare.py --bwd --sass``'s registers and spills per
    backward instance, from a written ptxas log."""
    got = kt.ptxas_usage(PTXAS_LOG, "flash_bwd")
    dq = "_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi64EEEvNS_7BwdArgsE"
    dkdv = ("_ZN12_GLOBAL__N_125flash_bwd_dkdv_mma_kernelILi256EEEvNS_"
            "7BwdArgsE")
    assert got == {
        dq: {"registers": 168, "stack": 0, "spill_stores": 0,
             "spill_loads": 0},
        dkdv: {"registers": 255, "stack": 24, "spill_stores": 24,
               "spill_loads": 32}}
