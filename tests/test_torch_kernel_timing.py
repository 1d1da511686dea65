"""``repro_torch.launch.kernel_timing``: the SASS hot-loop count behind the
issue floors, and the timed ``run_experiment`` configurations, on the CPU.

The SASS is written in ``cuobjdump -sass``'s layout: a ``Function :``
line per kernel, then one instruction a line, ``/*address*/``, an
optional predicate, the mnemonic, its operands, ``;`` and the encoding.
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.core import api
from repro_torch.launch import kernel_timing as kt

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
    arch, config, evals, norm, ga, backend = kt.RUNS[name]
    cfg = kt.experiment_config(api, name)
    assert (cfg.arch, cfg.config, cfg.budget.evals, cfg.norm_samples) == (
        arch, config, evals, norm)
    p = cfg.params["ga"]
    assert (p.population, p.elitism, p.tournament) == ga
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
