"""The CG iteration as two steps with its scalars on the device
(``pressure.cg_direction``, ``pressure.cg_update``, kernels "cg_direction"
and "cg_update" of ``csrc/cg.cu``) and the solve loop that reads the exit flag
``_EXIT_LAG`` iterations behind the queue, on the CPU: the plain steps
against the unfused expressions they replace, and the loop against a copy
of the loop it replaced, bit for bit (torch only, no JAX)."""

import numpy as np
import pytest
import torch

from libfluid_tpu_torch import _build, profiling
from libfluid_tpu_torch.config import CellType
from libfluid_tpu_torch.sim import kernels as t_kernels
from libfluid_tpu_torch.sim import multigrid as t_multigrid
from libfluid_tpu_torch.sim import pressure as t_pressure

torch.set_num_threads(1)

TOL = 1e-6
A_SCALE = 0.0125


def _problem(shape, seed: int, warm: bool):
    """Solid floor and a pillar, random fluid in the lower half: the levels,
    a right-hand side on the fluid and a warm start (or None)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    ct = np.full(shape, CellType.AIR, np.int8)
    ct[:, 0, :] = CellType.SOLID
    ct[nx // 3: nx // 3 + 2, :, nz // 3: nz // 3 + 2] = CellType.SOLID
    fluid = rng.uniform(size=shape) < 0.7
    fluid[:, ny // 2:, :] = False
    ct[fluid & (ct == CellType.AIR)] = CellType.FLUID
    levels = t_multigrid.build_levels(torch.from_numpy(ct))
    b = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) * levels[0].fluid
    x0 = torch.from_numpy(rng.normal(size=shape).astype(np.float32)) * 0.1 if warm else None
    return levels, b, x0


def _cg_unfused(levels, b, a_scale, tol, max_iters, precond, x0=None):
    """The loop that ``pressure._cg`` replaced, as it was: every vector operation
    eager, the residual read on the host each iteration."""
    lvl0 = levels[0]
    if precond == "mg16":
        levels16 = t_multigrid.Hierarchy(
            t_multigrid.MGLevel(*[f.to(torch.bfloat16) for f in lev[:-1]], lev.scale) for lev in levels)

    def apply_M(r):
        if precond == "mg16":
            return t_multigrid.v_cycle(levels16, r.to(torch.bfloat16)).to(r.dtype) / a_scale
        if precond == "mg":
            return t_multigrid.v_cycle(levels, r) / a_scale
        return lvl0.inv_diag / a_scale * r

    def apply_A1(p):
        return t_multigrid.apply_level(lvl0, p) * a_scale

    b2 = torch.sum(b * b)
    nontrivial = bool(b2 >= 1e-6)
    if x0 is None:
        p = torch.zeros_like(b)
        r = b
    else:
        p = x0 * lvl0.fluid if nontrivial else torch.zeros_like(b)
        r = b - apply_A1(p)
    z = apply_M(r)
    s = z
    sigma = torch.sum(z * r)
    res = torch.amax(torch.abs(r)) if nontrivial else torch.zeros((), dtype=b.dtype)
    it = 0
    while nontrivial and it < max_iters and bool(res >= tol):
        z = apply_A1(s)
        alpha = sigma / t_pressure._safe(torch.sum(z * s))
        p = p + alpha * s
        r = r - alpha * z
        res = torch.amax(torch.abs(r))
        z = apply_M(r)
        sigma_new = torch.sum(z * r)
        beta = sigma_new / t_pressure._safe(sigma)
        s = z + beta * s
        sigma = sigma_new
        it += 1
    return p * lvl0.fluid, res, it


def _solve_counted(*args, **kwargs):
    """pressure._cg inside a recorded span: (result, the span's counters)."""
    profiling.clear()
    with profiling.tracing(), profiling.span("pressure"):
        res = t_pressure._cg(*args, **kwargs)
    counters = profiling.frames()[-1].spans[-1].counters
    profiling.clear()
    return res, counters


# (preconditioner, warm start, right-hand side, iteration bound)
CASES = {
    "mg_cold": ("mg", False, "random", 200),
    "mg_warm": ("mg", True, "random", 200),
    "mg16_cold": ("mg16", False, "random", 200),
    "mg16_warm": ("mg16", True, "random", 200),
    "jacobi_cold": ("jacobi", False, "random", 200),
    "jacobi_warm": ("jacobi", True, "random", 200),
    "early_out": ("mg", True, "zero", 200),
    "max_iters": ("mg", True, "random", 3),
    # the time step, and so a_scale, is a device value on the main path
    "mg_warm_scale_tensor": ("mg", True, "random", 200),
}


@pytest.mark.parametrize("lag", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_equals_the_unfused_loop(case, lag, monkeypatch):
    """Iterations, residual and pressure bit for bit against the replaced
    loop at every exit lag; at most ``_EXIT_LAG`` iterations enqueued after
    the exit, one "cg.loop" read per iteration it ran and one more."""
    precond, warm, rhs, max_iters = CASES[case]
    monkeypatch.setattr(t_pressure, "_EXIT_LAG", lag)
    levels, b, x0 = _problem((16, 16, 16), 5, warm)
    if rhs == "zero":
        b = torch.zeros_like(b)
    a_scale = torch.tensor(A_SCALE) if case.endswith("tensor") else A_SCALE
    want_p, want_res, want_it = _cg_unfused(levels, b, a_scale, TOL, max_iters, precond, x0=x0)
    got, counters = _solve_counted(levels, b, a_scale, TOL, max_iters, precond, x0=x0)
    assert int(got.iterations) == want_it == counters.get("cg_iterations", 0)
    assert torch.equal(got.residual, want_res)
    assert torch.equal(got.pressure, want_p)
    assert counters["cg.plain"] == 1 and "cg.kernel" not in counters
    if rhs == "zero":
        assert want_it == 0 and "reads.cg.loop" not in counters
        return
    assert want_it == (max_iters if case == "max_iters" else want_it) > 0
    assert 0 <= counters["cg_iterations_skipped"] <= lag
    if case != "max_iters":
        assert counters["cg_iterations_skipped"] == lag
        assert counters["reads.cg.loop"] == want_it + 1


def _step_inputs(seed: int):
    levels, b, _ = _problem((12, 10, 14), seed, False)
    gen = torch.Generator().manual_seed(seed)
    w, r, s = (torch.randn(b.shape, generator=gen) * levels[0].fluid for _ in range(3))
    return levels[0], w, r, s


@pytest.mark.parametrize("case", ["first", "later", "zero_sigma", "zero_qs", "done"])
def test_direction_equals_the_unfused_expressions(case):
    """sigma' = z . r, beta (0 the first time), s, q = a_scale A_1 s, alpha
    and sigma as the replaced loop formed them, bit for bit; safe(x) = 1 at
    a zero denominator; nothing written once done."""
    lvl0, w, r, s = _step_inputs(1)
    m_scale = A_SCALE
    if case == "zero_qs":
        w = torch.zeros_like(w)  # z = 0, so s = 0 and q . s = 0
    sigma_old = 0.0 if case == "zero_sigma" else 0.37
    sc = torch.tensor([sigma_old, 5.0, 7.0, A_SCALE, m_scale])
    st = torch.tensor([4, int(case == "done")], dtype=torch.int32)
    s_new, q = s.clone(), torch.full_like(s, 3.0)
    before = (s_new.clone(), q.clone(), sc.clone(), st.clone())
    t_pressure._cg_direction_torch(w, r, s_new, q, lvl0, case == "first", sc, st)
    if case == "done":
        for got, want in zip((s_new, q, sc, st), before):
            assert torch.equal(got, want)
        return
    z = w / m_scale
    sigma_new = torch.sum(z * r)
    if case == "first":
        want_s = z
    else:
        sigma = torch.tensor(sigma_old)
        want_s = z + sigma_new / torch.where(sigma != 0.0, sigma, torch.ones_like(sigma)) * s
    want_q = t_multigrid.apply_level(lvl0, want_s) * A_SCALE
    qs = torch.sum(want_q * want_s)
    want_alpha = sigma_new / torch.where(qs != 0.0, qs, torch.ones_like(qs))
    assert torch.equal(s_new, want_s) and torch.equal(q, want_q)
    assert torch.equal(sc, torch.stack([sigma_new, want_alpha, *torch.tensor([7.0, A_SCALE, m_scale])]))
    assert torch.equal(st, before[3])
    if case == "zero_qs":
        assert float(qs) == 0.0 and float(sc[1]) == float(sigma_new)
    if case == "zero_sigma":
        assert torch.equal(s_new, z + sigma_new * s)


@pytest.mark.parametrize("case", ["continue", "converged", "max_iters", "done"])
def test_update_equals_the_unfused_expressions(case):
    """p += alpha s, r -= alpha q, res = max |r|, the count and the exit
    test, bit for bit; nothing written once done."""
    lvl0, p, r, s = _step_inputs(2)
    q = torch.randn(r.shape, generator=torch.Generator().manual_seed(9))
    if case == "converged":
        s, q = s * 0.0, r.clone()  # alpha 1 takes r to 0
    alpha = 1.0 if case == "converged" else 0.031
    sc = torch.tensor([0.5, alpha, 9.0, A_SCALE, A_SCALE])
    st = torch.tensor([5, int(case == "done")], dtype=torch.int32)
    max_iters = 6 if case == "max_iters" else 200
    pp, rr, sc0 = p.clone(), r.clone(), sc.clone()
    t_pressure._cg_update_torch(pp, rr, s, q, sc, st, TOL, max_iters)
    if case == "done":
        assert torch.equal(pp, p) and torch.equal(rr, r)
        assert torch.equal(sc, sc0) and st.tolist() == [5, 1]
        return
    a = torch.tensor(alpha)
    want_p, want_r = p + a * s, r - a * q
    want_res = torch.amax(torch.abs(want_r))
    assert torch.equal(pp, want_p) and torch.equal(rr, want_r)
    assert torch.equal(sc[2], want_res)
    assert st.tolist() == [6, int(case != "continue")]


def test_the_card_path_launches_the_two_kernels(monkeypatch):
    """On CUDA tensors the solve launches "cg_direction" and
    "cg_update" once per iteration it enqueues (with the arguments of their
    C signatures) and no plain step runs. Without a card the dispatch is
    made to see CUDA tensors and each launch runs the step's plain version
    on its arguments: the same bits as the plain steps, and a failing
    launch raises."""
    launched, failing, reads, inside = [], [], [], []
    direction_torch, update_torch = t_pressure._cg_direction_torch, t_pressure._cg_update_torch

    def launch(kernel, entry, *args):
        inside.append(kernel)  # what the stand-in reads is the device's own
        try:
            run(kernel, entry, *args)
        finally:
            inside.pop()

    def run(kernel, entry, *args):
        assert len(args) + 1 == len(_build.SIGNATURES[entry])
        if len(inside) == 1:  # not the operator inside cg_direction's stand-in
            launched.append(kernel)
        if kernel in failing:
            raise RuntimeError(f"{kernel} kernel ({entry}) failed")
        if kernel == "stencil":
            x, b, diag, inv_diag, fluid, cu, cv, cw, out = args[:9]
            lvl = t_multigrid.MGLevel(fluid, diag, inv_diag, cu, cv, cw, args[14])
            out.copy_(t_multigrid._stencil_torch(lvl, x, b, args[12], args[13]))
        elif kernel == "cg_direction":
            w, r, s, q, diag, fluid, cu, cv, cw, scale, first, sc, st = args[:13]
            lvl = t_multigrid.MGLevel(fluid, diag, diag, cu, cv, cw, scale)
            direction_torch(w, r, s, q, lvl, bool(first), sc, st)
        elif kernel == "cg_update":
            p, r, s, q, sc, st, _part, n, tol, max_iters = args
            assert n == r.numel()
            update_torch(p, r, s, q, sc, st, tol, max_iters)
        else:
            raise AssertionError(f"unexpected launch {kernel}")

    levels, b, x0 = _problem((16, 16, 16), 5, True)
    a_scale = torch.tensor(A_SCALE)  # a device value on the card
    want, want_counters = _solve_counted(levels, b, a_scale, TOL, 200, "jacobi", x0=x0)
    monkeypatch.setattr(t_kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(t_kernels, "launch", launch)
    monkeypatch.setattr(t_pressure, "_cg_direction_torch", None)  # no plain step on the card
    monkeypatch.setattr(t_pressure, "_cg_update_torch", None)
    # a Python value of a tensor is a host read on the card: outside the
    # launches, the early-out's only
    for name in ("item", "__float__", "__int__", "__bool__"):
        def counted(self, *a, _f=getattr(torch.Tensor, name), _name=name):
            if not inside:
                reads.append(_name)
            return _f(self, *a)
        monkeypatch.setattr(torch.Tensor, name, counted)
    got, counters = _solve_counted(levels, b, a_scale, TOL, 200, "jacobi", x0=x0)
    monkeypatch.undo()
    assert reads == ["item"]
    it = int(want.iterations)
    assert torch.equal(got.pressure, want.pressure) and torch.equal(got.residual, want.residual)
    assert int(got.iterations) == it > 0
    assert counters["cg.kernel"] == 1 and "cg.plain" not in counters
    enqueued = it + counters["cg_iterations_skipped"]
    assert launched == ["stencil"] + ["cg_direction", "cg_update"] * enqueued
    assert counters["cg_iterations_skipped"] == want_counters["cg_iterations_skipped"] == t_pressure._EXIT_LAG

    monkeypatch.setattr(t_kernels, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(t_kernels, "launch", launch)
    failing.append("cg_update")
    with pytest.raises(RuntimeError, match="cg_update"):
        t_pressure._cg(levels, b, A_SCALE, TOL, 200, "jacobi", x0=x0)
    with pytest.raises(TypeError, match="float32"):  # the kernels take float32 only
        t_pressure._cg(levels, b.double(), A_SCALE, TOL, 200, "jacobi")
