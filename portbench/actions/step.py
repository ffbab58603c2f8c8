"""Frame action "step": ``sim.step(state, cfg, dt)``, the CFL
substeps of one frame of ``dt`` seconds, as the testbed's frame loop runs it.

A frame fails if the state is not finite, the particle count changed, the
last substep's CG residual reached the tolerance or its iterations the
maximum, or its correction left particles without a spring
(``correction_uncorrected``). Its answer is the state after the frame,
held to the reference's frame from the state before it.
"""

import torch

from portbench.hostcopy import to_host


def setup(f) -> None:
    f.cfg = f.system.sim_config(f.conf)


def seed(f) -> None:
    """The configuration's seeded state and its particle count."""
    f.state = f.system.seeded_state(f.cfg, f.conf, f.seed)
    f.particles = int(f.state.active.sum())


def run(f) -> None:
    f.state, f.diag = f.system.step(f.state, f.cfg, f.dt)


def flags(f) -> dict:
    st, d, solver = f.state, f.diag, f.cfg.solver
    live = st.active[:, None]
    finite = (torch.isfinite(torch.where(live, st.position, 0.0)).all()
              & torch.isfinite(torch.where(live, st.velocity, 0.0)).all())
    return {
        "state not finite": ~finite,
        "particle count changed": d.particle_count != f.particles,
        "CG residual at the tolerance": ~(d.pressure_residual < solver.tolerance),
        "CG at its iteration limit": d.pressure_iterations >= solver.max_iterations,
        "particles left uncorrected": d.correction_uncorrected > 0,
    }


def values(f) -> dict:
    return {"substeps": f.diag.substeps, "cg_iterations": f.diag.pressure_iterations,
            "uncorrected": f.diag.correction_uncorrected}


def capture_before(f, case: dict) -> None:
    case["pre"], case["dt"] = to_host(f.state), f.dt


def capture(f, case: dict) -> None:
    case["post"] = to_host(f.state)


def compare(case: dict, ref) -> dict:
    return ref.sim_frame(case["pre"], case["post"], case["dt"])
