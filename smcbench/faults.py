"""Faults planted in the program, for showing that the comparison which
decides ``correct`` fails them: the CPU tests plant each at small sizes
(``tests/test_smcbench_faults.py``), and ``controls.py --fault <name>``
at a cell's own size on the card.  The benchmark's own runs plant none.

Each fault is ``plant(patch, params)``: it replaces what it breaks
through ``patch(owner, attribute, value)`` (pytest's
``monkeypatch.setattr``, or ``setattr`` in a process that ends after)
and returns the mix parameters it overrides.

Filters (the driver ``offline_runs``):

- ``stuck``: a step that hands back the state it was given;
- ``half``: the filtered mean taken over every other particle, a fair
  half of them;
- ``altered``: one step's filtered mean moved by 1 where it is made.

Samplers (the driver ``sampler_runs``):

- ``stuck``: a step that hands back the state it was given;
- ``half``: the evidence increment taken over every other particle;
- ``altered``: the likelihood off by a part in 10^4 where it is made;
- ``wrong_target``: a Metropolis step that accepts at twice the log
  ratio, so that its chains leave the square of the tempered posterior
  invariant; the log-posteriors it stores and the acceptance rate it
  reports stay true to what it did;
- ``never_accept``: a Metropolis step that rejects every proposal;
- ``prior_narrow``: the prior's draws scaled by 0.8;
- ``multinomial``: multinomial resampling where the mix states
  systematic.
"""

from __future__ import annotations

import inspect
import math


def _stuck_filter(patch, params):
    import torch

    from particles_tpu_torch import core
    from particles_tpu_torch import resampling as rs

    name = "_step_qmc" if params.get("qmc") else "_step"
    sig = inspect.signature(getattr(core, name))

    def stuck(*args, **kwargs):
        a = sig.bind(*args, **kwargs).arguments
        carry, summaries = a["carry"], a["summaries"]
        wgts = rs.Weights(carry.lw)
        view = core.StepView(
            fk=a["fk"], t=a["t"], X=carry.X, Xp=carry.X, A=None, wgts=wgts,
            aux=wgts, rs_flag=True, logLt=carry.logLt,
            loglt=torch.zeros_like(carry.logLt), N=a["N"],
            ESSrmin=a["ESSrmin"], gen=a["gen"])
        states, outs = summaries.step(view, carry.col_states)
        return carry._replace(col_states=states), view, outs

    patch(core, name, stuck)
    return {}


def _half_mean(patch, params):
    from particles_tpu_torch import resampling as rs

    orig = rs.wmean_and_var

    def half(W, x):
        return orig(W[::2] / W[::2].sum(), x[::2])

    patch(rs, "wmean_and_var", half)
    return {}


def _altered_mean(patch, params):
    from particles_tpu_torch import resampling as rs

    orig = rs.wmean_and_var
    calls = [0]

    def altered(W, x):
        out = orig(W, x)
        calls[0] += 1
        if calls[0] == 10:
            out = dict(out, mean=out["mean"] + 1.0)
        return out

    patch(rs, "wmean_and_var", altered)
    return {}


def _stuck_sampler(patch, params):
    import torch

    from particles_tpu_torch import core
    from particles_tpu_torch import resampling as rs
    from particles_tpu_torch import smc_samplers as ssp

    def stuck(fk, gen, carry, t, N, scheme, ESSrmin, draws=None):
        wgts = rs.Weights(carry.lw)
        view = core.StepView(
            fk=fk, t=t, X=carry.X, Xp=carry.X, A=None, wgts=wgts, aux=wgts,
            rs_flag=True, logLt=carry.logLt,
            loglt=torch.zeros_like(carry.logLt), N=N, ESSrmin=ESSrmin,
            gen=gen)
        return carry, view

    patch(ssp, "_sampler_step", stuck)
    return {}


def _half_evidence(patch, params):
    import torch

    from particles_tpu_torch import smc_samplers as ssp

    orig = ssp._sampler_step

    def half(*args, **kwargs):
        carry, view = orig(*args, **kwargs)
        lw = carry.lw[::2]
        loglt = torch.logsumexp(lw, 0) - math.log(lw.shape[0])
        logLt = view.logLt - view.loglt + loglt
        return (carry._replace(logLt=logLt),
                view._replace(loglt=loglt, logLt=logLt))

    patch(ssp, "_sampler_step", half)
    return {}


def _altered_loglik(patch, params):
    from particles_tpu_torch import smc_samplers as ssp

    orig = ssp.StaticModel.loglik

    def altered(self, theta, t=None):
        return orig(self, theta, t) * (1.0 + 1e-4)

    patch(ssp.StaticModel, "loglik", altered)
    return {}


def _wrong_target(patch, params):
    import torch

    from particles_tpu_torch import smc_samplers as ssp

    def step_with(self, x, target, z, u, tdraws=None, out=None):
        arr = ssp.view_2d_array(x.theta)
        arr_prop, delta_lp = self.proposal(z, x, arr)
        xx = x.replace(theta=ssp.theta_from_2d(arr_prop, x.theta))
        xprop = target(xx) if tdraws is None else target(xx, tdraws)
        lp_acc = 2.0 * (xprop.lpost - x.lpost) + delta_lp
        lp_acc = torch.where(torch.isnan(lp_acc), -torch.inf, lp_acc)
        pb_acc = torch.exp(lp_acc.clamp(max=0.0))
        accept = u < pb_acc
        return xprop.where(accept, x, out=out), ssp._dist_mean(pb_acc)

    patch(ssp.ArrayMetropolis, "step_with", step_with)
    return {}


def _never_accept(patch, params):
    import torch

    from particles_tpu_torch import smc_samplers as ssp

    orig = ssp.ArrayMetropolis.step_with

    def never(self, x, target, z, u, tdraws=None, out=None):
        return orig(self, x, target, z, torch.ones_like(u), tdraws, out)

    patch(ssp.ArrayMetropolis, "step_with", never)
    return {}


def _prior_narrow(patch, params):
    from particles_tpu_torch import distributions as dists

    orig = dists.MvNormal.rvs

    def narrow(self, gen, size=None):
        return 0.8 * orig(self, gen, size)

    patch(dists.MvNormal, "rvs", narrow)
    return {}


def _multinomial(patch, params):
    return {"resampling": "multinomial"}


FAULTS = {
    "offline_runs": {"stuck": _stuck_filter, "half": _half_mean,
                     "altered": _altered_mean},
    "sampler_runs": {"stuck": _stuck_sampler, "half": _half_evidence,
                     "altered": _altered_loglik,
                     "wrong_target": _wrong_target,
                     "never_accept": _never_accept,
                     "prior_narrow": _prior_narrow,
                     "multinomial": _multinomial},
}


def plant(cell, name, patch=setattr, params=None):
    """Plant the fault ``name`` for the cell's driver; the mix parameters
    it overrides, on top of ``params``."""
    mix = dict(cell.traffic["params"], **(params or {}))
    return dict(params or {}, **FAULTS[cell.traffic["driver"]][name](
        patch, mix))
