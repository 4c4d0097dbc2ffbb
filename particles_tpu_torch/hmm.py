"""Finite hidden Markov models and exact Baum-Welch filtering and smoothing
(PyTorch port of ``particles_tpu/hmm.py``).

:class:`HMM` and :class:`GaussianHMM` are state-space models on the states
{0, ..., K - 1} (int64 particles); :class:`BaumWelch` is the exact
forward/backward algorithm, the oracle of a particle filter on a finite
state space, with its recursions as Python loops on the data's device.
"""

from __future__ import annotations

import torch

import particles_tpu_torch.distributions as dists
from particles_tpu_torch import resampling as rs
from particles_tpu_torch import state_space_models as ssms

__all__ = ["HMM", "GaussianHMM", "BaumWelch"]


class HMM(ssms.StateSpaceModel):
    """Base class for finite hidden Markov models: subclass and define
    ``PY``.  Parameters: ``trans_mat`` (K, K), the transition matrix, and
    ``init_dist`` (K,), the initial probabilities (uniform by default);
    tensors, or arrays that become tensors on the CPU."""

    default_params = {"init_dist": None, "trans_mat": None}

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.trans_mat is None:
            raise ValueError("Transition Matrix is missing")
        self.trans_mat = torch.as_tensor(self.trans_mat)
        if self.init_dist is None:
            K = self.trans_mat.shape[0]
            self.init_dist = torch.full((K,), 1.0 / K,
                                        dtype=self.trans_mat.dtype,
                                        device=self.trans_mat.device)
        else:
            self.init_dist = torch.as_tensor(self.init_dist)

    @property
    def dim(self):
        return self.trans_mat.shape[0]

    def PX0(self):
        return dists.Categorical(p=self.init_dist)

    def PX(self, t, xp):
        return dists.Categorical(p=self.trans_mat[xp, :])


class GaussianHMM(HMM):
    r"""Gaussian HMM: Y_t | X_t = k ~ N(mus[k], sigmas[k]^2)."""

    default_params = {"mus": None, "sigmas": None}
    default_params.update(HMM.default_params)

    def PY(self, t, xp, x):
        return dists.Normal(loc=self.mus[x], scale=self.sigmas[x])


class BaumWelch:
    """Exact forward/backward algorithm for a finite HMM whose Y_t depends on
    X_t only.

    After ``forward()``: ``filt``/``pred`` (T, K) probabilities, ``logpyt``
    (T,) log-likelihood factors, ``logft`` (T, K) emission log-densities.
    After ``backward()``: ``smth`` (T, K).  ``sample(gen, N)`` draws N
    trajectories from the smoothing law, (T, N) int64.  Computes in the
    floating dtype of the model's ``trans_mat`` (pass float64 for a
    float64 oracle), on its device.
    """

    def __init__(self, hmm=None, data=None):
        self.hmm = hmm
        self.data = torch.as_tensor(data, device=hmm.trans_mat.device)
        self.pred = None
        self.filt = None
        self.logpyt = None
        self.logft = None
        self.smth = None

    def forward(self):
        """Forward recursion over all T observations."""
        hmm, data = self.hmm, self.data
        trans = hmm.trans_mat
        states = torch.arange(hmm.dim, device=trans.device)
        self.logft = torch.stack([
            hmm.PY(t, None, states).logpdf(data[t].to(trans.dtype))
            for t in range(data.shape[0])])
        pred, preds, filts, logpyts = hmm.init_dist, [], [], []
        for t in range(data.shape[0]):
            if t > 0:
                pred = filts[-1] @ trans
            lp = torch.log(pred) + self.logft[t]
            logpyt = rs.log_sum_exp(lp)
            preds.append(pred)
            filts.append(torch.exp(lp - logpyt))
            logpyts.append(logpyt)
        self.pred = torch.stack(preds)
        self.filt = torch.stack(filts)
        self.logpyt = torch.stack(logpyts)

    @property
    def logLt(self):
        """Exact log-likelihood log p(y_{0:T-1})."""
        if self.logpyt is None:
            self.forward()
        return self.logpyt.sum()

    def backward(self):
        """Backward recursion for the marginal smoothing probabilities."""
        if self.filt is None:
            self.forward()
        log_trans = torch.log(self.hmm.trans_mat)
        T = self.filt.shape[0]
        ctg = torch.zeros_like(self.filt[0])   # the log cost to go
        smths = [self.filt[-1]]
        for t in range(T - 2, -1, -1):
            ctg = torch.logsumexp(log_trans + (self.logft[t + 1] + ctg), 1)
            smths.append(rs.exp_and_normalise(torch.log(self.filt[t]) + ctg))
        self.smth = torch.stack(smths[::-1])

    def run(self):
        self.forward()
        self.backward()

    def sample(self, gen, N=1):
        """N trajectories from the joint smoothing law, (T, N) int64, drawn
        from ``gen`` on its device."""
        if self.filt is None:
            self.forward()
        T = self.filt.shape[0]
        log_trans = torch.log(self.hmm.trans_mat)
        x = dists.Categorical(p=self.filt[-1]).rvs(gen, size=N)
        path = [x]
        for t in range(T - 2, -1, -1):
            lp = log_trans.T[x] + torch.log(self.filt[t])
            x = dists.Categorical(p=torch.softmax(lp, 1)).rvs(gen)
            path.append(x)
        return torch.stack(path[::-1])
