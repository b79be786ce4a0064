"""
Problem: assembles priors + composites into one log-posterior and drives
the samplers.

Re-design of ``beat/models/problems.py``: ``built_model`` (pymc graph,
:212) becomes ``make_logp_fn`` (pure JAX closure); ``init_sampler`` /
``sample`` (:121, ``models/base.py:195``) dispatch to the on-device
samplers; ``estimate_hypers`` (``models/base.py:304``) runs the cheap
hyperparameter-only Metropolis and rewrites hyper prior bounds.
"""

from __future__ import annotations

import logging
import os

import jax.numpy as jnp
import numpy as np

from beat_tpu.backend import SampleStage, summarize_trace
from beat_tpu.parameter import Parameter, PriorSet
from beat_tpu.samplers import (MetropolisParams, PTParams, SMCParams,
                               metropolis_sample, pt_sample, smc_sample)

logger = logging.getLogger("beat_tpu.models.problem")


class Problem:
    """
    A fully-specified inverse problem: sampled parameters (source priors +
    hyperparameters + hierarchicals) and the composites whose likelihoods
    sum into ``like`` (reference ``Problem.built_model``
    ``models/problems.py:212-248``).
    """

    def __init__(self, priors: PriorSet, composites: dict, outfolder: str = "out",
                 sampler_params=None, hyper_sampler_params=None,
                 initialization: str = "random"):
        self.source_priors = priors
        self.composites = dict(composites)
        self.outfolder = outfolder
        self.sampler_params = sampler_params or SMCParams()
        self.hyper_sampler_params = hyper_sampler_params
        self.initialization = initialization
        self._logp_fn = None

        # full sampled space: source params + hierarchicals + hyperparams
        self.priors = PriorSet()
        for p in priors.parameters.values():
            self.priors.add(p)
        for comp in self.composites.values():
            for p in comp.get_hierarchical_parameters():
                if p.name not in self.priors:
                    self.priors.add(p)
        for comp in self.composites.values():
            for p in comp.get_hyper_parameters():
                if p.name not in self.priors:
                    self.priors.add(p)

    @property
    def ordering(self):
        return self.priors.ordering

    @property
    def hypernames(self):
        names = []
        for comp in self.composites.values():
            names.extend(comp.get_hypernames())
        return names

    # -- log-posterior assembly ---------------------------------------------

    def logp_data(self):
        """Per-composite device-data pytree (GF tables, weights, data
        vectors) — threaded through jit as *arguments*, so multi-GB GF
        arrays are never folded into the executable as constants and can
        be sharded/replicated over the device mesh (SURVEY §7: RawArray
        memshare → device arrays)."""
        return tuple(comp.device_data() for comp in self.composites.values())

    def make_logp_fn(self):
        """Returns ``(logp, data)``: a pure function
        ``logp(q_flat, data) -> total data log-likelihood`` ('like') and
        the device-data pytree to pass as its second argument (samplers
        take it via ``logp_args=(data,)``).

        Every float32 matmul inside ``logp`` runs at
        :data:`~beat_tpu.distributions.LIKELIHOOD_PRECISION`
        (:func:`~beat_tpu.distributions.pinned_precision`).

        The closure is built ONCE and cached on the instance: the jit
        caches of the samplers key on the function's identity, so a
        fresh closure per ``sample()`` call would silently recompile
        the whole step program.  Data stays a per-call argument —
        weight hot-swaps change arrays, never the function."""
        if self._logp_fn is None:
            from beat_tpu.distributions import pinned_precision

            ordering = self.ordering
            comps = list(self.composites.values())

            def logp(q, data):
                point = ordering.to_point(q)
                total = 0.0
                for comp, d in zip(comps, data):
                    total = total + comp.loglike(point, d)
                return total

            self._logp_fn = pinned_precision(logp)
        return self._logp_fn, self.logp_data()

    def make_hyper_logp_fn(self, fixed_point: dict):
        """Hyperparameter-only posterior with residuals frozen at
        ``fixed_point`` (reference ``built_hyper_model`` :261).
        Returns ``(logp, data)`` like :meth:`make_logp_fn`.

        Composites exposing ``hyper_data`` get their weighted residual
        norms precomputed ONCE here (one forward synthesis total), so a
        hyper draw costs O(n_datasets) instead of a full forward per
        draw (reference fixed-residual ``hyper_normal``,
        ``models/distributions.py:176``); others fall back to
        ``hyper_loglike``."""
        from beat_tpu.distributions import hyper_normal, pinned_precision

        ordering = self.ordering
        comps = list(self.composites.values())
        fixed = {k: jnp.asarray(v) for k, v in fixed_point.items()}

        precomp = []       # (wrw, slog_pdets, nsamples, hyper names)
        fallback = []      # indexes into comps/data
        for ci, comp in enumerate(comps):
            hd = getattr(comp, "hyper_data", None)
            if hd is not None:
                precomp.append(pinned_precision(hd)(fixed))
            else:
                fallback.append(ci)

        def logp(q, data):
            point = ordering.to_point(q)
            total = 0.0
            for wrw, pds, ns, names in precomp:
                hs = jnp.stack([jnp.reshape(jnp.asarray(
                    point.get(n, 0.0)), ()) for n in names])
                total = total + jnp.sum(hyper_normal(wrw, pds, hs, ns))
            for ci in fallback:
                total = total + comps[ci].hyper_loglike(point, fixed,
                                                        data[ci])
            return total

        return pinned_precision(logp), self.logp_data()

    # -- sampling -----------------------------------------------------------

    def sample(self, params=None, update_weights: bool = False):
        """Run the configured sampler (reference ``models/base.py:195``)."""
        from beat_tpu.compile_cache import enable_persistent_compile_cache

        enable_persistent_compile_cache()
        params = params or self.sampler_params
        lower, upper = self.priors.bounds_arrays()
        logp_fn, data = self.make_logp_fn()
        logp_args = (data,)
        os.makedirs(self.outfolder, exist_ok=True)

        update_cb = None
        if update_weights:
            def update_cb(map_q):
                point = self.ordering.to_point(map_q)
                self.update_weights(point)
                # refreshed covariances → refreshed device weights
                return (self.logp_data(),)

        from beat_tpu.ffi.transd import TransDParams

        if isinstance(params, TransDParams):
            from beat_tpu.models.distributer import (
                GeodeticDistributerComposite, transd_sample_ffi)

            comp = next((c for c in self.composites.values()
                         if isinstance(c, GeodeticDistributerComposite)), None)
            if comp is None:
                raise ValueError("TransD sampling needs a geodetic "
                                 "distributer composite (ffi mode)")
            return transd_sample_ffi(comp, params, homepath=self.outfolder)
        mesh = self._auto_mesh(params.n_chains)
        if isinstance(params, SMCParams):
            start = None
            if self.initialization == "lsq":
                start = self._lsq_start(params.n_chains, lower, upper,
                                        seed=params.seed)
            return smc_sample(logp_fn, lower, upper, params,
                              homepath=self.outfolder, ordering=self.ordering,
                              update_weights=update_cb, logp_args=logp_args,
                              start=start, mesh=mesh)
        elif isinstance(params, PTParams):
            return pt_sample(logp_fn, lower, upper, params,
                             homepath=self.outfolder, ordering=self.ordering,
                             logp_args=logp_args, mesh=mesh)
        elif isinstance(params, MetropolisParams):
            from beat_tpu.backend import SampleStage

            handler = SampleStage(self.outfolder, ordering=self.ordering)
            return metropolis_sample(
                logp_fn, lower, upper, n_chains=params.n_chains,
                n_steps=params.n_steps, burn=params.burn, thin=params.thin,
                proposal_name=params.proposal_name,
                tune_interval=params.tune_interval, seed=params.seed,
                stage_handler=handler, logp_args=logp_args,
                n_leapfrog=params.n_leapfrog)
        raise TypeError(f"Unknown sampler params {type(params)}")

    @staticmethod
    def _auto_mesh(n_chains: int):
        """Shard chains over all local devices when more than one exists
        and the chain count divides evenly (multi-chip engages with no
        code changes; single-chip stays meshless)."""
        import jax

        n_dev = len(jax.devices())
        if n_dev <= 1:
            return None
        if n_chains % n_dev:
            logger.warning(
                "%i chains do not divide %i devices — running single-"
                "device (pad n_chains for chain parallelism)",
                n_chains, n_dev)
            return None
        from beat_tpu.parallel import make_chain_mesh

        logger.info("Chain-sharding %i chains over %i devices",
                    n_chains, n_dev)
        return make_chain_mesh()

    def _lsq_start(self, n_chains: int, lower, upper, seed: int = 0):
        """Start population jittered around the NNLS warm start of the
        slip components (reference ``FFIConfig.initialization='lsq'`` +
        ``DistributionOptimizer.lsq_solution``, ``models/problems.py:753``);
        non-slip parameters draw from the prior."""
        rng = np.random.default_rng(seed)
        start = rng.uniform(lower, upper, size=(n_chains, lower.size))
        sol = None
        for comp in self.composites.values():
            get = getattr(comp, "lsq_solution", None)
            if get is not None:
                sol = get()
                break
        if sol is None:
            logger.warning("initialization='lsq' but no composite has an "
                           "lsq_solution — starting from the prior")
            return start
        for name, values in sol.items():
            if name not in self.ordering:
                continue
            sl = self.ordering[name].slc
            scale = 0.1 * (upper[sl] - lower[sl])
            jitter = rng.normal(0.0, scale, size=(n_chains, values.size))
            start[:, sl] = np.clip(values[None, :] + jitter,
                                   lower[sl], upper[sl])
            logger.info("LSQ start for %s: mean %.3f", name, values.mean())
        return start

    def estimate_hypers(self, n_steps: int | None = None,
                        n_chains: int | None = None):
        """
        Cheap hyperparameter-only Metropolis run; rewrites hyper prior
        bounds around the sampled range (reference ``estimate_hypers``
        ``models/base.py:304-379``).  Defaults come from
        ``hyper_sampler_params`` when configured (reference
        ``hyper_sampler_config``).
        """
        hp = self.hyper_sampler_params
        if n_steps is None:
            n_steps = getattr(hp, "n_steps", None) or 5000
        if n_chains is None:
            n_chains = getattr(hp, "n_chains", None) or 20
        test_point = self.priors.test_point()
        logp_fn, data = self.make_hyper_logp_fn(test_point)
        lower, upper = self.priors.bounds_arrays()
        # sample ONLY the hyper dimensions (the posterior is flat in all
        # others since residuals are frozen — walking the full space just
        # slows mixing and rejects on irrelevant bound checks; reference
        # samples a hypers-only model, models/base.py:304)
        hyper_slices = {name: self.ordering.slice_of(name)
                        for name in self.hypernames}
        idx = np.concatenate([np.arange(s.start, s.stop)
                              for s in hyper_slices.values()])
        test_q = jnp.asarray(self.point_to_array(test_point),
                             dtype=jnp.float32)
        idx_dev = jnp.asarray(idx)

        def hyper_only_logp(h, data):
            return logp_fn(test_q.at[idx_dev].set(h), data)

        q_tr, _ = metropolis_sample(
            hyper_only_logp, lower[idx], upper[idx],
            n_chains=n_chains, n_steps=n_steps,
            burn=0.5, thin=2, logp_args=(data,))
        samples = q_tr.reshape(-1, q_tr.shape[-1])
        # reduced-vector positions of each hyper
        pos = {}
        off = 0
        for name, s in hyper_slices.items():
            pos[name] = slice(off, off + (s.stop - s.start))
            off += s.stop - s.start
        from beat_tpu import defaults

        for name in self.hypernames:
            vals = samples[:, pos[name]]
            lo = np.floor(vals.min(axis=0) - 1.0)
            hi = np.ceil(vals.max(axis=0) + 1.0)
            par = self.priors[name]
            # clip to the registry's physical bounds (reference
            # models/base.py:355-379 + defaults registry), not a hard-coded box
            phys_lo, phys_hi = defaults.physical_bounds(name)
            par.lower = np.maximum(lo, phys_lo)
            par.upper = np.minimum(hi, phys_hi)
            par.testvalue = (par.lower + par.upper) / 2.0
            logger.info("Hyper %s bounds -> [%s, %s]", name, par.lower, par.upper)
        return {name: (self.priors[name].lower, self.priors[name].upper)
                for name in self.hypernames}

    # -- utilities ----------------------------------------------------------

    def point_to_array(self, point: dict) -> np.ndarray:
        """Flatten a (possibly partial) point; unspecified variables take
        their prior test values (the reference bijection's dummy-fill for
        fixed variables, ``utility.py:184-208``)."""
        full = self.priors.test_point()
        full.update(point)
        return self.ordering.to_array(full)

    def update_weights(self, point: dict) -> None:
        for comp in self.composites.values():
            comp.update_weights(point)

    def get_synthetics(self, point: dict) -> dict:
        return {name: comp.get_synthetics(point)
                for name, comp in self.composites.items()}

    def get_variance_reductions(self, point: dict) -> dict:
        return {name: comp.get_variance_reductions(point)
                for name, comp in self.composites.items()}

    def summarize(self, stage: int = -1) -> dict:
        handler = SampleStage(self.outfolder, ordering=self.ordering)
        return summarize_trace(handler.load_trace(stage))

    def derived_samples(self, stage: int = -1, max_samples: int = 2000) -> dict:
        """
        Derived-variable posterior samples (reference ``summarize
        --calc_derived``, ``derived_variables_mapping`` ``config.py:114``):
        nodal planes + normalised MT components for MT-family sources,
        moment magnitude for slip-parameterised sources.
        """
        import jax.numpy as jnp

        from beat_tpu import mt_utils
        from beat_tpu.sources import (DCSource, ExplosionSource, MTQTSource,
                                      MTSource, RectangularSource,
                                      moment_to_magnitude)

        handler = SampleStage(self.outfolder, ordering=self.ordering)
        trace = handler.load_trace(stage)
        flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
        idx = np.linspace(0, flat.shape[0] - 1,
                          min(max_samples, flat.shape[0])).astype(int)

        template = None
        fault = None
        for comp in self.composites.values():
            if hasattr(comp, "sources") and comp.sources:
                template = comp.sources[0]
            if hasattr(comp, "fault"):
                fault = comp.fault
        out: dict[str, list] = {}

        def add(name, val):
            out.setdefault(name, []).append(float(val))

        for q in flat[idx]:
            point = self.ordering.to_point(q)
            if isinstance(template, (MTSource, MTQTSource)):
                from beat_tpu.models.seismic import source_m6

                jpoint = {k: jnp.asarray(v) for k, v in point.items()}
                m6 = np.asarray(source_m6(template, jpoint, 0, 1))
                m6n = m6 / max(mt_utils.scalar_moment(m6), 1e-30)
                for comp_name, v in zip(("mnn", "mee", "mdd", "mne", "mnd", "med"), m6n):
                    add(f"{comp_name}_derived", v)
                (s1, d1, r1), (s2, d2, r2) = mt_utils.both_strike_dip_rake(m6)
                for n_, v in (("strike1", s1), ("dip1", d1), ("rake1", r1),
                              ("strike2", s2), ("dip2", d2), ("rake2", r2)):
                    add(n_, v)
            if isinstance(template, RectangularSource) and "slip" in point:
                area = (point.get("length", template.length)
                        * point.get("width", template.width))
                m0 = 33e9 * area * abs(float(np.atleast_1d(point["slip"])[0]))
                add("magnitude", float(moment_to_magnitude(m0)))
            if fault is not None and "uparr" in point:
                slips = np.sqrt(np.asarray(point["uparr"]) ** 2
                                + np.asarray(point.get("uperp", 0.0)) ** 2)
                add("magnitude", fault.magnitude(slips))
        return {k: np.asarray(v) for k, v in out.items()}


def load_model(project_dir: str, mode: str = "geometry", build: bool = True) -> Problem:
    """
    Load a problem from a project directory config
    (reference ``load_model`` ``models/problems.py:883``).
    """
    from beat_tpu.config import load_config, problem_from_config

    config = load_config(project_dir, mode)
    return problem_from_config(config, project_dir, build=build)
