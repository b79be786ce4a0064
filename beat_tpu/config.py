"""
Typed project configuration with YAML persistence.

Re-design of ``beat/config.py`` (pyrocko.guts YAML tree): dataclasses with
recursive ``to_dict``/``from_dict``; one config file per mode in the
project directory (``config_geometry.yaml``, ``config_ffi.yaml``,
``config_bem.yaml``; reference ``config.py:2294-2336``).

Semantic parity:
* ``modes_catalog`` geometry / ffi / bem (reference ``config.py:106-112``)
* priors as named bounded Parameters validated against physical bounds
* per-datatype configs (geodetic/seismic/polarity) with noise estimators
  and corrections
* sampler configs: SMC / Metropolis / PT (reference ``config.py:1698-1833``)
"""

from __future__ import annotations

import glob
import logging
import os
from dataclasses import asdict, dataclass, field

import numpy as np
import yaml

from beat_tpu import defaults
from beat_tpu.parameter import Parameter, PriorSet
from beat_tpu.samplers import MetropolisParams, PTParams, SMCParams

logger = logging.getLogger("beat_tpu.config")

geometry_mode_str = "geometry"
ffi_mode_str = "ffi"
bem_mode_str = "bem"
MODES = [geometry_mode_str, ffi_mode_str, bem_mode_str]

#: slip-component variable registries (reference ``config.py:81-96``)
static_dist_vars = ["uparr", "uperp", "utens"]
derived_dist_vars = ["coupling"]
hypo_vars = ["nucleation_strike", "nucleation_dip", "time"]
partial_kinematic_vars = ["durations", "velocities"] + hypo_vars
kinematic_dist_vars = static_dist_vars + partial_kinematic_vars
transd_vars_dist = ["npatches"]

#: what `summarize --calc_derived` appends (reference ``config.py:114-123``)
derived_variables_mapping = {
    "MTQTSource": ["mnn", "mee", "mdd", "mne", "mnd", "med",
                   "strike1", "dip1", "rake1", "strike2", "dip2", "rake2"],
    "MTSource": ["magnitude", "strike1", "dip1", "rake1",
                 "strike2", "dip2", "rake2"],
    "DCSource": ["magnitude"],
    "RectangularSource": ["magnitude"],
    "ExplosionSource": ["magnitude"],
}


# ---------------------------------------------------------------------------
# Event metadata
# ---------------------------------------------------------------------------


@dataclass
class EventConfig:
    name: str = "event"
    lat: float = 0.0
    lon: float = 0.0
    depth: float = 10000.0  # [m]
    time: float = 0.0       # epoch [s]
    magnitude: float = 6.0
    #: catalog source duration [s] (reference ``pf.Event.duration``)
    duration: float | None = None
    #: catalog moment tensor (mnn/mee/mdd/mne/mnd/med [+ sdr pairs]) —
    #: the "true reference value" in plots and acceptance tests
    #: (reference embeds the GCMT solution in its example configs)
    moment_tensor: dict | None = None


# ---------------------------------------------------------------------------
# Datatype configs
# ---------------------------------------------------------------------------


@dataclass
class NoiseEstimatorConfig:
    """Reference ``SeismicNoiseAnalyserConfig`` (``config.py:591``) /
    geodetic noise estimator options."""

    structure: str = "variance"   # variance|exponential|import|non-toeplitz
    pre_arrival_time: float = 5.0
    max_dist_perc: float = 0.2


@dataclass
class RampConfig:
    enabled: bool = True
    dataset_names: list = field(default_factory=list)


@dataclass
class EulerPoleConfig:
    enabled: bool = True
    station_whitelist: list = field(default_factory=list)
    station_blacklist: list = field(default_factory=list)
    #: datasets this correction applies to (reference
    #: ``CorrectionConfig.dataset_names`` ``config.py:802-914``); empty =
    #: every dataset with geographic coordinates.  SAR datasets honor
    #: their polygon ``mask`` (reference ``DiffIFG.get_data_mask``).
    dataset_names: list = field(default_factory=list)


@dataclass
class StrainRateConfig:
    enabled: bool = True
    station_whitelist: list = field(default_factory=list)
    station_blacklist: list = field(default_factory=list)
    dataset_names: list = field(default_factory=list)


@dataclass
class GeodeticCorrectionsConfig:
    """Reference ``config.py:895-913``."""

    ramps: RampConfig | None = None
    euler_poles: list = field(default_factory=list)
    strain_rates: list = field(default_factory=list)


@dataclass
class GeodeticConfig:
    """Reference ``GeodeticConfig`` (``config.py:971``)."""

    datadir: str = "./"
    names: list = field(default_factory=lambda: ["all"])
    #: dataset types to load (reference ``GeodeticConfig.types``
    #: ``config.py:971``: declared types select which datasets enter the
    #: problem)
    types: list = field(default_factory=lambda: ["SAR", "GNSS"])
    noise_estimator: NoiseEstimatorConfig = field(
        default_factory=lambda: NoiseEstimatorConfig(structure="import"))
    interpolation: str = "multilinear"
    corrections: GeodeticCorrectionsConfig = field(default_factory=GeodeticCorrectionsConfig)
    dataset_specific_residual_noise_estimation: bool = False
    #: layered static GF build parameters (reference ``GeodeticGFConfig``
    #: ``config.py:325``): earth_model, distance/depth grids,
    #: n_variations/error_* for the uncertainty ensemble, nu_variations
    #: (homogeneous Poisson-ratio ensemble)
    gf_config: dict = field(default_factory=dict)


@dataclass
class ArrivalTaperConfig:
    """Cosine taper fractions a<b<c<d around the phase arrival
    (reference ``heart.ArrivalTaper`` :266)."""

    a: float = -15.0
    b: float = -10.0
    c: float = 50.0
    d: float = 55.0


@dataclass
class FilterConfig:
    """One filter spec (reference ``heart.Filter`` :342,
    ``BandstopFilter`` :383, ``FrequencyFilter`` :402).  ``type`` selects
    butterworth (bandpass), bandstop, or frequency (flat passband with
    cosine flanks, using ``freqlimits``).  A wavemap's ``filterer`` may
    be one spec or a list applied in sequence (the reference's
    list-of-filters semantics, ``config.py:563``)."""

    lower_corner: float = 0.001
    upper_corner: float = 0.1
    order: int = 4
    type: str = "butterworth"
    freqlimits: tuple = None


def build_filterer(fc):
    """Heart filter object(s) from a FilterConfig or a list of them."""
    from beat_tpu.heart.taper import (BandstopFilter, Filter, FilterChain,
                                      FrequencyFilter)

    def one(c):
        t = getattr(c, "type", "butterworth").lower()
        if t == "butterworth":
            return Filter(c.lower_corner, c.upper_corner, c.order)
        if t == "bandstop":
            return BandstopFilter(c.lower_corner, c.upper_corner, c.order)
        if t == "frequency":
            return FrequencyFilter(tuple(c.freqlimits)
                                   if c.freqlimits is not None
                                   else (0.005, 0.01, 0.1, 0.2))
        raise ValueError(f"Unknown filter type {c.type!r} "
                         "(butterworth | bandstop | frequency)")

    if isinstance(fc, (list, tuple)):
        filters = [one(c) for c in fc]
        return filters[0] if len(filters) == 1 else FilterChain(tuple(filters))
    return one(fc)


@dataclass
class WaveformFitConfig:
    """Reference ``WaveformFitConfig`` (``config.py:540``)."""

    include: bool = True
    #: filter the observed traces during preparation; set False for
    #: data filtered offline (reference ``preprocess_data``
    #: ``config.py:547``); synthetics are always filtered
    preprocess_data: bool = True
    name: str = "any_P"           # phase
    #: CSV of picked arrivals `station,time_s` (seconds after origin)
    #: overriding predicted arrival times (reference
    #: ``arrivals_marker_path``, ``config.py:540``)
    arrivals_path: str | None = None
    channels: list = field(default_factory=lambda: ["Z"])
    filterer: FilterConfig = field(default_factory=FilterConfig)
    arrival_taper: ArrivalTaperConfig = field(default_factory=ArrivalTaperConfig)
    #: epicentral distance range [deg] stations must fall in (reference
    #: ``WaveformFitConfig.distances`` + ``station_weeding``
    #: ``heart.py:2952``); None disables distance weeding
    distances: tuple = None
    interpolation: str = "multilinear"
    domain: str = "time"          # time | spectrum
    quantity: str = "displacement"
    blacklist: list = field(default_factory=list)
    event_idx: int = 0


@dataclass
class SeismicConfig:
    """Reference ``SeismicConfig`` (``config.py:618``)."""

    datadir: str = "./"
    noise_estimator: NoiseEstimatorConfig = field(default_factory=NoiseEstimatorConfig)
    #: StationXML inventory used for instrument-response removal during
    #: ``beat-tpu import --seismic_mseed`` (reference ``responses_path``
    #:  ``config.py:628``; import-time only)
    responses_path: str | None = None
    #: reference ``pre_stack_cut`` (``config.py:629``) trims traces to the
    #: arrival window *before* stacking sources.  The device forward always
    #: windows through the fused windowed-iDFT basis — numerically the
    #: pre-cut path — so False is accepted and has no effect.
    pre_stack_cut: bool = True
    station_corrections: bool = False
    waveforms: list = field(default_factory=lambda: [WaveformFitConfig()])
    dataset_specific_residual_noise_estimation: bool = False
    gf_config: dict = field(default_factory=dict)


@dataclass
class PolarityFitConfig:
    """One polarity phase map (reference ``PolarityFitConfig``
    ``config.py:720``): picked first motions of one phase, fit with its
    own radiation pattern and noise hyperparameter."""

    name: str = "any_P"           # phase: *_P | *_SH | *_SV
    include: bool = True
    #: per-map data file ``polarity_data_<name>.npz`` in the datadir
    #: overrides the shared ``polarity_data.npz`` (reference
    #: ``polarities_marker_path`` picked markers, ``config.py:725``)
    polarities_path: str | None = None
    blacklist: list = field(default_factory=list)
    #: multi-event problems: which event's source this map constrains
    event_idx: int = 0


@dataclass
class PolarityConfig:
    datadir: str = "./"
    waveforms: list = field(default_factory=lambda: [PolarityFitConfig()])
    gf_config: dict = field(default_factory=dict)


@dataclass
class BoundaryConditionConfig:
    """One traction boundary condition linking source/receiver meshes
    (reference ``BoundaryCondition`` ``config.py:1155-1199``).  The
    driving traction itself is a *sampled* parameter
    (``<slip_component>_traction`` prior, defaults-registry bounds)."""

    slip_component: str = "normal"   # strike | dip | normal
    source_idxs: list = field(default_factory=lambda: [0])
    receiver_idxs: list = field(default_factory=lambda: [0])


@dataclass
class BEMConfig:
    """bem-mode engine configuration (reference ``BEMConfig``
    ``config.py:1202-1218``).  ``mesh_size`` in km (config units)."""

    poissons_ratio: float = 0.25
    shear_modulus: float = 33e9      # [Pa]
    mesh_size: float = 0.5           # [km] target triangle size
    check_mesh_intersection: bool = True
    medium: str = "halfspace"        # halfspace (Mindlin) | fullspace (Kelvin)
    #: far/near triangle-subdivision levels of the traction assembly
    #: ((2, 6) ≈ 3 % penny-crack accuracy; (1, 4-5) ≈ 4x faster solves
    #: for geometry sampling)
    quadrature_level: int = 2
    near_quadrature_level: int = 6
    boundary_conditions: list = field(
        default_factory=lambda: [BoundaryConditionConfig()])

    def make_engine(self):
        from beat_tpu.bem import BEMEngine, BoundaryCondition

        bcs = [BoundaryCondition(bc.slip_component, list(bc.source_idxs),
                                 list(bc.receiver_idxs))
               for bc in self.boundary_conditions]
        return BEMEngine(bcs, mesh_size=self.mesh_size * 1e3,
                         poissons_ratio=self.poissons_ratio,
                         shear_modulus=self.shear_modulus,
                         check_mesh_intersection=self.check_mesh_intersection,
                         medium=self.medium,
                         quadrature_level=self.quadrature_level,
                         near_quadrature_level=self.near_quadrature_level)


# ---------------------------------------------------------------------------
# Problem / sampler configs
# ---------------------------------------------------------------------------


@dataclass
class ProblemConfig:
    """Reference ``ProblemConfig`` (``config.py:1339``)."""

    mode: str = geometry_mode_str
    source_types: list = field(default_factory=lambda: ["RectangularSource"])
    n_sources: list = field(default_factory=lambda: [1])
    datatypes: list = field(default_factory=lambda: ["geodetic"])
    stf_type: str = "HalfSinusoid"
    #: ffi-mode start population: 'random' (prior) or 'lsq' (around the
    #: NNLS warm start; reference FFIConfig.initialization, config.py:1109)
    initialization: str = "random"
    decimation_factors: dict = field(default_factory=dict)
    priors: dict = field(default_factory=dict)   # name -> Parameter dict
    #: hyperparameter (and hierarchical) prior overrides, persisted like
    #: the reference's config ``hyperparameters`` section
    #: (``beat/config.py`` ProblemConfig.hyperparameters); filled/refreshed
    #: by ``update_hypers_in_config`` (reference ``beat update``)
    hyperparameters: dict = field(default_factory=dict)

    #: config-layer units follow the reference (km, km/s for these vars;
    #: ``beat/defaults.py`` registry); the device layer is SI.
    KM_SCALED_VARS = ("east_shift", "north_shift", "depth", "length", "width",
                      "nucleation_strike", "nucleation_dip", "diameter",
                      "locking_depth", "depth_bottom", "distance",
                      "a_half_axis", "b_half_axis", "a_half_axis_bottom",
                      "b_half_axis_bottom", "delta_east_shift_bottom",
                      "delta_north_shift_bottom", "velocities", "height")

    def get_prior_set(self, to_si: bool = False, skip_fixed: bool = False) -> PriorSet:
        """Priors in config (reference) units, or converted to SI for the
        device layer (analogue of ``utility.adjust_point_units``
        ``beat/utility.py:651``).  Parameters with ``lower == upper`` are
        *fixed* (reference convention) and skipped when requested."""
        ps = PriorSet()
        for name, d in self.priors.items():
            p = Parameter.from_dict(d if isinstance(d, dict) else d)
            if skip_fixed and np.all(p.lower == p.upper):
                continue
            if to_si and name in self.KM_SCALED_VARS:
                p = Parameter(name=p.name, lower=p.lower * 1e3,
                              upper=p.upper * 1e3, testvalue=p.testvalue * 1e3,
                              form=p.form)
            ps.add(p)
        return ps

    def get_fixed_params(self, to_si: bool = True) -> dict:
        """Parameters fixed via lower == upper (config units or SI)."""
        out = {}
        for name, d in self.priors.items():
            p = Parameter.from_dict(d if isinstance(d, dict) else d)
            if np.all(p.lower == p.upper):
                val = p.lower * (1e3 if (to_si and name in self.KM_SCALED_VARS) else 1.0)
                out[name] = val if p.dimension > 1 else float(val[0])
        return out

    def set_default_priors(self, variables: list[str], n_sources: int = 1) -> None:
        """Seed priors from the defaults registry
        (reference ``get_random_variables``/``init_vars``)."""
        for name in variables:
            dim = n_sources if n_sources > 1 else 1
            p = Parameter.from_defaults(name, dimension=dim)
            self.priors[name] = p.to_dict()

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        self.get_prior_set().validate()

    def set_decimation_factors(self) -> None:
        """Fill datatype decimation factors for extended-source synthesis
        (reference ``set_decimation_factor`` ``config.py:1555`` +
        ``defaults.default_decimation_factors``): only RectangularSource
        is affected; higher factor = coarser point-source discretization."""
        if "RectangularSource" in self.source_types:
            for datatype in self.datatypes:
                self.decimation_factors.setdefault(
                    datatype, DEFAULT_DECIMATION_FACTORS.get(datatype, 1))

    def finite_patches(self, datatype: str) -> tuple:
        """(n_length, n_width) point-source grid for finite
        RectangularSource synthesis, derived from the datatype's
        decimation factor: the base 8x8 grid divided by the factor
        (reference: pyrocko RS ``decimation_factor`` coarsens the
        sub-source grid inside ``engine.process``)."""
        factor = int(self.decimation_factors.get(
            datatype, DEFAULT_DECIMATION_FACTORS.get(datatype, 2)))
        n = max(2, _FINITE_PATCH_BASE // max(factor, 1))
        return (n, n)


#: reference ``defaults.default_decimation_factors`` (``defaults.py:17``)
DEFAULT_DECIMATION_FACTORS = {"polarity": 1, "geodetic": 4, "seismic": 2}
#: finite-source base grid: 8x8 point sources at decimation_factor 1
_FINITE_PATCH_BASE = 8


@dataclass
class SamplerConfig:
    """Reference ``SamplerConfig`` (``config.py:1836``)."""

    name: str = "SMC"  # SMC | Metropolis | PT | TransD (ffi slip mode)
    backend: str = "npz"
    progressbar: bool = True
    buffer_thinning: int = 1
    parameters: dict = field(default_factory=dict)

    def get_params(self):
        if self.name == "SMC":
            return SMCParams(**self.parameters)
        elif self.name == "PT":
            return PTParams(**self.parameters)
        elif self.name == "Metropolis":
            return MetropolisParams(**self.parameters)
        elif self.name == "TransD":
            from beat_tpu.ffi.transd import TransDParams

            return TransDParams(**self.parameters)
        raise ValueError(f"Unknown sampler {self.name}")


@dataclass
class BEATconfig:
    """Top-level project config (reference ``BEATconfig`` ``config.py:1929``)."""

    name: str = "project"
    date: str = ""
    version: str = ""   # stamped by beat_tpu.upgrade migrations
    event: EventConfig = field(default_factory=EventConfig)
    #: further events estimated jointly with the main event — wavemaps
    #: select theirs via ``WaveformFitConfig.event_idx`` (reference
    #: ``BEATconfig.subevents`` ``config.py:1939``)
    subevents: list = field(default_factory=list)
    project_dir: str = "./"
    problem_config: ProblemConfig = field(default_factory=ProblemConfig)
    geodetic_config: GeodeticConfig | None = None
    seismic_config: SeismicConfig | None = None
    polarity_config: PolarityConfig | None = None
    bem_config: BEMConfig | None = None
    sampler_config: SamplerConfig = field(default_factory=SamplerConfig)
    hyper_sampler_config: SamplerConfig | None = None

    def validate(self):
        self.problem_config.validate()

    @property
    def events(self) -> list:
        """[main event] + subevents (reference ``Problem.events``
        ``models/problems.py:115``)."""
        return [self.event] + list(self.subevents)


# ---------------------------------------------------------------------------
# YAML round trip
# ---------------------------------------------------------------------------

_NESTED = {
    "event": EventConfig,
    "problem_config": ProblemConfig,
    "geodetic_config": GeodeticConfig,
    "seismic_config": SeismicConfig,
    "polarity_config": PolarityConfig,
    "sampler_config": SamplerConfig,
    "hyper_sampler_config": SamplerConfig,
    "noise_estimator": NoiseEstimatorConfig,
    "corrections": GeodeticCorrectionsConfig,
    "ramps": RampConfig,
    "filterer": FilterConfig,
    "arrival_taper": ArrivalTaperConfig,
    "bem_config": BEMConfig,
}

_NESTED_LISTS = {
    "subevents": EventConfig,
    "waveforms": WaveformFitConfig,
    "filterer": FilterConfig,
    "euler_poles": EulerPoleConfig,
    "strain_rates": StrainRateConfig,
    "boundary_conditions": BoundaryConditionConfig,
}

#: field names whose element type depends on the owning config class
#: (``waveforms`` means WaveformFitConfig in SeismicConfig but
#: PolarityFitConfig in PolarityConfig — reference ``config.py:636,745``)
_NESTED_LISTS_BY_CLASS = {
    ("PolarityConfig", "waveforms"): PolarityFitConfig,
}


def _from_dict(cls, d):
    if d is None:
        return None
    kwargs = {}
    for k, v in d.items():
        elem_cls = _NESTED_LISTS_BY_CLASS.get((cls.__name__, k),
                                              _NESTED_LISTS.get(k))
        if k in _NESTED and isinstance(v, dict):
            kwargs[k] = _from_dict(_NESTED[k], v)
        elif elem_cls is not None and isinstance(v, list):
            kwargs[k] = [_from_dict(elem_cls, x) if isinstance(x, dict) else x
                         for x in v]
        else:
            kwargs[k] = v
    return cls(**kwargs)


def config_file_name(mode: str) -> str:
    return f"config_{mode}.yaml"


def dump_config(config: BEATconfig, project_dir: str | None = None) -> str:
    from beat_tpu import __version__

    project_dir = project_dir or config.project_dir
    os.makedirs(project_dir, exist_ok=True)
    config.version = __version__
    path = os.path.join(project_dir, config_file_name(config.problem_config.mode))
    with open(path, "w") as f:
        yaml.safe_dump(asdict(config), f, sort_keys=False)
    logger.info("Wrote config to %s", path)
    return path


def load_config(project_dir: str, mode: str = geometry_mode_str) -> BEATconfig:
    path = os.path.join(project_dir, config_file_name(mode))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No {config_file_name(mode)} in {project_dir} — run 'beat-tpu init' first")
    with open(path) as f:
        d = yaml.safe_load(f)
    # version gate (reference ``ConfigNeedsUpdatingError`` config.py:189):
    # configs stamped by an older release must be migrated first
    from beat_tpu import __version__
    from beat_tpu.upgrade import _version_tuple

    stamped = d.get("version") or "0.0.0"
    if _version_tuple(stamped) < _version_tuple(__version__):
        raise ValueError(
            f"Config {path} was written by version {stamped} "
            f"(current {__version__}) — run 'beat-tpu update {project_dir}' "
            "to migrate it")
    config = _from_dict(BEATconfig, d)
    config.project_dir = project_dir
    config.validate()
    return config


# ---------------------------------------------------------------------------
# Project scaffolding + problem construction
# ---------------------------------------------------------------------------

#: variables sampled per source type in geometry mode
source_geometry_vars = {
    "RectangularSource": ["east_shift", "north_shift", "depth", "strike",
                          "dip", "rake", "length", "width", "slip"],
    "MTSource": ["east_shift", "north_shift", "depth",
                 "mnn", "mee", "mdd", "mne", "mnd", "med", "magnitude"],
    "MTQTSource": ["east_shift", "north_shift", "depth",
                   "w", "v", "kappa", "sigma", "h", "magnitude"],
    "DCSource": ["east_shift", "north_shift", "depth",
                 "strike", "dip", "rake", "magnitude"],
    "ExplosionSource": ["east_shift", "north_shift", "depth", "volume_change"],
    "CLVDSource": ["east_shift", "north_shift", "depth",
                   "azimuth", "dip", "magnitude"],
    "DoubleDCSource": ["east_shift", "north_shift", "depth",
                       "strike1", "dip1", "rake1", "strike2", "dip2", "rake2",
                       "mix", "delta_time", "delta_depth", "distance",
                       "azimuth", "magnitude"],
    "RingfaultSource": ["east_shift", "north_shift", "depth",
                        "strike", "dip", "diameter", "sign", "magnitude"],
}

#: extra temporal variables when seismic data participates
seismic_geometry_vars = ["time", "duration"]

#: variables sampled per BEM source type in bem mode (geometry of the
#: meshed crack; driving tractions are added per boundary condition)
bem_source_geometry_vars = {
    "TriangleBEMSource": ["east_shift", "north_shift", "depth"],
    "RectangularBEMSource": ["east_shift", "north_shift", "depth",
                             "strike", "dip", "length", "width"],
    "EllipseBEMSource": ["east_shift", "north_shift", "depth",
                         "a_half_axis", "b_half_axis", "strike", "dip",
                         "plunge"],
    "DiskBEMSource": ["east_shift", "north_shift", "depth",
                      "a_half_axis", "b_half_axis", "strike", "dip", "plunge"],
    "RingfaultBEMSource": ["east_shift", "north_shift", "depth",
                           "diameter", "height", "strike"],
    "CurvedBEMSource": ["east_shift", "north_shift", "depth",
                        "strike", "dip", "length", "width",
                        "bend_location", "bend_amplitude",
                        "curv_amplitude_bottom", "curv_location_bottom"],
}


def init_config(name: str, project_dir: str, mode: str = geometry_mode_str,
                source_types=("RectangularSource",), n_sources=(1,),
                datatypes=("geodetic",), sampler="SMC",
                event: EventConfig | None = None) -> BEATconfig:
    """
    Scaffold a new project (reference ``init_config`` ``config.py:2083``).
    """
    if mode == bem_mode_str:
        datatypes = ["geodetic"]   # reference: bem is geodetic-only
        if all(st not in bem_source_geometry_vars for st in source_types):
            source_types = ["DiskBEMSource"]
    pc = ProblemConfig(mode=mode, source_types=list(source_types),
                       n_sources=list(n_sources), datatypes=list(datatypes))
    variables: list[str] = []
    bem_config = None
    if mode == ffi_mode_str:
        variables.extend(static_dist_vars[:2])  # uparr, uperp
        if "seismic" in datatypes:
            variables.extend(partial_kinematic_vars)
    elif mode == bem_mode_str:
        from collections import Counter

        bem_config = BEMConfig()
        for st, ns in zip(source_types, n_sources):
            variables.extend(bem_source_geometry_vars[st])
        # one traction prior per slip component, vector-valued over the
        # BCs sharing it (linear-composite naming convention)
        bc_counts = Counter(bc.slip_component
                            for bc in bem_config.boundary_conditions)
        for comp_name, n in sorted(bc_counts.items()):
            p = Parameter.from_defaults(f"{comp_name}_traction", dimension=n)
            pc.priors[f"{comp_name}_traction"] = p.to_dict()
    else:
        for st, ns in zip(source_types, n_sources):
            variables.extend(source_geometry_vars[st])
        if "seismic" in datatypes:
            variables.extend(seismic_geometry_vars)
    total_sources = int(sum(n_sources))
    pc.set_default_priors(sorted(set(variables)), n_sources=total_sources)
    pc.set_decimation_factors()

    config = BEATconfig(name=name, project_dir=project_dir, event=event or EventConfig(),
                        problem_config=pc, bem_config=bem_config,
                        sampler_config=SamplerConfig(name=sampler))
    if "geodetic" in datatypes:
        config.geodetic_config = GeodeticConfig()
    if "seismic" in datatypes:
        config.seismic_config = SeismicConfig()
    if "polarity" in datatypes:
        config.polarity_config = PolarityConfig()
    config.validate()
    dump_config(config, project_dir)
    return config


def load_polarity_targets(project_dir: str, datadir: str = "./",
                          source_depth: float | None = None,
                          velocity_model=None, phase: str = "p",
                          filename: str = "polarity_data.npz",
                          blacklist=()) -> list:
    """
    Load first-motion observations from
    ``<project_dir>/polarity_data.npz``: arrays ``stations`` (string),
    ``azimuths_deg``, ``polarities`` (±1), and either

    * ``takeoffs_deg`` — precomputed takeoff angles (from the downward
      vertical), or
    * ``distances_m`` — epicentral distances; takeoffs are then
      ray-traced through ``velocity_model`` (a
      :class:`beat_tpu.heart.velocity_model.LayeredModel`; the project's
      ``velocity_model.npz`` / ``.nd`` if present, else the default
      crust) from ``source_depth`` — the native analogue of the
      reference's cake takeoff tables (``heart.py:2333``, picked marker
      files ``PolarityConfig`` ``config.py:743``).
    """
    from beat_tpu.heart.polarity import PolarityTarget

    path = os.path.join(project_dir, datadir, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No polarity data at {path}")
    blacklist = set(blacklist or ())
    with np.load(path, allow_pickle=False) as z:
        az = np.deg2rad(z["azimuths_deg"])
        pol = z["polarities"].astype(int)
        stations = [str(s) for s in z["stations"]]
        dists = z["distances_m"].astype(float) if "distances_m" in z.files \
            else None
        if "takeoffs_deg" in z.files:
            to = np.deg2rad(z["takeoffs_deg"])
        else:
            from beat_tpu.heart.velocity_model import takeoff_angles

            if dists is None:
                raise ValueError(
                    "polarity_data.npz needs 'takeoffs_deg' or 'distances_m'")
            if source_depth is None:
                raise ValueError(
                    "ray-traced takeoffs need the event source depth")
            model = velocity_model or load_velocity_model(project_dir)
            to = takeoff_angles(model, float(source_depth),
                                dists, phase=phase)
    return [PolarityTarget(station=stations[i], azimuth_rad=float(az[i]),
                           takeoff_rad=float(to[i]), polarity=int(pol[i]),
                           distance_m=(float(dists[i]) if dists is not None
                                       else None))
            for i in range(len(stations)) if stations[i] not in blacklist]


def _build_polarity_takeoff_table(project_dir: str, priors, targets,
                                  event_depth: float, phase: str,
                                  n_depths: int = 25, n_dists: int = 48):
    """(depth × distance) takeoff grid covering the sampled location
    priors, host-ray-traced once through the project's layered model —
    the device-resident analogue of the reference's cake interpolation
    tables (``heart.py:2333``) used for per-draw polarity geometry."""
    from beat_tpu.heart.polarity import build_takeoff_table

    if "depth" in priors:
        p = priors["depth"]
        zlo, zhi = float(np.min(p.lower)), float(np.max(p.upper))
    else:
        zlo = zhi = float(event_depth)
    if zhi - zlo < 1.0:  # degenerate span: widen so bilinear has a cell
        zlo, zhi = zlo - max(0.05 * zlo, 50.0), zhi + max(0.05 * zhi, 50.0)
    zlo = max(zlo, 1.0)

    dists = np.asarray([t.distance_m for t in targets], dtype=float)
    shift = 0.0
    for name in ("east_shift", "north_shift"):
        if name in priors:
            p = priors[name]
            shift = max(shift, float(np.max(np.abs(p.lower))),
                        float(np.max(np.abs(p.upper))))
    # shifts move the epicenter; distances change by at most the
    # horizontal shift magnitude (hypot of both components)
    rlo = max(float(dists.min()) - np.sqrt(2.0) * shift, 1.0)
    rhi = float(dists.max()) + np.sqrt(2.0) * shift + 1.0

    model = load_velocity_model(project_dir)
    return build_takeoff_table(
        model, np.linspace(zlo, zhi, n_depths),
        np.linspace(rlo, rhi, n_dists), phase=phase)


def _warn_coarse_finite_grid(pc, priors, seismic_config) -> None:
    """Convergence guard for finite RectangularSource waveform synthesis:
    warn when the configured fixed patch grid under-resolves the largest
    prior fault at the highest filter corner (the reference's pyrocko
    engine auto-discretizes wavelength-aware, ``heart.py:3564``; our
    chain-invariant grids need the config to be told)."""
    if "RectangularSource" not in pc.source_types:
        return
    from beat_tpu.models.seismic import recommended_finite_patches

    # fixed parameters (lower == upper, skipped from the prior set) are
    # the COMMON way fault geometry is configured — the guard must see
    # them or a fixed 40 km fault silently defaults to length 0
    fixed = pc.get_fixed_params(to_si=True)

    def upper(name, default):
        if name in priors:
            return float(np.max(priors[name].upper))
        if name in fixed:
            return float(np.max(fixed[name]))
        return default

    def lower(name, default):
        if name in priors:
            return float(np.min(priors[name].lower))
        if name in fixed:
            return float(np.min(fixed[name]))
        return default

    def max_passband_freq(fc):
        """Highest frequency a filterer spec lets through: the minimum
        upper corner across the chain's low-pass-limiting members
        (butterworth upper_corner, frequency freqlimits upper passband
        edge); bandstop rejects a band and bounds nothing."""
        specs = fc if isinstance(fc, (list, tuple)) else [fc]
        tops = []
        for c in specs:
            t = getattr(c, "type", "butterworth").lower()
            if t == "butterworth":
                tops.append(float(c.upper_corner))
            elif t == "frequency":
                fl = c.freqlimits if c.freqlimits is not None \
                    else (0.005, 0.01, 0.1, 0.2)
                tops.append(float(fl[2]))
        return min(tops) if tops else None

    corners = [max_passband_freq(w.filterer)
               for w in (seismic_config.waveforms or [])
               if getattr(w, "filterer", None) is not None
               and getattr(w, "include", True)]
    corners = [c for c in corners if c is not None]
    if not corners:
        return
    # worst case: largest fault, slowest rupture, highest corner
    n_rec = recommended_finite_patches(
        upper("length", 0.0), upper("width", 0.0), max(corners),
        velocity=lower("velocity", 3500.0))
    n_cfg = pc.finite_patches("seismic")
    if n_cfg[0] < n_rec[0] or n_cfg[1] < n_rec[1]:
        logger.warning(
            "finite-source grid %s under-resolves the prior: the largest "
            "fault (length %.3g m, width %.3g m) at the highest filter "
            "corner %.3g Hz with rupture velocity %.3g m/s needs >= %s "
            "patches (onset step < T_min/4). Lower "
            "decimation_factors['seismic'] or narrow the priors.",
            n_cfg, upper("length", 0.0), upper("width", 0.0), max(corners),
            lower("velocity", 3500.0), n_rec)


def import_results_as_priors(project_dir: str, mode: str, from_mode: str,
                             alpha: float = 0.06) -> list:
    """
    Import a previous run's posterior as the priors of ``mode``'s config
    (reference ``beat import --results --import_from_mode``
    ``apps/beat.py:543-770``): for every sampled variable present in
    both the source run's summary and the target config, the prior
    bounds narrow to the posterior HDI (clipped to the registry's
    physical bounds) and the test value moves to the posterior mean.
    Covers source parameters, hyperparameters, hierarchicals (station
    time shifts / corrections) and ffi→ffi slip vectors alike.

    Returns the list of updated variable names and rewrites the target
    config file.
    """
    from beat_tpu import defaults
    from beat_tpu.backend import extract_bounds_from_summary
    from beat_tpu.models.problem import load_model

    src_problem = load_model(project_dir, from_mode, build=True)
    summary = src_problem.summarize(-1)

    config = load_config(project_dir, mode)
    pc = config.problem_config
    # make sure the hyper/hierarchical section exists so those import too
    try:
        update_hypers_in_config(config, problem_from_config(config, project_dir))
    except Exception as e:  # data for the target mode may not exist yet
        logger.debug("Hyper refresh skipped: %s", e)

    updated = []
    for prior_dict in (pc.priors, pc.hyperparameters):
        for name, d in list(prior_dict.items()):
            p = Parameter.from_dict(d if isinstance(d, dict) else d)
            shape = () if p.dimension == 1 else (p.dimension,)
            try:
                lo, hi = extract_bounds_from_summary(summary, name, shape=shape,
                                                     alpha=alpha)
                means = [summary[name if not shape else f"{name}[{k}]"]["mean"]
                         for k in range(p.dimension)]
            except KeyError:
                continue
            # trace/summary is SI; config layer uses reference units (km)
            scale = 1e-3 if name in pc.KM_SCALED_VARS else 1.0
            lo, hi = np.atleast_1d(lo) * scale, np.atleast_1d(hi) * scale
            mean = np.asarray(means) * scale
            phys_lo, phys_hi = defaults.physical_bounds(name)
            p.lower = np.maximum(lo, phys_lo)
            p.upper = np.minimum(np.maximum(hi, p.lower + 1e-9), phys_hi)
            p.testvalue = np.clip(mean, p.lower, p.upper)
            prior_dict[name] = p.to_dict()
            updated.append(name)
    dump_config(config, project_dir)
    logger.info("Imported %s posterior into %s priors: %s",
                from_mode, mode, ", ".join(updated) or "(nothing matched)")
    return updated


def geometry_map_point(project_dir: str) -> dict | None:
    """MAP point of the project's geometry-mode final stage (None when
    no geometry posterior exists) — the anchor of the staged
    geometry→FFI workflow (reference ``apps/beat.py:543-770``)."""
    stage_dir = os.path.join(project_dir, geometry_mode_str, "stage_-1")
    if not os.path.isdir(stage_dir):
        return None
    from beat_tpu.backend import SampleStage

    geom_cfg = load_config(project_dir, geometry_mode_str)
    problem = problem_from_config(geom_cfg, project_dir)
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    pop, llks = handler.load_trace(-1).end_points()
    return problem.ordering.to_point(pop[int(np.argmax(llks))])


def _apply_fixed_corrections(datasets, corrections, point) -> list:
    """Subtract correction displacements evaluated at ``point`` from the
    datasets (host-side, once).  Returns the dataset names corrected.

    The reference keeps hierarchical corrections FIXED at their
    geometry-run values during distributed-slip optimization — free
    ramp parameters trade off with artificial slip on deep patches
    (``docs/examples/FFI_static.rst:236``; fixed import of
    hierarchicals, ``apps/beat.py:605-663``)."""
    import jax.numpy as jnp

    from beat_tpu.heart.corrections import RampCorrection

    corrected = []
    for ds in datasets:
        total = np.zeros(ds.samples)
        for corr in corrections:
            if isinstance(corr, RampCorrection):
                if corr.dataset_name != ds.name:
                    continue
                total = total + np.asarray(
                    corr.displacement(point, jnp.asarray(ds.coords)))
            else:
                if ds.typ != "GNSS":
                    continue
                if corr.dataset_name is not None \
                        and corr.dataset_name != ds.name:
                    continue
                total = total + np.asarray(
                    corr.displacement(point, jnp.asarray(ds.los_vector)))
        if np.any(total != 0.0):
            ds.displacement = ds.displacement - total
            corrected.append(ds.name)
    return corrected


def clone_config_to_mode(project_dir: str, new_mode: str,
                         from_mode: str = geometry_mode_str,
                         datatypes: list | None = None) -> BEATconfig:
    """
    Derive a ``new_mode`` config from an existing run's config inside
    the same project — the reference's staged-workflow step
    ``beat clone <dir> <dir> --mode geometry --new_mode ffi``
    (``apps/beat.py:826``): event/data/noise/corrections configuration
    carries over, the sampled variables switch to the new mode's
    registry (ffi: slip components per patch — re-dimensioned to the
    discretized fault at load — plus the kinematic variables when
    seismic data participates).

    Writes ``config_<new_mode>.yaml`` and returns the new config.
    """
    import copy

    config = load_config(project_dir, from_mode)
    new = copy.deepcopy(config)
    pc = new.problem_config
    pc.mode = new_mode
    if datatypes:
        pc.datatypes = sorted(datatypes)
    if new_mode == ffi_mode_str:
        variables = list(static_dist_vars[:2])
        if "seismic" in pc.datatypes:
            variables.extend(partial_kinematic_vars)
        old_priors = pc.priors
        pc.priors = {}
        pc.set_default_priors(sorted(set(variables)))
        # rupture-onset timing carries over from the geometry run (the
        # reference re-bounds `time` on results import, apps/beat.py:672)
        for keep in ("time",):
            if keep in old_priors and keep in (
                    partial_kinematic_vars + hypo_vars):
                pc.priors[keep] = old_priors[keep]
    elif new_mode == bem_mode_str:
        raise ValueError("clone to bem mode: init a bem project with "
                         "`beat-tpu init --mode bem` instead (BEM source "
                         "geometry cannot be derived from other modes)")
    dump_config(new, project_dir)
    return new


def update_hypers_in_config(config: "BEATconfig", problem) -> list:
    """Fill/refresh the config's ``hyperparameters`` section with the
    problem's current hyper + hierarchical parameter names (reference
    ``beat update --parameters hypers``).  Existing entries are kept."""
    pc = config.problem_config
    added = []
    for comp in problem.composites.values():
        for p in comp.get_hyper_parameters() + comp.get_hierarchical_parameters():
            if p.name not in pc.hyperparameters:
                pc.hyperparameters[p.name] = p.to_dict()
                added.append(p.name)
    return added


def apply_hyper_overrides(problem, pc: ProblemConfig) -> None:
    """Apply the config's persisted hyper/hierarchical bounds onto the
    freshly-built problem's prior set."""
    for name, d in pc.hyperparameters.items():
        if name in problem.priors:
            p = Parameter.from_dict(d if isinstance(d, dict) else d)
            tgt = problem.priors[name]
            tgt.lower = np.asarray(p.lower, dtype=float)
            tgt.upper = np.asarray(p.upper, dtype=float)
            tgt.testvalue = np.asarray(p.testvalue, dtype=float)


def load_velocity_model(project_dir: str):
    """The project's 1-D model: ``velocity_model.npz`` (native) or
    ``velocity_model.nd`` (cake/TauP format), else the default crust
    (reference: ``get_velocity_model`` crust2x2 fallback ``heart.py``)."""
    from beat_tpu.heart.velocity_model import LayeredModel

    npz = os.path.join(project_dir, "velocity_model.npz")
    nd = os.path.join(project_dir, "velocity_model.nd")
    if os.path.exists(npz):
        return LayeredModel.load(npz)
    if os.path.exists(nd):
        return LayeredModel.from_nd(nd)
    return LayeredModel.default_crust()


def save_polarity_targets(targets, project_dir: str, datadir: str = "./") -> str:
    outdir = os.path.join(project_dir, datadir)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "polarity_data.npz")
    payload = dict(
        stations=np.array([t.station for t in targets]),
        azimuths_deg=np.rad2deg([t.azimuth_rad for t in targets]),
        takeoffs_deg=np.rad2deg([t.takeoff_rad for t in targets]),
        polarities=np.array([t.polarity for t in targets]))
    if all(t.distance_m is not None for t in targets):
        # keep distances so per-draw takeoff re-interpolation stays
        # available when the project later samples the location
        payload["distances_m"] = np.array([t.distance_m for t in targets])
    np.savez_compressed(path, **payload)
    return path


def load_geodetic_datasets(project_dir: str, gc: GeodeticConfig,
                           event: "EventConfig | None" = None) -> list:
    """
    Load geodetic datasets from ``<project_dir>/geodetic_data.npz``
    (our portable format; reference loads ``geodetic_data.pkl`` of pyrocko
    objects, ``models/geodetic.py:40``).

    npz layout per dataset <name>: ``<name>:coords``, ``<name>:displacement``,
    ``<name>:los``, optional ``<name>:odw``, ``<name>:covariance``,
    ``<name>:typ`` (0=SAR, 1=GNSS).

    When ``event`` is given, datasets carrying geographic station
    coordinates (lats/lons — GNSS imports) get their local east/north
    coords recomputed relative to the event (reference
    ``GeodeticDataset.update_local_coords``, ``heart.py:1127``, called
    per-composite in ``models/geodetic.py``); without it a dataset whose
    coords are all zero (never projected) is rejected loudly rather than
    silently placing every station at the origin.
    """
    from beat_tpu.covariance import Covariance
    from beat_tpu.heart.geodesy import GeodeticDataset

    path = os.path.join(project_dir, gc.datadir, "geodetic_data.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No geodetic data at {path} — run 'beat-tpu import'")
    datasets = []
    with np.load(path, allow_pickle=False) as z:
        names = sorted({k.split(":")[0] for k in z.files})
        for name in names:
            cov = None
            if f"{name}:covariance" in z.files:
                cov = Covariance(data=z[f"{name}:covariance"])
            typ = "GNSS" if f"{name}:typ" in z.files and int(z[f"{name}:typ"]) == 1 else "SAR"

            def opt(key, name=name, z=z):
                return z[f"{name}:{key}"] if f"{name}:{key}" in z.files else None

            time = opt("time")
            mask = opt("mask")
            datasets.append(GeodeticDataset(
                name=name, typ=typ,
                coords=z[f"{name}:coords"],
                displacement=z[f"{name}:displacement"],
                los_vector=z[f"{name}:los"],
                odw=opt("odw"),
                lats=opt("lats"), lons=opt("lons"), stations=opt("stations"),
                covariance=cov,
                time=float(time) if time is not None else None,
                mask=mask.astype(bool) if mask is not None else None))
    for ds in datasets:
        if ds.lats is not None and ds.lons is not None:
            if event is not None:
                ds.update_local_coords(event.lat, event.lon)
            elif not np.any(ds.coords):
                raise ValueError(
                    f"geodetic dataset {ds.name} has all-zero local "
                    "coordinates and no event to project its lat/lon "
                    "against — load with the project config (or re-run "
                    "'beat-tpu import') so station positions are projected "
                    "relative to the event")
    if gc.types:
        selected = [ds for ds in datasets if ds.typ in gc.types]
        dropped = [ds.name for ds in datasets if ds.typ not in gc.types]
        if dropped:
            logger.warning(
                "geodetic_config.types %s excludes datasets %s — add their "
                "type to load them", list(gc.types), dropped)
        if not selected:
            raise ValueError(
                f"geodetic_config.types {list(gc.types)} matches none of the "
                f"imported datasets ({sorted({ds.typ for ds in datasets})})")
        datasets = selected
    # dataset name selection (reference GeodeticConfig.names)
    if gc.names and gc.names != ["all"]:
        datasets = [ds for ds in datasets if ds.name in gc.names]
        if not datasets:
            raise ValueError(f"geodetic_config.names {gc.names} matches "
                             "no imported dataset")
    return datasets


def save_geodetic_datasets(datasets, project_dir: str, datadir: str = "./") -> str:
    arrays = {}
    for ds in datasets:
        arrays[f"{ds.name}:coords"] = ds.coords
        arrays[f"{ds.name}:displacement"] = ds.displacement
        arrays[f"{ds.name}:los"] = ds.los_vector
        arrays[f"{ds.name}:odw"] = ds.odw
        arrays[f"{ds.name}:covariance"] = ds.covariance.data
        arrays[f"{ds.name}:typ"] = np.array(1 if ds.typ == "GNSS" else 0)
        for key in ("lats", "lons", "stations", "mask"):
            val = getattr(ds, key, None)
            if val is not None:
                arrays[f"{ds.name}:{key}"] = np.asarray(val)
        if getattr(ds, "time", None) is not None:
            # acquisition epoch [s] after the event — drives the
            # viscoelastic (time-dependent) static GF table
            arrays[f"{ds.name}:time"] = np.float64(ds.time)
    outdir = os.path.join(project_dir, datadir)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "geodetic_data.npz")
    np.savez_compressed(path, **arrays)
    return path


def problem_from_config(config: BEATconfig, project_dir: str, build: bool = True):
    """Instantiate the Problem for a loaded config
    (reference ``load_model``: ``GeometryOptimizer`` for geometry mode,
    ``DistributionOptimizer`` for ffi)."""
    from beat_tpu.models.geodetic import GeodeticGeometryComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.sources import source_catalog

    pc = config.problem_config
    if pc.mode == ffi_mode_str:
        return _ffi_problem_from_config(config, project_dir)
    if pc.mode == bem_mode_str:
        return _bem_problem_from_config(config, project_dir)
    priors = pc.get_prior_set(to_si=True, skip_fixed=True)
    fixed = pc.get_fixed_params(to_si=True)

    sources = []
    i_src = 0
    for st, ns in zip(pc.source_types, pc.n_sources):
        for _ in range(int(ns)):
            src = source_catalog[st](depth=config.event.depth)
            # fixed parameters (lower == upper) override source templates
            for name, val in fixed.items():
                if hasattr(src, name):
                    v = np.atleast_1d(val)
                    setattr(src, name, float(v[i_src] if v.size > 1 else v[0]))
            sources.append(src)
            i_src += 1

    composites = {}
    if "geodetic" in pc.datatypes and config.geodetic_config is not None:
        gc = config.geodetic_config
        datasets = load_geodetic_datasets(project_dir, gc, event=config.event)
        corrections = _build_corrections(gc, datasets)
        # layered statics: a psgrn-analogue table in the project dir
        # switches the composite from homogeneous Okada/MT to table
        # synthesis (reference layered stores, heart.py:2426)
        from beat_tpu.heart.statictable import StaticGFTable

        static_table = None
        st_path = os.path.join(project_dir, "static_gf_table.npz")
        visco_path = os.path.join(project_dir, "static_gf_table_visco.npz")
        if os.path.exists(visco_path):
            # time-dependent (viscoelastic) table: per-dataset acquisition
            # epochs select the per-observation epoch slab — scenes from
            # different post-event times share one device program
            # (the psgrn time axis, reference config.py:325-348)
            from beat_tpu.heart.viscoelastic import (
                EpochStaticGFTable, TimeDependentStaticGFTable)

            ttable = TimeDependentStaticGFTable.load(visco_path)
            times_days = (gc.gf_config or {}).get("times_days") or {}
            for ds in datasets:
                if ds.name in times_days:
                    ds.time = float(times_days[ds.name]) * 86400.0
            if datasets:
                obs_times = np.concatenate([
                    np.full(ds.samples,
                            ds.time if ds.time is not None else 0.0)
                    for ds in datasets])
                static_table = EpochStaticGFTable.from_time_table(
                    ttable, obs_times)
                uniq = np.unique(obs_times)
                logger.info("Using viscoelastic static GF table %s at %i "
                            "acquisition epochs (%s days)", visco_path,
                            uniq.size,
                            ", ".join(f"{t / 86400.0:g}" for t in uniq))
            else:
                logger.warning("Viscoelastic table %s present but no "
                               "geodetic datasets loaded — ignoring it",
                               visco_path)
        else:
            # a viscoelastic setup without its table must fail loudly:
            # the elastic fallback would silently invert post-seismic
            # scenes with co-seismic GFs
            gf = gc.gf_config or {}
            wants_visco = bool(gf.get("rheology")) \
                or bool(gf.get("times_days")) \
                or any(getattr(ds, "time", None) for ds in datasets)
            if wants_visco:
                raise ValueError(
                    "gf_config.rheology/times_days (or dataset acquisition "
                    "times) are configured but static_gf_table_visco.npz is "
                    f"missing in {project_dir} — run `beat-tpu build_gfs` "
                    "to build the time-dependent table (the elastic table "
                    "would silently bias post-seismic scenes)")
            if os.path.exists(st_path):
                static_table = StaticGFTable.load(st_path)
                logger.info("Using layered static GF table %s", st_path)
        # earth-model uncertainty ensemble -> Covariance.pred_v
        # (reference n_variations crust ensembles, covariance.py:625)
        ensemble_tables = []
        if static_table is not None:
            ensemble_tables = [
                StaticGFTable.load(p) for p in sorted(
                    glob.glob(os.path.join(project_dir,
                                           "static_gf_table.var*.npz")))]
            if ensemble_tables:
                logger.info("Loaded %i static-table variations "
                            "(prediction covariances active)",
                            len(ensemble_tables))
        ensemble_nus = (gc.gf_config or {}).get("nu_variations")
        composites["geodetic"] = GeodeticGeometryComposite(
            datasets, sources,
            noise_structure=gc.noise_estimator.structure,
            hp_specific=gc.dataset_specific_residual_noise_estimation,
            corrections=corrections, static_table=static_table,
            finite_patches=pc.finite_patches("geodetic"),
            ensemble_nus=ensemble_nus, ensemble_tables=ensemble_tables)
    if "seismic" in pc.datatypes and config.seismic_config is not None:
        from beat_tpu.models.seismic import build_seismic_composite

        _warn_coarse_finite_grid(pc, priors, config.seismic_config)
        composites["seismic"] = build_seismic_composite(
            config.seismic_config, project_dir, sources,
            events=config.events if config.subevents else None,
            finite_patches=pc.finite_patches("seismic"),
            stf_type=pc.stf_type)
    if "polarity" in pc.datatypes and config.polarity_config is not None:
        from beat_tpu.models.polarity import PolarityComposite, PolarityMapping

        polc = config.polarity_config
        wfcs = [w for w in polc.waveforms if getattr(w, "include", True)]
        if not wfcs:
            wfcs = [PolarityFitConfig()]
        maps = []
        for i, pfc in enumerate(wfcs):
            phase = ("s" if pfc.name.lower().endswith(("sh", "sv"))
                     else "p")
            event_idx = int(getattr(pfc, "event_idx", 0))
            depth = (config.events[event_idx].depth
                     if event_idx < len(config.events)
                     else config.event.depth)
            fname = pfc.polarities_path or (
                f"polarity_data_{pfc.name}.npz"
                if os.path.exists(os.path.join(
                    project_dir, polc.datadir,
                    f"polarity_data_{pfc.name}.npz"))
                else "polarity_data.npz")
            targets = load_polarity_targets(
                project_dir, polc.datadir, source_depth=depth,
                phase=phase, filename=fname, blacklist=pfc.blacklist)
            # per-draw geometry: when the location is sampled and the
            # data carries epicentral distances, precompute a
            # (depth-grid × distance-grid) takeoff table that the
            # composite gathers at the traced location each draw — the
            # analogue of the reference's per-draw cake re-ray-tracing
            # (beat/pytensorf.py:345-362, tables heart.py:2333)
            table = None
            samples_location = any(k in priors
                                   for k in ("depth", "east_shift",
                                             "north_shift"))
            if samples_location and all(t.distance_m is not None
                                        for t in targets) and targets:
                table = _build_polarity_takeoff_table(
                    project_dir, priors, targets, depth, phase)
            maps.append(PolarityMapping(pfc.name, targets,
                                        event_idx=event_idx, mapnumber=i,
                                        takeoff_table=table))
        composites["polarity"] = PolarityComposite(sources=sources, maps=maps)

    outfolder = os.path.join(project_dir, pc.mode)
    hyper_params = (config.hyper_sampler_config.get_params()
                    if config.hyper_sampler_config is not None else None)
    problem = Problem(priors, composites, outfolder=outfolder,
                      sampler_params=config.sampler_config.get_params(),
                      hyper_sampler_params=hyper_params,
                      initialization=getattr(pc, "initialization", "random"))
    problem.event = config.event   # geographic origin for map plots
    apply_hyper_overrides(problem, pc)
    return problem


def _bem_problem_from_config(config: BEATconfig, project_dir: str):
    """
    bem-mode problem (reference ``GeometryOptimizer`` with
    ``GeodeticBEMComposite``, ``models/problems.py:669`` +
    ``models/geodetic.py:805``): engine from ``bem_config``, BEM source
    templates with fixed parameters applied, and — when every geometry
    parameter is fixed — the fully on-device linear unit-traction
    composite instead of the per-draw meshing callback.
    """
    from beat_tpu.bem import source_catalog as bem_source_catalog
    from beat_tpu.models.problem import Problem

    pc = config.problem_config
    if config.bem_config is None:
        raise ValueError("bem mode needs a bem_config section")
    engine = config.bem_config.make_engine()
    priors = pc.get_prior_set(to_si=True, skip_fixed=True)
    fixed = pc.get_fixed_params(to_si=True)

    sources = []
    i_src = 0
    for st, ns in zip(pc.source_types, pc.n_sources):
        if st not in bem_source_catalog:
            raise ValueError(
                f"bem mode needs BEM source types "
                f"({sorted(bem_source_catalog)}), got {st!r}")
        for _ in range(int(ns)):
            src = bem_source_catalog[st](depth=config.event.depth)
            for name, val in fixed.items():
                if hasattr(src, name):
                    v = np.atleast_1d(val)
                    setattr(src, name, float(v[i_src] if v.size > 1 else v[0]))
            sources.append(src)
            i_src += 1

    gc = config.geodetic_config or GeodeticConfig()
    datasets = load_geodetic_datasets(project_dir, gc, event=config.event)
    corrections = _build_corrections(gc, datasets)
    kwargs = dict(noise_structure=gc.noise_estimator.structure,
                  hp_specific=gc.dataset_specific_residual_noise_estimation,
                  corrections=corrections)

    geometry_sampled = [n for n in priors.names
                        if any(hasattr(s, n) for s in sources)]
    if geometry_sampled:
        from beat_tpu.models.bem import GeodeticBEMComposite

        logger.info("bem mode: sampling geometry %s via the BEM callback "
                    "composite", geometry_sampled)
        comp = GeodeticBEMComposite(datasets, sources, engine, **kwargs)
    else:
        from beat_tpu.models.bem import GeodeticBEMLinearComposite

        logger.info("bem mode: fixed geometry — linear unit-traction "
                    "composite (full on-device speed)")
        comp = GeodeticBEMLinearComposite(datasets, sources, engine, **kwargs)

    outfolder = os.path.join(project_dir, pc.mode)
    hyper_params = (config.hyper_sampler_config.get_params()
                    if config.hyper_sampler_config is not None else None)
    problem = Problem(priors, {"geodetic": comp}, outfolder=outfolder,
                      sampler_params=config.sampler_config.get_params(),
                      hyper_sampler_params=hyper_params)
    apply_hyper_overrides(problem, pc)
    return problem


def ffi_seismic_grid_bounds(config: BEATconfig, fault):
    """
    Duration/starttime grids of the kinematic 5-D library derived from
    the configured priors (reference ``seis_construct_gf_linear`` grid
    construction ``ffi/base.py:1122-1173``): durations span their prior;
    starttimes span [time_lower, time_upper + fault diagonal / v_min].
    """
    pc = config.problem_config
    base = pc.get_prior_set(to_si=False)

    def bounds(name, default):
        if name in base:
            return float(base[name].lower.min()), float(base[name].upper.max())
        return default

    dur_lo, dur_hi = bounds("durations", (0.5, 4.0))
    t_lo, t_hi = bounds("time", (-2.0, 2.0))
    v_lo, _ = bounds("velocities", (1.5, 4.5))  # [km/s]
    diag_km = max(np.hypot(sf.plane.length, sf.plane.width)
                  for sf in fault.subfaults) / 1e3
    st_lo = min(t_lo, 0.0)
    st_hi = t_hi + diag_km / max(v_lo, 0.1)
    dur_step = max((dur_hi - dur_lo) / 8.0, 0.25)
    st_step = max((st_hi - st_lo) / 24.0, 0.25)
    return (dur_lo, dur_hi), dur_step, (st_lo, st_hi), st_step


def _ffi_problem_from_config(config: BEATconfig, project_dir: str):
    """
    FFI-mode problem: loads the fault geometry + linear GF libraries
    written by ``beat-tpu build_gfs`` and assembles the distributed-slip
    composites (reference ``DistributionOptimizer``
    ``models/problems.py:710``).  Slip priors are re-dimensioned to the
    discretized patch count, as the reference does at load time.
    """
    import pickle

    from beat_tpu.ffi import GeodeticGFLibrary
    from beat_tpu.models.distributer import GeodeticDistributerComposite
    from beat_tpu.models.laplacian import LaplacianDistributerComposite
    from beat_tpu.models.problem import Problem
    from beat_tpu.parameter import Parameter, PriorSet

    gfdir = os.path.join(project_dir, "ffi", "linear_gfs")
    fault_path = os.path.join(gfdir, "fault_geometry.pkl")
    if not os.path.exists(fault_path):
        raise FileNotFoundError(
            f"No FFI fault geometry in {gfdir} — run 'beat-tpu build_gfs'")
    with open(fault_path, "rb") as f:
        fault = pickle.load(f)

    pc = config.problem_config
    base = pc.get_prior_set(to_si=False)
    composites = {}
    slip_components: list = []

    lib_path = os.path.join(gfdir, "geodetic_gfs.npz")
    if "geodetic" in pc.datatypes:
        if not os.path.exists(lib_path):
            raise FileNotFoundError(
                f"No geodetic GF library in {gfdir} — run 'beat-tpu build_gfs'")
        gc = config.geodetic_config
        datasets = load_geodetic_datasets(project_dir, gc,
                                          event=config.event)
        corrections = _build_corrections(gc, datasets)
        if corrections:
            # fixed at the geometry MAP (reference FFI semantics: free
            # ramps feed artificial deep slip, FFI_static.rst:236)
            map_point = geometry_map_point(project_dir)
            names = [n for c in corrections for n in c.parameter_names]
            if map_point is not None and all(n in map_point
                                             for n in names):
                fixed = _apply_fixed_corrections(datasets, corrections,
                                                 map_point)
                logger.info(
                    "ffi: corrections (%s) fixed at the geometry-MAP "
                    "values and removed from %s",
                    ", ".join(sorted(set(names))), ", ".join(fixed))
            else:
                logger.warning(
                    "ffi: corrections are configured but no geometry-"
                    "mode posterior exists in %s — the slip inversion "
                    "sees UNCORRECTED data (ramps trade off with deep "
                    "slip); run `beat-tpu sample --mode geometry` first "
                    "(reference staged workflow)", project_dir)
        lib = GeodeticGFLibrary.load(lib_path)
        slip_components = list(lib.component_names)
        composites["geodetic"] = GeodeticDistributerComposite(
            datasets, lib, fault,
            hp_specific=gc.dataset_specific_residual_noise_estimation)

    if "seismic" in pc.datatypes and config.seismic_config is not None:
        from beat_tpu.ffi import SeismicGFLibrary
        from beat_tpu.models.distributer import SeismicDistributerComposite
        from beat_tpu.models.seismic import build_seismic_composite

        geom_comp = build_seismic_composite(config.seismic_config,
                                            project_dir, [])
        wavemaps_libs = []
        components = []
        for wmap in geom_comp.wavemaps:
            libs = {}
            for comp_name in static_dist_vars[:2]:
                path = os.path.join(gfdir,
                                    f"seismic_{comp_name}_{wmap.mapid}.npz")
                if os.path.exists(path):
                    libs[comp_name] = SeismicGFLibrary.load(
                        gfdir, f"seismic_{comp_name}_{wmap.mapid}",
                        component=comp_name)
            if not libs:
                raise FileNotFoundError(
                    f"No seismic GF libraries for wavemap {wmap.mapid} in "
                    f"{gfdir} — run 'beat-tpu build_gfs --datatypes seismic'")
            components = sorted(libs)
            wavemaps_libs.append((wmap, libs))
        slip_components = sorted(set(slip_components) | set(components))
        composites["seismic"] = SeismicDistributerComposite(
            wavemaps_libs, fault, slip_varnames=tuple(components),
            interpolation=config.seismic_config.waveforms[0].interpolation
            if config.seismic_config.waveforms else "multilinear",
            hp_specific=getattr(
                config.seismic_config,
                "dataset_specific_residual_noise_estimation", False))

    composites["laplacian"] = LaplacianDistributerComposite(
        fault, slip_varnames=tuple(slip_components))

    # priors re-dimensioned to the discretization (slip per patch;
    # kinematics per patch / per subfault)
    priors = PriorSet()

    def add_sized(name, size):
        if name in base:
            lo, hi = float(base[name].lower.min()), float(base[name].upper.max())
            test = float(base[name].testvalue.mean())
        else:
            from beat_tpu import defaults

            lo, hi = defaults.default_bounds(name)
            test = (lo + hi) / 2.0
        scale = 1e3 if name in ProblemConfig.KM_SCALED_VARS else 1.0
        priors.add(Parameter(name, np.full(size, lo * scale),
                             np.full(size, hi * scale),
                             testvalue=np.full(size, test * scale)))

    for comp_name in slip_components:
        add_sized(comp_name, fault.npatches)
    if "seismic" in composites:
        add_sized("durations", fault.npatches)
        add_sized("velocities", fault.npatches)
        for name in ("nucleation_strike", "nucleation_dip", "time"):
            add_sized(name, fault.nsubfaults)

    outfolder = os.path.join(project_dir, pc.mode)
    hyper_params = (config.hyper_sampler_config.get_params()
                    if config.hyper_sampler_config is not None else None)
    problem = Problem(priors, composites, outfolder=outfolder,
                      sampler_params=config.sampler_config.get_params(),
                      hyper_sampler_params=hyper_params,
                      initialization=getattr(pc, "initialization", "random"))
    problem.event = config.event   # geographic origin for map plots
    apply_hyper_overrides(problem, pc)
    return problem


def _build_corrections(gc: GeodeticConfig, datasets):
    from beat_tpu.heart.corrections import EulerPoleCorrection, RampCorrection, StrainRateCorrection

    corrections = []
    cc = gc.corrections
    if cc.ramps is not None and cc.ramps.enabled:
        names = cc.ramps.dataset_names or [ds.name for ds in datasets if ds.typ == "SAR"]
        corrections.extend(RampCorrection(dataset_name=n) for n in names)
    from beat_tpu.heart.corrections import station_mask

    # one instance per (config entry, dataset): instances of the same
    # entry share hierarchicals; each applies to its own dataset's
    # observations modulo the entry's white/blacklist and the dataset's
    # polygon mask (reference ``models/corrections.py:111-140`` +
    # ``DiffIFG.get_data_mask`` ``heart.py:1520``: points inside a kite
    # polygon — the deforming region — receive no plate-motion
    # correction, so its parameters are constrained by the far field)
    def eligible(entry):
        names = list(getattr(entry, "dataset_names", []) or [])
        if names:
            return [ds for ds in datasets if ds.name in names]
        return [ds for ds in datasets if ds.typ == "GNSS"]

    def masked(ds, entry, kind, i):
        mask = None
        if entry.station_whitelist or entry.station_blacklist:
            if ds.stations is None:
                logger.warning(
                    "%s correction %i has station white/blacklists but "
                    "dataset %s carries no station names — the lists are "
                    "ignored and the correction applies to every "
                    "observation", kind, i, ds.name)
            else:
                mask = station_mask(ds.stations, entry.station_whitelist,
                                    entry.station_blacklist)
        if getattr(ds, "mask", None) is not None and np.any(ds.mask):
            keep = ~np.asarray(ds.mask, dtype=bool)
            mask = keep if mask is None else (mask & keep)
        return mask

    for i, ep in enumerate(cc.euler_poles):
        if not getattr(ep, "enabled", True):
            continue
        for ds in eligible(ep):
            if ds.lats is None:
                continue
            mask = masked(ds, ep, "Euler-pole", i)
            corrections.append(EulerPoleCorrection(
                number=i, lats=ds.lats, lons=ds.lons,
                dataset_name=ds.name, mask=mask))
    for i, sr in enumerate(cc.strain_rates):
        if not getattr(sr, "enabled", True):
            continue
        for ds in eligible(sr):
            centroid = ds.coords.mean(axis=0)
            mask = masked(ds, sr, "strain-rate", i)
            corrections.append(StrainRateCorrection(
                number=i, norths=ds.coords[:, 1] - centroid[1],
                easts=ds.coords[:, 0] - centroid[0],
                dataset_name=ds.name, mask=mask))
    return corrections
