"""Typed simulation parameters, parsed from .prm decks.

TPU-native equivalent of the reference's ``Parameters::*`` structs in
``source/core/parameters.cc`` and the aggregate
``NavierStokesSolverParameters`` (SURVEY.md §2.1, §2.2).  Section and key
names follow the reference's deck schema verbatim so reference decks run
unmodified; each dataclass provides ``parse(deck)`` (the analogue of
``parse_parameters``) and carries the reference defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum

from .prm import ParameterDeck, parse_prm_file
from .expressions import VectorExpression


# --------------------------------------------------------------------------
# enums
# --------------------------------------------------------------------------

class TimeSteppingMethod(str, Enum):
    steady = "steady"
    bdf1 = "bdf1"
    bdf2 = "bdf2"
    bdf3 = "bdf3"
    sdirk2 = "sdirk2"
    sdirk3 = "sdirk3"

    @property
    def is_steady(self) -> bool:
        return self is TimeSteppingMethod.steady

    @property
    def bdf_order(self) -> int:
        return {"bdf1": 1, "bdf2": 2, "bdf3": 3}.get(self.value, 0)

    @property
    def is_sdirk(self) -> bool:
        return self.value.startswith("sdirk")


class Verbosity(str, Enum):
    quiet = "quiet"
    verbose = "verbose"


# --------------------------------------------------------------------------
# parameter blocks (one dataclass per reference Parameters:: struct)
# --------------------------------------------------------------------------

@dataclass
class SimulationControlParams:
    """subsection 'simulation control'."""
    method: TimeSteppingMethod = TimeSteppingMethod.steady
    dt: float = 1.0
    time_end: float = 1.0
    adapt: bool = False                   # CFL-driven dt adaptation
    max_cfl: float = 1.0
    adaptative_time_step_scaling: float = 1.1
    startup_timestep_scaling: float = 0.4  # BDF startup sub-step scaling
    number_mesh_adaptation: int = 0        # steady AMR cycles
    output_name: str = "out"
    output_path: str = "./"
    output_frequency: int = 1
    subdivision: int = 1
    group_files: int = 1
    log_precision: int = 6

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("simulation control")
        self.method = TimeSteppingMethod(d.get_str("method", self.method.value))
        self.dt = d.get_double("time step", self.dt)
        self.time_end = d.get_double("time end", self.time_end)
        self.adapt = d.get_bool("adapt", self.adapt)
        self.max_cfl = d.get_double("max cfl", self.max_cfl)
        self.adaptative_time_step_scaling = d.get_double(
            "adaptative time step scaling", self.adaptative_time_step_scaling)
        self.startup_timestep_scaling = d.get_double(
            "startup time scaling", self.startup_timestep_scaling)
        self.number_mesh_adaptation = d.get_int(
            "number mesh adapt", self.number_mesh_adaptation)
        self.output_name = d.get_str("output name", self.output_name)
        self.output_path = d.get_str("output path", self.output_path)
        self.output_frequency = d.get_int("output frequency", self.output_frequency)
        self.subdivision = d.get_int("subdivision", self.subdivision)
        self.group_files = d.get_int("group files", self.group_files)
        self.log_precision = d.get_int("log precision", self.log_precision)


@dataclass
class PhysicalPropertiesParams:
    """subsection 'physical properties'."""
    kinematic_viscosity: float = 1.0

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("physical properties")
        self.kinematic_viscosity = d.get_double(
            "kinematic viscosity", self.kinematic_viscosity)


@dataclass
class FEMParams:
    """subsection 'FEM'."""
    velocity_order: int = 1
    pressure_order: int = 1
    quadrature_points: int = 0   # 0 -> velocity_order + 1
    qmapping_all: bool = False   # curved mapping on all cells (vs boundary)
    # operator implementation: auto = fused Pallas kernel on TPU, XLA
    # elsewhere; 'pallas' / 'xla' force it
    kernel: str = "auto"

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("FEM")
        self.velocity_order = d.get_int("velocity order", self.velocity_order)
        self.pressure_order = d.get_int("pressure order", self.pressure_order)
        self.quadrature_points = d.get_int("quadrature points", self.quadrature_points)
        self.qmapping_all = d.get_bool("qmapping all", self.qmapping_all)
        self.kernel = d.get_str("kernel", self.kernel)

    @property
    def n_quadrature_points_1d(self) -> int:
        return self.quadrature_points if self.quadrature_points > 0 \
            else self.velocity_order + 1


@dataclass
class MeshParams:
    """subsection 'mesh'."""
    type: str = "dealii"          # 'dealii' (generator) or 'gmsh'
    file_name: str = ""
    grid_type: str = "hyper_cube"
    grid_arguments: str = "0 : 1 : false"
    initial_refinement: int = 0

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("mesh")
        self.type = d.get_str("type", self.type)
        self.file_name = d.get_str("file name", self.file_name)
        self.grid_type = d.get_str("grid type", self.grid_type)
        self.grid_arguments = d.get_str("grid arguments", self.grid_arguments)
        self.initial_refinement = d.get_int("initial refinement", self.initial_refinement)


@dataclass
class MeshAdaptationParams:
    """subsection 'mesh adaptation'."""
    type: str = "none"            # none | uniform | kelly
    variable: str = "velocity"    # velocity | pressure
    fraction_type: str = "number"  # number | fraction
    max_number_elements: int = 100000000
    max_refinement_level: int = 10
    min_refinement_level: int = 0
    frequency: int = 1
    fraction_refinement: float = 0.1
    fraction_coarsening: float = 0.05

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("mesh adaptation")
        self.type = d.get_str("type", self.type)
        self.variable = d.get_str("variable", self.variable)
        self.fraction_type = d.get_str("fraction type", self.fraction_type)
        self.max_number_elements = d.get_int("max number elements", self.max_number_elements)
        self.max_refinement_level = d.get_int("max refinement level", self.max_refinement_level)
        self.min_refinement_level = d.get_int("min refinement level", self.min_refinement_level)
        self.frequency = d.get_int("frequency", self.frequency)
        self.fraction_refinement = d.get_double("fraction refinement", self.fraction_refinement)
        self.fraction_coarsening = d.get_double("fraction coarsening", self.fraction_coarsening)


@dataclass
class NonLinearSolverParams:
    """subsection 'non-linear solver'."""
    verbosity: Verbosity = Verbosity.verbose
    solver: str = "newton"       # newton | skip_newton | pseudo_transient
    tolerance: float = 1e-6
    max_iterations: int = 10
    skip_iterations: int = 1
    max_line_search_halvings: int = 4
    # pseudo-transient continuation (steady decks): one backward-Euler
    # Newton iteration per pseudo-step, dt grown by SER
    # (dt_{k+1} = dt_k * ||R_{k-1}|| / ||R_k||).  Globalizes steady
    # solves that stall plain Newton (strongly convective cases — the
    # config-#5 sphere, scripts/diag_sphere_gmg.py) and keeps every
    # linear system mass-dominated, where the TPU preconditioners are
    # measured strongest.
    ptc_initial_dt: float = 0.1
    ptc_max_steps: int = 200
    ptc_growth: float = 2.0      # max SER growth per step
    ptc_max_dt: float = 1e8

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("non-linear solver")
        self.verbosity = Verbosity(d.get_str("verbosity", self.verbosity.value))
        self.solver = d.get_str("solver", self.solver)
        self.tolerance = d.get_double("tolerance", self.tolerance)
        self.max_iterations = d.get_int("max iterations", self.max_iterations)
        self.skip_iterations = d.get_int("skip iterations", self.skip_iterations)
        self.ptc_initial_dt = d.get_double("ptc initial time step",
                                           self.ptc_initial_dt)
        self.ptc_max_steps = d.get_int("ptc max steps", self.ptc_max_steps)
        self.ptc_growth = d.get_double("ptc time step growth",
                                       self.ptc_growth)
        self.ptc_max_dt = d.get_double("ptc max time step", self.ptc_max_dt)


@dataclass
class LinearSolverParams:
    """subsection 'linear solver'."""
    verbosity: Verbosity = Verbosity.verbose
    method: str = "gmres"        # gmres | bicgstab | amg
    max_iters: int = 1000
    relative_residual: float = 1e-3
    minimum_residual: float = 1e-8
    max_krylov_vectors: int = 100
    # ILU-era knobs (kept for deck compatibility; map onto the TPU
    # preconditioners: fill<=0 -> node-block Jacobi, fill>=1 -> element
    # additive-Schwarz blocks)
    ilu_fill: float = 0.0
    ilu_atol: float = 1e-8
    ilu_rtol: float = 1.0
    amg_aggregation_threshold: float = 1e-14
    amg_n_cycles: int = 1
    amg_w_cycles: bool = False
    amg_smoother_sweeps: int = 2
    amg_smoother_overlap: int = 1
    preconditioner: str = "auto"  # auto | jacobi | block_jacobi | additive_schwarz
    # GMG smoother (TPU replacement of the reference's ML-AMG smoother
    # slot): 'auto' = krylov on steady decks (damped Jacobi diverges on
    # steady convection-dominated levels — scripts/diag_sphere_gmg.py),
    # jacobi on transient (mass-dominated levels smooth fine and it is
    # ~krylov_m x cheaper per V-cycle)
    mg_smoother: str = "auto"     # auto | jacobi | krylov
    mg_krylov_vectors: int = 4
    # GMG cycle shape: 'v'; 'w' (the reference's `amg w cycles` ML
    # knob); 'k' = Notay K-cycle — the coarse correction is wrapped in
    # a 2-iteration FGMRES on the coarse system, which cannot amplify
    # the smooth convective modes a rediscretized coarse operator
    # over-corrects on steady convection-dominated decks
    mg_cycle: str = "v"           # v | w | k
    # Storage dtype for the frozen Jacobian linearization-state arrays
    # streamed by the matrix-free J.v tangent kernel (f32 | bf16).
    # bf16 halves the matvec's dominant HBM stream on TPU; compute
    # stays f32 (inexact-Newton with rounded coefficients; the
    # line-search residual is exact).  TPU-native knob, no reference
    # counterpart.
    jacobian_state_precision: str = "f32"

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("linear solver")
        self.verbosity = Verbosity(d.get_str("verbosity", self.verbosity.value))
        self.method = d.get_str("method", self.method)
        self.max_iters = d.get_int("max iters", self.max_iters)
        self.relative_residual = d.get_double("relative residual", self.relative_residual)
        self.minimum_residual = d.get_double("minimum residual", self.minimum_residual)
        self.max_krylov_vectors = d.get_int("max krylov vectors", self.max_krylov_vectors)
        self.ilu_fill = d.get_double("ilu preconditioner fill", self.ilu_fill)
        self.ilu_atol = d.get_double("ilu preconditioner absolute tolerance", self.ilu_atol)
        self.ilu_rtol = d.get_double("ilu preconditioner relative tolerance", self.ilu_rtol)
        self.amg_aggregation_threshold = d.get_double(
            "amg aggregation threshold", self.amg_aggregation_threshold)
        self.amg_n_cycles = d.get_int("amg n cycles", self.amg_n_cycles)
        self.amg_w_cycles = d.get_bool("amg w cycles", self.amg_w_cycles)
        self.amg_smoother_sweeps = d.get_int("amg smoother sweeps", self.amg_smoother_sweeps)
        self.amg_smoother_overlap = d.get_int("amg smoother overlap", self.amg_smoother_overlap)
        self.preconditioner = d.get_str("preconditioner", self.preconditioner)
        self.mg_smoother = d.get_str("mg smoother", self.mg_smoother)
        self.mg_krylov_vectors = d.get_int("mg krylov vectors",
                                           self.mg_krylov_vectors)
        self.mg_cycle = d.get_str("mg cycle", self.mg_cycle)
        self.jacobian_state_precision = d.get_str(
            "jacobian state precision", self.jacobian_state_precision)

    def resolved_mg_smoother(self, steady: bool,
                             degree: int = 1) -> str:
        if self.mg_smoother != "auto":
            return self.mg_smoother
        # krylov smoothing where damped node-block Jacobi is measured
        # weak: steady convective systems, and HIGH-ORDER spaces — on
        # the Q2 transient cylinder the p-MG V-cycle converges FGMRES
        # in 6 iterations with a GMRES(4) smooth vs 122 with Jacobi
        # (scripts/diag_sphere_gmg.py CASE=cylinder ORDER=2 DT=0.01)
        return "krylov" if (steady or degree > 1) else "jacobi"

    def resolved_mg_cycle(self) -> str:
        # reference parity: `amg w cycles = true` selects the W-shape
        # unless `mg cycle` was set explicitly
        if self.mg_cycle == "v" and self.amg_w_cycles:
            return "w"
        return self.mg_cycle

    def resolved_preconditioner(self) -> str:
        if self.preconditioner != "auto":
            return self.preconditioner
        # geometric multigrid when a nested hierarchy exists (the solver
        # falls back to block-Jacobi otherwise) — the ILU/AMG slot
        return "gmg"


class BoundaryType(str, Enum):
    noslip = "noslip"
    slip = "slip"
    function = "function"
    periodic = "periodic"
    outlet = "outlet"   # natural/do-nothing


@dataclass
class BoundaryCondition:
    id: int = 0
    type: BoundaryType = BoundaryType.noslip
    u: str = "0"
    v: str = "0"
    w: str = "0"
    periodic_id: int = 0
    periodic_direction: int = 0
    # per-boundary center of rotation for torque integrals
    # (reference: calculate_torques() about per-boundary center, §2.2)
    cor_x: float = 0.0
    cor_y: float = 0.0
    cor_z: float = 0.0

    def center_of_rotation(self, dim: int):
        return [self.cor_x, self.cor_y, self.cor_z][:dim]


@dataclass
class BoundaryConditionsParams:
    """subsection 'boundary conditions' with nested 'bc i' blocks."""
    bcs: list[BoundaryCondition] = field(default_factory=list)

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("boundary conditions")
        n = d.get_int("number", 0)
        self.bcs = []
        for i in range(n):
            sub = d.sub(f"bc {i}")
            bc = BoundaryCondition()
            bc.id = sub.get_int("id", i)
            bc.type = BoundaryType(sub.get_str("type", "noslip"))
            for comp in ("u", "v", "w"):
                fsub = sub.sub(comp)
                expr = fsub.get_str("Function expression", "0")
                setattr(bc, comp, expr)
            bc.periodic_id = sub.get_int("periodic_id", 0)
            bc.periodic_direction = sub.get_int("periodic_direction", 0)
            bc.cor_x = sub.get_double("cor x", 0.0)
            bc.cor_y = sub.get_double("cor y", 0.0)
            bc.cor_z = sub.get_double("cor z", 0.0)
            self.bcs.append(bc)


@dataclass
class InitialConditionsParams:
    """subsection 'initial conditions'."""
    type: str = "nodal"        # none | nodal | L2projection | viscous
    viscosity: float = 1.0     # for the 'viscous' pre-solve
    uvwp: str = "0; 0; 0; 0"

    def parse(self, deck: ParameterDeck, dim: int) -> None:
        d = deck.sub("initial conditions")
        self.type = d.get_str("type", self.type)
        self.viscosity = d.get_double("viscosity", self.viscosity)
        sub = d.sub("uvwp")
        default = "; ".join(["0"] * (dim + 1))
        self.uvwp = sub.get_str("Function expression", default)


@dataclass
class SourceTermParams:
    """subsection 'source term'."""
    enable: bool = False
    xyz: str = "0; 0; 0; 0"

    def parse(self, deck: ParameterDeck, dim: int) -> None:
        d = deck.sub("source term")
        self.enable = d.get_bool("enable", self.enable)
        sub = d.sub("xyz")
        default = "; ".join(["0"] * (dim + 1))
        self.xyz = sub.get_str("Function expression", default)


@dataclass
class AnalyticalSolutionParams:
    """subsection 'analytical solution'."""
    enable: bool = False
    verbosity: Verbosity = Verbosity.verbose
    filename: str = "L2Error"
    uvwp: str = "0; 0; 0; 0"

    def parse(self, deck: ParameterDeck, dim: int) -> None:
        d = deck.sub("analytical solution")
        self.enable = d.get_bool("enable", self.enable)
        self.verbosity = Verbosity(d.get_str("verbosity", self.verbosity.value))
        self.filename = d.get_str("filename", self.filename)
        sub = d.sub("uvwp")
        default = "; ".join(["0"] * (dim + 1))
        self.uvwp = sub.get_str("Function expression", default)


@dataclass
class ForcesParams:
    """subsection 'forces'."""
    verbosity: Verbosity = Verbosity.quiet
    calculate_forces: bool = False
    calculate_torques: bool = False
    force_output_name: str = "force"
    torque_output_name: str = "torque"
    output_precision: int = 10
    calculation_frequency: int = 1
    output_frequency: int = 1

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("forces")
        self.verbosity = Verbosity(d.get_str("verbosity", self.verbosity.value))
        self.calculate_forces = d.get_bool("calculate forces", self.calculate_forces)
        self.calculate_torques = d.get_bool("calculate torques", self.calculate_torques)
        self.force_output_name = d.get_str("force name", self.force_output_name)
        self.torque_output_name = d.get_str("torque name", self.torque_output_name)
        self.output_precision = d.get_int("output precision", self.output_precision)
        self.calculation_frequency = d.get_int(
            "calculation frequency", self.calculation_frequency)
        self.output_frequency = d.get_int("output frequency", self.output_frequency)


@dataclass
class PostProcessingParams:
    """subsection 'post-processing'."""
    verbosity: Verbosity = Verbosity.quiet
    calculate_kinetic_energy: bool = False
    calculate_enstrophy: bool = False
    kinetic_energy_name: str = "kinetic_energy"
    enstrophy_name: str = "enstrophy"
    calculation_frequency: int = 1
    output_frequency: int = 1

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("post-processing")
        self.verbosity = Verbosity(d.get_str("verbosity", self.verbosity.value))
        self.calculate_kinetic_energy = d.get_bool(
            "calculate kinetic energy", self.calculate_kinetic_energy)
        self.calculate_enstrophy = d.get_bool(
            "calculate enstrophy", self.calculate_enstrophy)
        self.kinetic_energy_name = d.get_str(
            "kinetic energy name", self.kinetic_energy_name)
        self.enstrophy_name = d.get_str("enstrophy name", self.enstrophy_name)
        self.calculation_frequency = d.get_int(
            "calculation frequency", self.calculation_frequency)
        self.output_frequency = d.get_int("output frequency", self.output_frequency)


@dataclass
class RestartParams:
    """subsection 'restart'."""
    checkpoint: bool = False
    restart: bool = False
    filename: str = "restart"
    frequency: int = 1

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("restart")
        self.checkpoint = d.get_bool("checkpoint", self.checkpoint)
        self.restart = d.get_bool("restart", self.restart)
        self.filename = d.get_str("filename", self.filename)
        self.frequency = d.get_int("frequency", self.frequency)


@dataclass
class TimerParams:
    """subsection 'timer'."""
    type: str = "none"   # none | iteration | end

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("timer")
        self.type = d.get_str("type", self.type)


@dataclass
class ManifoldDef:
    id: int = 0
    type: str = "spherical"
    arg: str = ""        # center coordinates "cx, cy[, cz]"


@dataclass
class ManifoldsParams:
    """subsection 'manifolds'."""
    manifolds: list[ManifoldDef] = field(default_factory=list)

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("manifolds")
        n = d.get_int("number", 0)
        self.manifolds = []
        for i in range(n):
            sub = d.sub(f"manifold {i}")
            m = ManifoldDef()
            m.id = sub.get_int("id", i)
            m.type = sub.get_str("type", "spherical")
            m.arg = sub.get_str("arg", "")
            self.manifolds.append(m)


@dataclass
class TestParams:
    """subsection 'test' — trims output for golden-file comparison."""
    enable: bool = False

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("test")
        self.enable = d.get_bool("enable", self.enable)


@dataclass
class StabilizationParams:
    """subsection 'stabilization' (extension; reference hardwires GLS).

    Controls which stabilization terms enter the GLS weak form; defaults
    reproduce the reference's assembleGLS behavior (SUPG+PSPG+viscous
    adjoint, no LSIC).
    """
    supg: bool = True
    pspg: bool = True
    gls_viscous_adjoint: bool = True
    lsic: bool = False
    frozen_tau_jacobian: bool = False  # full-Newton by default (jvp-exact)
    gamma: float = 1.0                 # grad-div coefficient (GD solver)

    def parse(self, deck: ParameterDeck) -> None:
        d = deck.sub("stabilization")
        self.supg = d.get_bool("supg", self.supg)
        self.pspg = d.get_bool("pspg", self.pspg)
        self.gls_viscous_adjoint = d.get_bool("gls viscous adjoint",
                                              self.gls_viscous_adjoint)
        self.lsic = d.get_bool("lsic", self.lsic)
        self.gamma = d.get_double("gamma", self.gamma)


# --------------------------------------------------------------------------
# aggregate (the reference's NavierStokesSolverParameters<dim>)
# --------------------------------------------------------------------------

@dataclass
class SimulationParameters:
    """All parameter blocks for one run (NavierStokesSolverParameters)."""
    dim: int = 2
    simulation_control: SimulationControlParams = field(default_factory=SimulationControlParams)
    physical_properties: PhysicalPropertiesParams = field(default_factory=PhysicalPropertiesParams)
    fem: FEMParams = field(default_factory=FEMParams)
    mesh: MeshParams = field(default_factory=MeshParams)
    mesh_adaptation: MeshAdaptationParams = field(default_factory=MeshAdaptationParams)
    nonlinear_solver: NonLinearSolverParams = field(default_factory=NonLinearSolverParams)
    linear_solver: LinearSolverParams = field(default_factory=LinearSolverParams)
    boundary_conditions: BoundaryConditionsParams = field(default_factory=BoundaryConditionsParams)
    initial_conditions: InitialConditionsParams = field(default_factory=InitialConditionsParams)
    source_term: SourceTermParams = field(default_factory=SourceTermParams)
    analytical_solution: AnalyticalSolutionParams = field(default_factory=AnalyticalSolutionParams)
    forces: ForcesParams = field(default_factory=ForcesParams)
    post_processing: PostProcessingParams = field(default_factory=PostProcessingParams)
    restart: RestartParams = field(default_factory=RestartParams)
    timer: TimerParams = field(default_factory=TimerParams)
    manifolds: ManifoldsParams = field(default_factory=ManifoldsParams)
    test: TestParams = field(default_factory=TestParams)
    stabilization: StabilizationParams = field(default_factory=StabilizationParams)

    def parse(self, deck: ParameterDeck) -> "SimulationParameters":
        self.simulation_control.parse(deck)
        self.physical_properties.parse(deck)
        self.fem.parse(deck)
        self.mesh.parse(deck)
        self.mesh_adaptation.parse(deck)
        self.nonlinear_solver.parse(deck)
        self.linear_solver.parse(deck)
        self.boundary_conditions.parse(deck)
        self.initial_conditions.parse(deck, self.dim)
        self.source_term.parse(deck, self.dim)
        self.analytical_solution.parse(deck, self.dim)
        self.forces.parse(deck)
        self.post_processing.parse(deck)
        self.restart.parse(deck)
        self.timer.parse(deck)
        self.manifolds.parse(deck)
        self.test.parse(deck)
        self.stabilization.parse(deck)
        return self

    @classmethod
    def from_file(cls, path: str, dim: int) -> "SimulationParameters":
        p = cls(dim=dim)
        return p.parse(parse_prm_file(path))

    @classmethod
    def from_text(cls, text: str, dim: int) -> "SimulationParameters":
        from .prm import parse_prm
        p = cls(dim=dim)
        return p.parse(parse_prm(text))


def declare_template(dim: int = 2) -> str:
    """Render a fully-populated default deck (the reference's
    navier_stokes_parameter_template application — SURVEY.md §2.3)."""
    p = SimulationParameters(dim=dim)
    fn_default = "; ".join(["0"] * (dim + 1))
    sc, pp = p.simulation_control, p.physical_properties
    lines = f"""# Parameter deck template — softx_2020_200_tpu (all defaults)
subsection simulation control
  set method                       = {sc.method.value}  # steady|bdf1|bdf2|bdf3
  set time step                    = {sc.dt}
  set time end                     = {sc.time_end}
  set adapt                        = {str(sc.adapt).lower()}
  set max cfl                      = {sc.max_cfl}
  set adaptative time step scaling = {sc.adaptative_time_step_scaling}
  set number mesh adapt            = {sc.number_mesh_adaptation}
  set output name                  = {sc.output_name}
  set output path                  = {sc.output_path}
  set output frequency             = {sc.output_frequency}
  set subdivision                  = {sc.subdivision}
  set log precision                = {sc.log_precision}
end
subsection physical properties
  set kinematic viscosity = {pp.kinematic_viscosity}
end
subsection FEM
  set velocity order    = {p.fem.velocity_order}
  set pressure order    = {p.fem.pressure_order}
  set quadrature points = {p.fem.quadrature_points}  # 0 = order+1
  set qmapping all      = {str(p.fem.qmapping_all).lower()}
end
subsection mesh
  set type               = {p.mesh.type}  # dealii | gmsh
  set file name          = {p.mesh.file_name}
  set grid type          = {p.mesh.grid_type}
  set grid arguments     = {p.mesh.grid_arguments}
  set initial refinement = {p.mesh.initial_refinement}
end
subsection mesh adaptation
  set type                 = {p.mesh_adaptation.type}  # none|uniform|kelly
  set variable             = {p.mesh_adaptation.variable}
  set fraction type        = {p.mesh_adaptation.fraction_type}
  set max number elements  = {p.mesh_adaptation.max_number_elements}
  set max refinement level = {p.mesh_adaptation.max_refinement_level}
  set min refinement level = {p.mesh_adaptation.min_refinement_level}
  set frequency            = {p.mesh_adaptation.frequency}
  set fraction refinement  = {p.mesh_adaptation.fraction_refinement}
  set fraction coarsening  = {p.mesh_adaptation.fraction_coarsening}
end
subsection boundary conditions
  set number = 0
  # subsection bc 0
  #   set id   = 0
  #   set type = noslip  # noslip|slip|function|periodic|outlet
  #   subsection u
  #     set Function expression = 0
  #   end
  # end
end
subsection initial conditions
  set type      = {p.initial_conditions.type}  # none|nodal|L2projection|viscous
  set viscosity = {p.initial_conditions.viscosity}
  subsection uvwp
    set Function expression = {fn_default}
  end
end
subsection source term
  set enable = {str(p.source_term.enable).lower()}
  subsection xyz
    set Function expression = {fn_default}  # or 'mms' to derive by autodiff
  end
end
subsection analytical solution
  set enable    = {str(p.analytical_solution.enable).lower()}
  set verbosity = {p.analytical_solution.verbosity.value}
  set filename  = {p.analytical_solution.filename}
  subsection uvwp
    set Function expression = {fn_default}
  end
end
subsection forces
  set verbosity             = {p.forces.verbosity.value}
  set calculate forces      = {str(p.forces.calculate_forces).lower()}
  set calculate torques     = {str(p.forces.calculate_torques).lower()}
  set force name            = {p.forces.force_output_name}
  set torque name           = {p.forces.torque_output_name}
  set output precision      = {p.forces.output_precision}
  set calculation frequency = {p.forces.calculation_frequency}
  set output frequency      = {p.forces.output_frequency}
end
subsection post-processing
  set verbosity               = {p.post_processing.verbosity.value}
  set calculate kinetic energy = {str(p.post_processing.calculate_kinetic_energy).lower()}
  set calculate enstrophy      = {str(p.post_processing.calculate_enstrophy).lower()}
end
subsection non-linear solver
  set verbosity       = {p.nonlinear_solver.verbosity.value}
  set solver          = {p.nonlinear_solver.solver}
  set tolerance       = {p.nonlinear_solver.tolerance}
  set max iterations  = {p.nonlinear_solver.max_iterations}
  set skip iterations = {p.nonlinear_solver.skip_iterations}
end
subsection linear solver
  set verbosity          = {p.linear_solver.verbosity.value}
  set method             = {p.linear_solver.method}
  set max iters          = {p.linear_solver.max_iters}
  set relative residual  = {p.linear_solver.relative_residual}
  set minimum residual   = {p.linear_solver.minimum_residual}
  set max krylov vectors = {p.linear_solver.max_krylov_vectors}
  set ilu preconditioner fill = {p.linear_solver.ilu_fill}
  set preconditioner     = {p.linear_solver.preconditioner}  # auto|jacobi|block_jacobi|additive_schwarz
end
subsection restart
  set checkpoint = {str(p.restart.checkpoint).lower()}
  set restart    = {str(p.restart.restart).lower()}
  set filename   = {p.restart.filename}
  set frequency  = {p.restart.frequency}
end
subsection timer
  set type = {p.timer.type}  # none|iteration|end
end
subsection manifolds
  set number = 0
end
subsection test
  set enable = {str(p.test.enable).lower()}
end
"""
    return lines
