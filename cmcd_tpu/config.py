"""Config system: the reference's `--config.*` flag surface.

Reference: src/configs/base.py. Same field names and defaults so reference
recipes port verbatim (`--config.model X --config.boundmode Y ...`), same
LR/eps hyperparameter lookup tables applied the same way
(src/utils.py:181-204). The reference parsed flags with absl +
ml_collections; ConfigDict and parse_flags below give the same surface with
the standard library only.
"""

from __future__ import annotations

import ast

# Per-model / per-boundmode learning rates (reference src/configs/base.py:5-63).
LR_DICT = {
    "log_sonar": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_CAIS_var_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "log_ionosphere": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-4,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "lorenz": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-5,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-3,
        "MCD_ULA_sn": 1e-5,
        "MCD_ULA": 1e-5,
    },
    "brownian": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-4,
        "MCD_ULA": 1e-5,
    },
    "seeds": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-3,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "banana": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-3,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "lgcp": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-4,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-4,
        "MCD_ULA": 1e-4,
    },
}

# Funnel eps/LR by nbridges (reference src/configs/base.py:65-72).
FUNNEL_EPS_DICT = {
    8: {"init_eps": 0.1, "lr": 0.01},
    16: {"init_eps": 0.1, "lr": 0.01},
    32: {"init_eps": 0.1, "lr": 0.005},
    64: {"init_eps": 0.1, "lr": 0.001},
    128: {"init_eps": 0.01, "lr": 0.01},
    256: {"init_eps": 0.01, "lr": 0.005},
}

TRACTABLE_DISTS = ["nice", "funnel", "gmm", "many_gmm", "banana"]


class ConfigDict:
    """Attribute-access configuration: `config.N`, `config.log.jsonl`.

    Fields are created by assignment (as in an unlocked ml_collections
    ConfigDict); parse_flags only sets fields that already exist, with the
    type of their default."""

    def __init__(self, fields: dict | None = None):
        object.__setattr__(self, "_fields", {})
        for k, v in (fields or {}).items():
            setattr(self, k, v)

    def __getattr__(self, name):
        try:
            return self.__dict__["_fields"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self._fields[name] = value

    def __contains__(self, name):
        return name in self._fields

    def items(self):
        return self._fields.items()

    def __str__(self):
        lines = []
        for k, v in sorted(self._fields.items()):
            if isinstance(v, ConfigDict):
                lines.append(f"{k}:")
                lines.extend("  " + line for line in str(v).splitlines())
            else:
                lines.append(f"{k}: {v!r}")
        return "\n".join(lines)


def get_config() -> ConfigDict:
    """Defaults matching reference src/configs/base.py:77-157."""
    config = ConfigDict()
    config.boundmode = "UHA"
    config.model = "lorenz"
    config.N = 5
    config.nbridges = 8
    config.lfsteps = 1

    config.emb_dim = 20
    # The reference's "geffner" arch hardcodes 2 residual blocks regardless
    # of nlayers (src/nn.py:45-53); same here via networks/geffner.py.
    config.nlayers = 2

    config.init_eta = 0.0
    config.init_eps = 1e-5
    config.init_sigma = 1.0
    config.init_gamma = 10.0
    config.pretrain_mfvi = True

    config.train_vi = True
    config.train_eps = True
    config.train_betas = True

    config.nn_arch = "geffner"  # "dds", "dds_grad"
    config.fully_connected_units = [64, 64]

    config.eps_schedule = ""
    config.grad_clipping = False
    # Per-step remat for KL/BPTT training at large nbridges (new capability).
    config.remat_steps = False

    config.mfvi_iters = 150000
    config.mfvi_lr = 0.01
    config.iters = 150000
    config.lr = 0.0001
    config.seed = 1
    config.n_samples = 500
    config.n_sinkhorn = 300
    config.n_input_dist_seeds = 30

    config.use_ema = False

    # New (not in reference): checkpointing + resume.
    config.checkpoint_dir = ""
    config.checkpoint_every = 0  # 0 = disabled
    # Optimizer steps fused into one jitted dispatch (0 = auto, up to 100;
    # amortizes per-dispatch host overhead — see train/trainer.py).
    config.steps_per_call = 0
    config.resume = False
    # Training-time sample plots + W2 (reference plots every 1% of iters,
    # src/opt.py:109-120); "" disables. Plots land as plot_dir/samples_N.png.
    config.plot_dir = ""
    # jax.profiler trace of a few training steps; "" disables.
    config.profile_dir = ""

    # NICE config
    config.im_size = 14
    config.alpha = 0.05
    config.n_bits = 3
    config.hidden_dim = 1000
    config.nice_checkpoint = ""

    # Funnel configs
    config.funnel_d = 10
    config.funnel_sig = 3
    config.funnel_clipy = 11

    # LGCP configs
    config.use_whitened = False
    config.file_path = ""  # default: bundled pines.csv

    # Many GMM configs
    config.gmm_easy_mode = False
    if config.gmm_easy_mode:
        config.n_mixes = 4
        config.loc_scaling = 10
    else:
        config.n_mixes = 40
        config.loc_scaling = 40

    # Logging
    config.log = ConfigDict()
    config.log.every = 0  # 0 = auto (0.1% of iters)
    config.log.jsonl = ""  # path for JSONL metrics; "" = stdout summary only

    return config


def apply_lookup_tables(config) -> dict:
    """LR/eps overrides (reference src/utils.py:181-204): funnel uses
    FUNNEL_EPS_DICT, gmm/many_gmm/nice bypass, others use LR_DICT."""
    try:
        if config.model == "nice":
            return {}
        if config.model == "funnel":
            values = FUNNEL_EPS_DICT[config.nbridges]
            return {"init_eps": values["init_eps"], "lr": values["lr"]}
        if config.model in ("many_gmm", "gmm", "banana"):
            return {}
        return {"lr": LR_DICT[config.model][config.boundmode]}
    except KeyError:
        print(
            "LR not found for model %s and boundmode %s"
            % (config.model, config.boundmode)
        )
        return {}


def _parse_value(text: str, default, flag: str):
    """Convert a flag's text to the type of the field's default."""
    try:
        if isinstance(default, bool):
            low = text.lower()
            if low in ("true", "1"):
                return True
            if low in ("false", "0"):
                return False
            raise ValueError(text)
        if isinstance(default, int):
            return int(text)
        if isinstance(default, float):
            return float(text)
        if isinstance(default, (list, tuple)):
            value = ast.literal_eval(text)
            if isinstance(value, (int, float)):
                value = [value]
            if not isinstance(value, (list, tuple)):
                raise ValueError(text)
            if default:
                value = [type(default[0])(v) for v in value]
            return type(default)(value)
        return text
    except (ValueError, SyntaxError) as e:
        raise ValueError(
            f"{flag}: cannot parse {text!r} as {type(default).__name__}"
        ) from e


def parse_flags(argv, config: ConfigDict | None = None) -> ConfigDict:
    """Apply reference-style flags to `config` (default: get_config()).

    Accepted forms: `--config.x=v`, `--config.x v`, `--config.log.jsonl=p`;
    booleans also as `--config.x` (True) and `--noconfig.x` (False). Lists
    take a Python literal (`--config.fully_connected_units="[128, 128]"`).
    An unknown field or a value of the wrong type raises ValueError."""
    config = get_config() if config is None else config
    args = list(argv)
    while args:
        arg = args.pop(0)
        negated = arg.startswith("--noconfig.")
        if not (negated or arg.startswith("--config.")):
            raise ValueError(f"unknown flag {arg!r} (expected --config.<field>)")
        name, has_eq, text = arg[len("--noconfig." if negated else "--config."):].partition("=")
        *parents, leaf = name.split(".")
        node = config
        for p in parents:
            node = getattr(node, p, None)
            if not isinstance(node, ConfigDict):
                raise ValueError(f"unknown config field {name!r}")
        if not isinstance(node, ConfigDict) or leaf not in node or isinstance(
            getattr(node, leaf), ConfigDict
        ):
            raise ValueError(f"unknown config field {name!r}")
        default = getattr(node, leaf)
        if negated or (isinstance(default, bool) and not has_eq):
            if not isinstance(default, bool) or has_eq:
                raise ValueError(f"{arg}: only a boolean field takes this form")
            value = not negated
        else:
            if not has_eq:
                if not args:
                    raise ValueError(f"{arg}: missing value")
                text = args.pop(0)
            value = _parse_value(text, default, f"--config.{name}")
        setattr(node, leaf, value)
    return config
