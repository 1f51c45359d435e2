"""The port's configuration: the JAX package's typed config, re-exported.

`u2pl_tpu.config` is plain Python (stdlib + yaml) and imports no JAX, so the
port reads the same YAML surface (`experiments/**/config.yaml`) through it.
Port code imports the config from here, the one place the port depends on
it.
"""

from u2pl_tpu.config import Config, NetCfg, load_config, parse_config

__all__ = ["Config", "NetCfg", "load_config", "parse_config"]
