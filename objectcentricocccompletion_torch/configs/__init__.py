from .ococcnet_config import (OcOccNetConfig, ctrl_cyc_config,  # noqa: F401
                              ctrl_ped_config, ctrl_veh_config, tiny_config)
