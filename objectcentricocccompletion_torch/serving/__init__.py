from .export import (ServingBundle, export_eval_step, load_bundle,
                     save_bundle)

__all__ = ["ServingBundle", "export_eval_step", "load_bundle",
           "save_bundle"]
