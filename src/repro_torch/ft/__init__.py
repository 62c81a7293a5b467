from repro_torch.ft.straggler import (ElasticRestart, StepTimer,
                                      StragglerEvent, StragglerPolicy,
                                      Watchdog)

__all__ = ["ElasticRestart", "StepTimer", "StragglerEvent", "StragglerPolicy",
           "Watchdog"]
