from .elastic import (ElasticTrainer, Runner, FailureInjector, NodeFailure,
                      StragglerWatchdog, repartition_after_loss,
                      restore_device_pool, simulate_device_loss)
