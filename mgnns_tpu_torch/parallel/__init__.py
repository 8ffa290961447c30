"""Multi-device training and serving on ``torch.distributed``: the process
group, the ``('data', 'model')`` mesh, input plans, the model axis's
sharding rules and the collectives of both axes (the counterpart of the JAX
package's ``mgnns_tpu/parallel``)."""
