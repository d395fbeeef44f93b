"""The control plane (ref: ``opentsdb_tpu/control/``): a closed loop
that watches the surfaces the TSD already exports (the query-shape log,
SLO burn) and steers adaptive materialization and tenant QoS; its
placement actuator assesses a cluster router's shards
(:mod:`opentsdb_tpu_torch.control.placement`) and applies its plan as a
reshard. See :mod:`opentsdb_tpu_torch.control.plane`.
"""
