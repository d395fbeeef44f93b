"""The control plane (ref: ``opentsdb_tpu/control/``): a closed loop
that watches the surfaces the TSD already exports (the query-shape log,
SLO burn) and steers adaptive materialization and tenant QoS; its
placement actuator acts only on a cluster router, which the port does
not have yet. See :mod:`opentsdb_tpu_torch.control.plane`."""
