"""The query mesh (port of ``opentsdb_tpu/parallel/``): a ('series',
'time') grid of devices, the collectives along its axes, the sharded
query pipeline and the multi-process layout."""
