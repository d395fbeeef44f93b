"""Constants of the logical data model (ref: ``src/core/Const.java``)."""

# Maximum number of tags allowed per data point (ref: Const.java:28-36).
MAX_NUM_TAGS = 8

# Default UID widths in bytes for metric / tagk / tagv
# (ref: src/uid/UniqueId.java, src/core/TSDB.java:245-250).
METRICS_WIDTH = 3
TAG_NAME_WIDTH = 3
TAG_VALUE_WIDTH = 3
