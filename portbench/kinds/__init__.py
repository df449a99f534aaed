"""Traffic kinds: one module a kind, found by the ``kind`` of a traffic
file (portbench/traffic/<config>.<traffic>.json)."""
