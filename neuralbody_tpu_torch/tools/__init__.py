"""Probe scripts of the port: measurements that are not part of a path."""
