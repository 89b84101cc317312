"""Codecs shared with the parameter-server data plane (the per-row
int8 KV codec for now)."""
