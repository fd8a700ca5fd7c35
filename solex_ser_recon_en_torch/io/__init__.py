"""Scan input: the raw SER device feed and the PNG writer."""
