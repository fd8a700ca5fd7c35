"""Scan input: SER and AVI readers, the raw device feed, and the product
writers (PNG, FITS)."""
