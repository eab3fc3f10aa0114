"""Sharding: the placement rules (`sharding`) and the sharded runtime over a
process group (`spmd`)."""
