"""The benchmark's harness: inputs, the plain reference, the generators of
the traffic mixes, the trace reduction and the work counts."""
