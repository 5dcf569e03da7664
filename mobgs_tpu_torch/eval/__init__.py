"""Test-pose alignment and test-time pose optimization (TTO)."""
