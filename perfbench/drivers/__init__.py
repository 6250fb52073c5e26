"""The general generators of the traffic mixes; a mix's file names its driver."""
