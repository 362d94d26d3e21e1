"""The benchmark's plain reference: a frozen copy of the port's plain path
(`hgt_ref`) and the computations that judge a run (`follow`)."""
