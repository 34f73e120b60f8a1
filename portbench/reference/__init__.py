"""The yardstick: input generators, the plain KKT check that decides
`correct`, and the roofline arithmetic.  Plain numpy; imports nothing of
the program."""
