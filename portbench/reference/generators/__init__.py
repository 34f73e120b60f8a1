"""Input generators, one module a generator, named by a configuration's
`generator` key.  Plain numpy; they import nothing of the program."""
