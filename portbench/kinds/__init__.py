"""One module per kind of traffic (`traffic/<mix>.json`'s `kind`), each with
`run(ctx) -> Outcome`: set-up, the measured window, the traced stretch and
the readings compared with the reference."""
