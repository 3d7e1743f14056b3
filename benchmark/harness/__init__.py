"""The benchmark's harness: a cell's files found by name (`spec`), the
inputs and weights made from the seed (`inputs`, `weights`), the program
driven by each traffic kind (`train`, `infer`), the traced window
(`trace`, `readers`) and the comparison that decides `correct`
(`check`)."""
