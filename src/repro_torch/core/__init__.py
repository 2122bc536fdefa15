"""The data-flow system: records, UDF analysis, optimizer and executors
(port of `repro.core`)."""
