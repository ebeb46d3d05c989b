"""The benchmark's general code: manifest and cells (`core`), the traced
window (`trace`), inputs (`data`, `weights`), the yardstick's costs
(`costs`), the comparisons (`compare`) and one driver per traffic kind
(`train`, `serve`, `eval_split`)."""
