from spmm_denseblock_tpu_torch.bench.sweeps import main

if __name__ == "__main__":
    raise SystemExit(main())
