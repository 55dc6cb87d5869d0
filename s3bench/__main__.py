from s3bench.run import main

main()
